"""Cross-request embedding microbatcher (own copy of the JAX package's
``embed/batcher.py``).

Every chat message that retrieves pays one query embed, and every ingest
one embed per row batch; run one by one, concurrent traffic would pay one
device dispatch each where one would do. ``EmbedMicrobatcher`` sits in
front of :class:`EmbeddingEncoder` as an async coalescing queue:

- a request enqueues its texts and awaits a future;
- the flusher wakes on the first pending item, then waits up to
  ``window_ms`` for more arrivals (or until ``max_batch`` texts are
  pending) and dispatches one bucket-padded ``embed_batch`` for the whole
  bucket on the batcher's own dispatch thread;
- results scatter back to the per-request futures.

The dispatch thread is the batcher's, not the loop's default executor: the
ingest path blocks default-executor threads in ``embed_threadsafe`` while
it waits for a dispatch, so enough concurrent ingests would otherwise
hold every thread the dispatch needs (the JAX package's copy dispatches
through ``asyncio.to_thread`` and waits out ``embed_threadsafe``'s timeout
there).

Error isolation: a failed coalesced dispatch retries each request on its
own, so one request's un-encodable text fails only its own future, never
its neighbours'. Backpressure: at ``max_pending`` queued texts, submitters
wait for the queue to drain before enqueueing. The fault site
``embed.dispatch`` fires before each coalesced dispatch.

Metrics: ``finchat_embed_batch_occupancy`` (gauge: texts in the last
dispatched bucket), ``finchat_embed_queue_depth`` (gauge),
``finchat_embed_batch_dispatches_total`` / ``finchat_embed_requests_total``
/ ``finchat_embed_texts_total`` (counters: dispatches per request is the
coalescing figure of merit), ``finchat_embed_batch_retries_total`` and
``finchat_embed_failures_total``, and ``finchat_embed_wait_seconds``
(histogram: the time a request spends queued before its dispatch starts).
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from finchat_tpu_torch.embed.encoder import EmbeddingEncoder
from finchat_tpu_torch.utils.faults import inject
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS

logger = get_logger(__name__)


@dataclass
class _Pending:
    """One enqueued request: its texts and the future its rows resolve."""

    texts: list[str]
    future: asyncio.Future
    enqueued_at: float = field(default_factory=time.perf_counter)


class EmbedMicrobatcher:
    """Async coalescing queue in front of an EmbeddingEncoder.

    Lazily binds to the running event loop on first use (``embed`` /
    ``bind_loop``); ``embed_threadsafe`` lets worker threads (the ingest
    path runs under ``asyncio.to_thread``) ride the same coalescing
    window as event-loop queries.
    """

    def __init__(
        self,
        encoder: EmbeddingEncoder,
        *,
        window_ms: float = 3.0,
        max_batch: int = 32,
        max_pending: int | None = None,
    ):
        self.encoder = encoder
        self.window_s = max(0.0, window_ms) / 1000.0
        self.max_batch = max(1, max_batch)
        # backpressure bound: pending TEXTS (not requests) beyond which
        # submitters wait — 8 full buckets of headroom by default
        self.max_pending = max_pending if max_pending is not None else self.max_batch * 8
        self._queue: list[_Pending] = []
        self._pending_texts = 0
        self._loop: asyncio.AbstractEventLoop | None = None
        self._flusher: asyncio.Task | None = None
        self._arrival: asyncio.Event | None = None
        self._drained: asyncio.Event | None = None
        self._closed = False
        # the dispatch thread (made at bind, shut down at close)
        self._executor: ThreadPoolExecutor | None = None

    @property
    def dim(self) -> int:
        return self.encoder.dim

    # --- lifecycle ------------------------------------------------------
    def bind_loop(self, loop: asyncio.AbstractEventLoop | None = None) -> None:
        """Attach the flusher to ``loop`` (default: the running loop).
        Called at app startup; ``embed`` also self-binds on first use
        from a coroutine. A binding left over from a previous, now-dead
        loop (stop/start across asyncio.run — the scheduler supports the
        same restart shape) is replaced, so a restarted app embeds again
        instead of failing every retrieval."""
        target = loop or asyncio.get_running_loop()
        if self._loop is target and self._flusher is not None and not self._flusher.done():
            return
        if self._loop is not None and self._loop is not target and self._loop.is_running():
            raise RuntimeError("EmbedMicrobatcher is already bound to a live loop")
        self._loop = target
        self._arrival = asyncio.Event()
        self._drained = asyncio.Event()
        self._drained.set()
        self._closed = False
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="embed-dispatch")
        self._flusher = self._loop.create_task(self._run())

    async def close(self) -> None:
        """Flush what's queued, then stop the flusher."""
        self._closed = True
        if self._flusher is not None:
            if self._arrival is not None:
                self._arrival.set()
            try:
                await self._flusher
            except asyncio.CancelledError:
                pass
            self._flusher = None
        if self._executor is not None:
            self._executor.shutdown(wait=False)  # the flusher is done: nothing queued
            self._executor = None
        if self._drained is not None:
            self._drained.set()  # wake backpressured submitters to fail fast

    # --- submission -----------------------------------------------------
    async def embed(self, texts: list[str]) -> np.ndarray:
        """Embed ``texts`` → [n, dim] fp32, coalesced with concurrent
        callers into shared ``encode_batch`` dispatches."""
        if not texts:
            return np.empty((0, self.encoder.dim), np.float32)
        if self._closed:
            raise RuntimeError("EmbedMicrobatcher is closed")
        # binds on first use; replaces a stale binding after a loop
        # restart; raises if another loop holds a LIVE binding (threads
        # must use embed_threadsafe)
        self.bind_loop()
        while self._pending_texts >= self.max_pending:  # backpressure
            self._drained.clear()
            await self._drained.wait()
            if self._closed:
                # close() drained the queue while this submitter was gated;
                # enqueueing now would strand a future no flusher will see
                raise RuntimeError("EmbedMicrobatcher closed while waiting")
        item = _Pending(list(texts), self._loop.create_future())
        self._queue.append(item)
        self._pending_texts += len(item.texts)
        METRICS.inc("finchat_embed_requests_total")
        METRICS.inc("finchat_embed_texts_total", len(item.texts))
        METRICS.set_gauge("finchat_embed_queue_depth", self._pending_texts)
        self._arrival.set()
        return await item.future

    async def embed_one(self, text: str) -> np.ndarray:
        return (await self.embed([text]))[0]

    def embed_threadsafe(self, texts: list[str], timeout: float | None = 120.0) -> np.ndarray:
        """Blocking submit from a worker thread (the ingest path), riding
        the same coalescing window as event-loop queries. Falls back to a
        direct encoder call when no loop is bound (tests, offline tools)
        or when called ON the loop's own thread (where blocking would
        deadlock the flusher)."""
        loop = self._loop
        if loop is None or self._closed or not loop.is_running():
            return self.encoder.embed_batch(texts)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            return self.encoder.embed_batch(texts)
        fut = asyncio.run_coroutine_threadsafe(self.embed(texts), loop)
        return fut.result(timeout=timeout)

    # --- flusher --------------------------------------------------------
    async def _run(self) -> None:
        while True:
            if not self._queue:
                if self._closed:
                    return
                self._arrival.clear()
                try:
                    await asyncio.wait_for(self._arrival.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
                continue  # re-check queue/closed at the top either way
            # wait-window: give concurrent callers up to window_s to land
            # in this bucket, unless a full bucket is already pending
            if self.window_s > 0 and not self._closed:
                deadline = self._queue[0].enqueued_at + self.window_s
                while self._pending_texts < self.max_batch:
                    now = time.perf_counter()
                    if now >= deadline:
                        break
                    self._arrival.clear()
                    try:
                        await asyncio.wait_for(
                            self._arrival.wait(), timeout=deadline - now
                        )
                    except asyncio.TimeoutError:
                        break
            # drain whole requests up to max_batch texts (never split one
            # request across buckets: scatter stays trivial and a request
            # is atomic for error isolation); always take at least one
            bucket: list[_Pending] = []
            n = 0
            while self._queue and (not bucket or n + len(self._queue[0].texts) <= self.max_batch):
                item = self._queue.pop(0)
                bucket.append(item)
                n += len(item.texts)
            self._pending_texts -= n
            METRICS.set_gauge("finchat_embed_queue_depth", self._pending_texts)
            if self._pending_texts < self.max_pending:
                self._drained.set()
            if bucket:
                await self._dispatch(bucket, n)

    async def _dispatch(self, bucket: list[_Pending], n: int) -> None:
        texts = [t for item in bucket for t in item.texts]
        now = time.perf_counter()
        for item in bucket:
            METRICS.observe("finchat_embed_wait_seconds", now - item.enqueued_at)
        METRICS.inc("finchat_embed_batch_dispatches_total")
        METRICS.set_gauge("finchat_embed_batch_occupancy", n)
        try:
            # armable fault site: a raised injection is exactly a failed
            # coalesced dispatch, driving the per-request retry below
            inject("embed.dispatch", n_texts=n)
            out = await self._in_dispatch_thread(texts)
        except Exception as batch_err:
            if len(bucket) == 1:
                self._fail(bucket[0], batch_err)
                return
            # error isolation: one request's bad text must not fail its
            # neighbors — retry each request as its own dispatch
            logger.warning(
                "coalesced embed batch of %d requests failed (%s); "
                "retrying per-request", len(bucket), batch_err,
            )
            METRICS.inc("finchat_embed_batch_retries_total")
            for item in bucket:
                try:
                    rows = await self._in_dispatch_thread(item.texts)
                except Exception as item_err:
                    self._fail(item, item_err)
                else:
                    self._resolve(item, rows)
            return
        lo = 0
        for item in bucket:
            self._resolve(item, out[lo : lo + len(item.texts)])
            lo += len(item.texts)

    async def _in_dispatch_thread(self, texts: list[str]) -> np.ndarray:
        return await self._loop.run_in_executor(self._executor, self.encoder.embed_batch, texts)

    @staticmethod
    def _resolve(item: _Pending, rows: np.ndarray) -> None:
        if not item.future.done():
            item.future.set_result(rows)

    @staticmethod
    def _fail(item: _Pending, err: Exception) -> None:
        METRICS.inc("finchat_embed_failures_total")
        if not item.future.done():
            item.future.set_exception(
                err if isinstance(err, Exception) else RuntimeError(str(err))
            )


__all__ = ["EmbedMicrobatcher"]
