"""Continuous-batching scheduler (the core of the JAX package's scheduler).

Many sequences multiplexed onto one model replica:

- Admission: pending sequences are admitted when a slot AND enough KV pages
  for prompt + max_new_tokens are available (no mid-flight OOM).
- Batched chunked prefill interleaved with decode: each loop iteration runs
  ONE prefill round — every prefilling sequence advances one chunk in a
  single [N, chunk] ``prefill_step`` (N padded to a power of two) — then
  one decode step for all active slots.
- Pipelined decode: decode step N+1 is enqueued on the device BEFORE step
  N's tokens are fetched, and every device->host fetch runs in a worker
  thread, so the asyncio loop never blocks on the card. A sequence that
  hits EOS at step N wastes one speculative token at N+1; the host
  discards it.
- Unified packed ragged step (``engine.mixed_step``, default on): when
  prefill work and in-flight decodes coexist, the iteration runs ONE
  ``ragged_mixed_step`` dispatch over a packed token buffer — every
  prefilling row advances a chunk and every decoding row a token — instead
  of a prefill round plus a decode step. ``finchat_coexist_iterations_total``
  counts those iterations and ``finchat_coexist_dispatches_total`` the model
  dispatches booked to them.
- Per-sequence failure isolation: an errored sequence is evicted, its pages
  freed, an error event emitted on its stream; a whole-round failure evicts
  that round's population, and the engine keeps serving the others.

The serving planes this port does not carry yet — prefix and session KV
caches, speculative decode, the fused decode loop, the free-running loop,
bounded KV, recompute preemption and the circuit breaker — are refused at
construction (``check_supported``) instead of being silently ignored. The
quantized plane (int8/int4 weights, int8 KV pages) is served: the
scheduler keeps the engine's quant label and sets the
``finchat_quant_weight_bits`` / ``finchat_quant_kv_bits`` gauges.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from finchat_tpu_torch.engine.engine import InferenceEngine, round_up_pow2
from finchat_tpu_torch.engine.kv_cache import PageAllocator, pages_needed
from finchat_tpu_torch.engine.sampler import CANDIDATES, SamplingParams
from finchat_tpu_torch.utils.config import EngineConfig
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS, Timer

logger = get_logger(__name__)


def check_supported(cfg: EngineConfig) -> None:
    """Raise on a config that turns on a serving plane this port does not
    carry yet (each is a later slice)."""
    unsupported = {
        "prefix_cache": cfg.prefix_cache,
        "session_cache": cfg.session_cache,
        "spec_tokens > 0": cfg.spec_tokens > 0,
        "decode_loop_depth > 1": cfg.decode_loop_depth > 1,
        "freerun_rounds > 1": cfg.freerun_rounds > 1,
        "bounded KV (kv_sink_pages / kv_window_pages)":
            cfg.kv_sink_pages > 0 or cfg.kv_window_pages > 0,
        "preemption": cfg.preemption,
        "breaker_threshold > 0": cfg.breaker_threshold > 0,
    }
    on = [name for name, flag in unsupported.items() if flag]
    if on:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(on) + " (turn these off in EngineConfig)"
        )


@dataclass
class SequenceHandle:
    """Host-side record of one in-flight sequence; ``events`` receives
    ``{"type": "token", "token_id": int}``, then one terminal
    ``{"type": "done", "reason": ...}`` or ``{"type": "error", ...}``."""

    seq_id: str
    prompt_ids: list[int]
    sampling: SamplingParams
    events: asyncio.Queue = field(default_factory=asyncio.Queue)
    slot: int = -1
    prefill_pos: int = 0  # prompt tokens already prefilled
    generated: int = 0
    history: list[int] = field(default_factory=list)  # prompt + delivered tokens
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: float | None = None
    last_token_at: float | None = None
    finished: bool = False

    def __post_init__(self) -> None:
        if not self.history:
            self.history = list(self.prompt_ids)

    def _emit_first_token_metrics(self) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()
            METRICS.observe("finchat_ttft_seconds", self.first_token_at - self.submitted_at)


@dataclass
class _InFlightStep:
    """A dispatched-but-unconsumed decode step: device tokens plus the
    membership snapshot it was dispatched against."""

    tokens: object  # [max_seqs] int32, device
    members: list[tuple[int, SequenceHandle]]


class ContinuousBatchingScheduler:
    def __init__(self, engine: InferenceEngine, eos_id: int):
        cfg = engine.engine_cfg
        check_supported(cfg)
        self.engine = engine
        self.eos_id = eos_id
        self.metrics = METRICS
        self.allocator = PageAllocator(cfg.num_pages)
        self.free_slots: list[int] = list(range(cfg.max_seqs))
        self.pending: deque[SequenceHandle] = deque()
        self.prefilling: deque[SequenceHandle] = deque()
        self.decoding: dict[int, SequenceHandle] = {}  # slot -> handle
        B = cfg.max_seqs
        self._temperature = np.zeros((B,), np.float32)
        self._top_p = np.ones((B,), np.float32)
        self._top_k = np.zeros((B,), np.int32)
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._running = False
        self.mixed_enabled = bool(cfg.mixed_step)
        self.max_queue_depth = max(0, cfg.max_queue_depth)
        # whether the current loop iteration ran prefill work (the
        # finchat_inter_token_seconds label)
        self._iter_ran_prefill = False
        # every model dispatch bumps _dispatch_tally; the span from one
        # coexist iteration's start to the next accounting point lands in
        # finchat_coexist_dispatches_total
        self._dispatch_tally = 0
        self._coexist_mark: int | None = None
        self._top_k_clamp_warned: set[int] = set()
        # the quantized serving plane: the engine's mode as one label, and
        # bits per weight / per KV element as gauges (the model dtype's
        # width when that side is not quantized)
        self.quant_label = engine.quant_label
        elem_bits = 8 * engine.config.dtype.itemsize
        self.metrics.set_gauge("finchat_quant_weight_bits",
                               {"int8": 8, "int4": 4}.get(engine.quant, elem_bits))
        self.metrics.set_gauge("finchat_quant_kv_bits", 8 if engine.kv_quant else elem_bits)

    # --- public API -----------------------------------------------------
    async def start(self) -> None:
        self._wakeup = asyncio.Event()  # rebind to the current loop
        self._running = True
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        self._running = False
        self._wakeup.set()
        if self._task:
            await self._task

    async def submit(self, seq_id: str, prompt_ids: list[int],
                     sampling: SamplingParams) -> SequenceHandle:
        if not prompt_ids:
            raise ValueError("empty prompt")
        if sampling.grammar:
            raise NotImplementedError("grammar-constrained decoding is not ported yet")
        if self.max_queue_depth > 0 and len(self.pending) >= self.max_queue_depth:
            self.metrics.inc("finchat_overload_rejections_total")
            raise RuntimeError(
                f"admission queue full ({len(self.pending)} >= {self.max_queue_depth})"
            )
        max_len = self.engine.max_pages_per_seq * self.engine.page_size
        if len(prompt_ids) + sampling.max_new_tokens > max_len:
            raise ValueError(
                f"sequence {seq_id}: prompt {len(prompt_ids)} + max_new "
                f"{sampling.max_new_tokens} exceeds max length {max_len}"
            )
        if sampling.top_k > CANDIDATES:
            if sampling.top_k not in self._top_k_clamp_warned:
                self._top_k_clamp_warned.add(sampling.top_k)
                logger.warning("sequence %s: top_k=%d exceeds the sampler candidate cap "
                               "%d; clamping", seq_id, sampling.top_k, CANDIDATES)
            self.metrics.inc("finchat_top_k_clamped_total")
            sampling = dataclasses.replace(sampling, top_k=CANDIDATES)
        handle = SequenceHandle(seq_id=seq_id, prompt_ids=list(prompt_ids), sampling=sampling)
        self.pending.append(handle)
        self.metrics.set_gauge("finchat_queue_depth", len(self.pending))
        self._wakeup.set()
        return handle

    def cancel(self, handle: SequenceHandle) -> None:
        """Client went away: evict and free."""
        if handle.finished:
            return
        if handle in self.pending:
            self.pending.remove(handle)
            self._finish(handle, "cancelled")
            return
        self._evict(handle, "cancelled")

    # --- internals ------------------------------------------------------
    def _admit(self) -> None:
        admitted: dict[int, list[int]] = {}
        while self.pending and self.free_slots:
            handle = self.pending[0]
            # pages for the whole prompt + budget: no mid-flight allocation
            need = pages_needed(len(handle.prompt_ids) + handle.sampling.max_new_tokens,
                                self.engine.page_size)
            if need > self.engine.max_pages_per_seq or not self.allocator.can_allocate(need):
                break  # head-of-line waits for pages
            self.pending.popleft()
            slot = self.free_slots.pop()
            pages = self.allocator.allocate(handle.seq_id, need)
            admitted[slot] = pages
            handle.slot = slot
            self._temperature[slot] = handle.sampling.temperature
            self._top_p[slot] = handle.sampling.top_p
            self._top_k[slot] = handle.sampling.top_k
            self.prefilling.append(handle)
            logger.debug("admitted %s into slot %d (%d pages)", handle.seq_id, slot, need)
        if admitted:
            # ONE device update for the whole admission burst
            self.engine.set_page_table_rows(admitted)
            self.metrics.set_gauge("finchat_queue_depth", len(self.pending))

    def _finish(self, handle: SequenceHandle, reason: str) -> None:
        handle.finished = True
        handle.events.put_nowait({"type": "done", "reason": reason})

    def _release(self, handle: SequenceHandle) -> None:
        if handle.slot < 0:
            return
        pages = self.allocator.owned_by(handle.seq_id)
        if pages:
            self.allocator.free(handle.seq_id, pages)
        try:
            self.engine.reset_slot(handle.slot)
        except Exception as e:
            # admission rewrites the page-table row and context length
            # anyway; the slot must still return to the free list
            logger.error("slot reset failed releasing %s: %s", handle.seq_id, e)
        self.decoding.pop(handle.slot, None)
        if handle in self.prefilling:
            self.prefilling.remove(handle)
        # non-truncating defaults keep the sampler on its exact fast path
        self._temperature[handle.slot] = 0.0
        self._top_p[handle.slot] = 1.0
        self._top_k[handle.slot] = 0
        self.free_slots.append(handle.slot)
        handle.slot = -1

    def _evict(self, handle: SequenceHandle, reason: str, error: str | None = None) -> None:
        self._release(handle)
        if error is not None:
            handle.finished = True
            handle.events.put_nowait({"type": "error", "message": error})
        else:
            self._finish(handle, reason)

    def _tally_dispatch(self) -> None:
        self._dispatch_tally += 1

    async def _prefill_round(self) -> None:
        """Advance every prefilling sequence one chunk in a single batched
        ``prefill_step``, the batch padded to a power of two; completed
        prompts sample their first token (``commit_first_token``)."""
        eng = self.engine
        C = eng.engine_cfg.prefill_chunk
        batch = list(self.prefilling)
        if not batch:
            return
        rows = [(h.slot, h.prompt_ids, h.prefill_pos) for h in batch]
        N = round_up_pow2(len(rows))
        tokens, slots, starts, n_valids = self._pack_prefill_rows(rows, N, C)
        with Timer(self.metrics, "finchat_prefill_seconds"):
            logits = eng.prefill_chunk(tokens, slots, starts, n_valids)
        self._tally_dispatch()
        completions: list[tuple[SequenceHandle, object]] = []
        for i, handle in enumerate(batch):
            handle.prefill_pos += int(n_valids[i])
            if handle.prefill_pos >= len(handle.prompt_ids):
                completions.append((handle, logits[i]))
        if not completions:
            return  # dispatch-only round, no host sync needed
        tokens_dev = []
        for h, row_logits in completions:
            s = h.sampling
            tokens_dev.append(eng.commit_first_token(h.slot, row_logits, s.temperature,
                                                     s.top_p, s.top_k))
        # one host fetch for all completions (worker thread keeps the loop live)
        fetched = await asyncio.to_thread(
            lambda: [int(eng.to_host(t)) for t in tokens_dev])
        for (handle, _lg), token_id in zip(completions, fetched):
            if handle.finished:
                continue  # cancelled while fetching
            self.prefilling.remove(handle)
            self.decoding[handle.slot] = handle
            self._deliver(handle, token_id)

    @staticmethod
    def _pack_prefill_rows(rows, N: int, C: int):
        """Row arrays for a chunked prefill round: one chunk per
        ``(slot, ids, pos)`` row; padding rows carry the first row's slot
        with ``n_valid 0`` (trash writes)."""
        tokens = np.zeros((N, C), np.int32)
        slots = np.zeros((N,), np.int32)
        starts = np.zeros((N,), np.int32)
        n_valids = np.zeros((N,), np.int32)
        slots[:] = rows[0][0]
        for i, (slot, ids, pos) in enumerate(rows):
            chunk = ids[pos : pos + C]
            tokens[i, : len(chunk)] = chunk
            slots[i] = slot
            starts[i] = pos
            n_valids[i] = len(chunk)
        return tokens, slots, starts, n_valids

    def _fail_prefill_round(self, error: str) -> None:
        for handle in list(self.prefilling):
            self._evict(handle, "error", error=error)

    def _use_mixed(self) -> bool:
        """One packed ragged dispatch instead of a prefill round plus a
        decode step: both populations must exist."""
        return self.mixed_enabled and bool(self.decoding) and bool(self.prefilling)

    async def _ragged_round(self) -> None:
        """Advance every prefilling sequence a chunk and every decoding slot
        a token in ONE packed ragged dispatch, with one host fetch. Prefill
        rows whose prompt completes sample their first token on the device
        in the same dispatch."""
        eng = self.engine
        C = eng.engine_cfg.prefill_chunk
        R = B = eng.engine_cfg.max_seqs
        batch = list(self.prefilling)
        decode_members = list(self.decoding.items())
        row_slot = np.zeros((R,), np.int32)
        row_start = np.zeros((R,), np.int32)
        row_len = np.zeros((R,), np.int32)
        row_from_device = np.zeros((R,), bool)
        row_arm = np.zeros((R,), bool)
        temp = np.zeros((R,), np.float32)
        top_p = np.ones((R,), np.float32)
        top_k = np.zeros((R,), np.int32)
        packed: list[int] = []
        tok_row: list[int] = []
        completions: list[tuple[int, SequenceHandle]] = []
        prefill_rows: list[tuple[int, SequenceHandle]] = []
        decode_rows: list[tuple[int, int, SequenceHandle]] = []
        i = 0
        for h in batch:
            chunk = h.prompt_ids[h.prefill_pos : h.prefill_pos + C]
            row_slot[i] = h.slot
            row_start[i] = h.prefill_pos
            row_len[i] = len(chunk)
            packed += chunk
            tok_row += [i] * len(chunk)
            if h.prefill_pos + len(chunk) >= len(h.prompt_ids):
                # prompt completes this chunk: arm the row so its first
                # token samples on the device with the sequence's params
                row_arm[i] = True
                completions.append((i, h))
                s = h.sampling
                temp[i], top_p[i], top_k[i] = s.temperature, s.top_p, s.top_k
            prefill_rows.append((i, h))
            i += 1
        for slot, h in decode_members:
            row_slot[i] = slot
            row_from_device[i] = True
            row_arm[i] = True
            row_len[i] = 1
            packed.append(0)
            tok_row.append(i)
            s = h.sampling
            temp[i], top_p[i], top_k[i] = s.temperature, s.top_p, s.top_k
            decode_rows.append((i, slot, h))
            i += 1
        assert i <= B
        T = eng.ragged_bucket(len(packed))
        packed += [0] * (T - len(packed))
        tok_row += [R] * (T - len(tok_row))
        with Timer(self.metrics, "finchat_mixed_step_seconds"):
            emitted_dev, _n_em, _row_logits = eng.ragged_mixed(
                np.asarray(packed, np.int32), np.asarray(tok_row, np.int32),
                row_slot, row_start, row_len, row_from_device, row_arm,
                temp, top_p, top_k,
            )
        self._tally_dispatch()
        for idx, h in prefill_rows:
            h.prefill_pos += int(row_len[idx])
        emitted = await asyncio.to_thread(eng.to_host, emitted_dev)
        for idx, handle in completions:
            if handle.finished:
                continue
            self.prefilling.remove(handle)
            self.decoding[handle.slot] = handle
            self._deliver(handle, int(emitted[idx, 0]))
        for idx, slot, handle in decode_rows:
            if handle.finished or handle.slot != slot:
                continue
            self._deliver(handle, int(emitted[idx, 0]))
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

    def _deliver(self, handle: SequenceHandle, token_id: int) -> None:
        now = time.perf_counter()
        if handle.last_token_at is not None:
            self.metrics.observe(
                "finchat_inter_token_seconds", now - handle.last_token_at,
                labels={"prefill_concurrent": "yes" if self._iter_ran_prefill else "no"},
            )
        handle.last_token_at = now
        handle._emit_first_token_metrics()
        handle.generated += 1
        handle.history.append(token_id)
        self.metrics.inc("finchat_tokens_generated_total")
        if token_id == self.eos_id:
            self._evict(handle, "eos")
        elif handle.generated >= handle.sampling.max_new_tokens:
            handle.events.put_nowait({"type": "token", "token_id": token_id})
            self._evict(handle, "length")
        else:
            handle.events.put_nowait({"type": "token", "token_id": token_id})

    def _dispatch_decode(self) -> _InFlightStep:
        """Enqueue one decode step on the device; returns without syncing."""
        eng = self.engine
        B = eng.engine_cfg.max_seqs
        active = np.zeros((B,), bool)
        members = []
        for slot, handle in self.decoding.items():
            active[slot] = True
            members.append((slot, handle))
        next_tokens = eng.decode(active, self._temperature, self._top_p, self._top_k)
        self._tally_dispatch()
        return _InFlightStep(tokens=next_tokens, members=members)

    async def _consume_step(self, step: _InFlightStep) -> None:
        """Fetch a dispatched step's tokens (in a worker thread) and deliver
        them to the sequences that were in the batch when it was dispatched."""
        tokens_host = await asyncio.to_thread(self.engine.to_host, step.tokens)
        for slot, handle in step.members:
            if handle.finished or handle.slot != slot:
                continue  # evicted/cancelled since dispatch
            self._deliver(handle, int(tokens_host[slot]))
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

    async def _round_failed(self, scope: str, error: str) -> None:
        """A whole-round dispatch failure is not attributable to one
        sequence: the round's population is evicted with an error."""
        self.metrics.inc("finchat_dispatch_failures_total")
        if scope in ("prefill", "mixed"):
            self._fail_prefill_round(error)
        if scope in ("decode", "mixed"):
            for handle in list(self.decoding.values()):
                self._evict(handle, "error", error=error)

    async def _drain_inflight(self, inflight: _InFlightStep) -> None:
        """Consume an in-flight step outside the decode try-block, turning a
        failure into the whole-round path. Returns None (the new inflight)."""
        try:
            await self._consume_step(inflight)
        except Exception as e:
            logger.error("in-flight step consume error: %s", e)
            await self._round_failed("decode", str(e))
        return None

    async def _loop(self) -> None:
        logger.info("scheduler loop started (max_seqs=%d, quant=%s)",
                    self.engine.engine_cfg.max_seqs, self.quant_label)
        inflight: _InFlightStep | None = None
        while self._running:
            if self._coexist_mark is not None:
                self.metrics.inc("finchat_coexist_dispatches_total",
                                 self._dispatch_tally - self._coexist_mark)
                self._coexist_mark = None
            if not (self.pending or self.decoding or self.prefilling):
                if inflight is not None:  # drain the pipeline before idling
                    self._iter_ran_prefill = False
                    inflight = await self._drain_inflight(inflight)
                    continue
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
                continue

            try:
                self._admit()
            except Exception as e:
                logger.error("admission error: %s", e)
                await asyncio.sleep(0.05)

            prefill_active = bool(self.prefilling)
            self._iter_ran_prefill = prefill_active
            if prefill_active and self.decoding:
                self.metrics.inc("finchat_coexist_iterations_total")
                self._coexist_mark = self._dispatch_tally

            if self._use_mixed():
                # the mixed path is depth-1 (dispatch + consume within the
                # iteration): drain any pipelined decode step first
                if inflight is not None:
                    inflight = await self._drain_inflight(inflight)
                if self._use_mixed():  # consuming may have evicted slots
                    try:
                        await self._ragged_round()
                    except Exception as e:
                        logger.error("mixed step error: %s", e)
                        await self._round_failed("mixed", str(e))
                    await asyncio.sleep(0)
                    continue

            if self.prefilling:
                try:
                    await self._prefill_round()
                except Exception as e:
                    logger.error("prefill round error: %s", e)
                    await self._round_failed("prefill", str(e))

            if self.decoding:
                try:
                    # depth-2 pipeline: dispatch N+1, then consume N — the
                    # device computes while the host delivers tokens
                    step = self._dispatch_decode()
                    if inflight is not None:
                        await self._consume_step(inflight)
                    inflight = step
                except Exception as e:
                    logger.error("decode step error: %s", e)
                    inflight = None
                    await self._round_failed("decode", str(e))
            elif inflight is not None:
                inflight = await self._drain_inflight(inflight)

            await asyncio.sleep(0)  # let producers/consumers run
        if inflight is not None:
            await self._drain_inflight(inflight)
        logger.info("scheduler loop stopped")
