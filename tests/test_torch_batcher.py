"""The port's embedding microbatcher (``embed/batcher.py``), the cases of
tests/test_retrieval_plane.py and tests/test_faults.py on the port, over
the port's ``bge-tiny`` encoder on the CPU: the wait window, ``max_batch``,
per-request error isolation, the threadsafe ingest path and its direct-call
cases, backpressure, the rebinding after a loop restart, ``close``, and the
``embed.dispatch`` fault site. The counters are the port's own registry's
(compared by delta)."""

import asyncio
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finchat_tpu_torch.embed.batcher import EmbedMicrobatcher  # noqa: E402
from finchat_tpu_torch.embed.encoder import (  # noqa: E402
    EMBED_PRESETS,
    EmbeddingEncoder,
    init_bert_params,
)
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils import faults  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

DISPATCHES = "finchat_embed_batch_dispatches_total"


@pytest.fixture(scope="module")
def encoder():
    cfg = EMBED_PRESETS["bge-tiny"]
    params = init_bert_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return EmbeddingEncoder(cfg, params, ByteTokenizer(), device="cpu")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm_all()


class CountingEncoder:
    """The encoder, with its calls recorded (the texts of each)."""

    def __init__(self, inner, bad: str | None = None):
        self.inner, self.bad, self.calls = inner, bad, []
        self.dim = inner.dim

    def embed_batch(self, texts):
        self.calls.append(list(texts))
        if self.bad is not None and self.bad in texts:
            raise ValueError("bad text")
        return self.inner.embed_batch(texts)


async def test_window_coalesces_into_one_dispatch(encoder):
    b = EmbedMicrobatcher(encoder, window_ms=30, max_batch=16)
    d0, r0 = METRICS.get(DISPATCHES), METRICS.get("finchat_embed_requests_total")
    outs = await asyncio.gather(*[b.embed_one(f"text {i}") for i in range(5)])
    assert METRICS.get(DISPATCHES) - d0 == 1
    assert METRICS.get("finchat_embed_requests_total") - r0 == 5
    assert METRICS.get("finchat_embed_batch_occupancy") == 5
    direct = encoder.embed_batch([f"text {i}" for i in range(5)])
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, direct[i])
    await b.close()


async def test_max_batch_dispatches_without_waiting_the_window(encoder):
    counting = CountingEncoder(encoder)
    b = EmbedMicrobatcher(counting, window_ms=10_000, max_batch=4)
    t0 = time.perf_counter()
    await asyncio.gather(*[b.embed_one(f"t{i}") for i in range(4)])
    assert time.perf_counter() - t0 < 5.0  # nowhere near the 10 s window
    assert counting.calls == [[f"t{i}" for i in range(4)]]
    # a bucket never splits a request: 3 + 3 texts at max_batch 4 are two dispatches
    await asyncio.gather(b.embed(["a", "b", "c"]), b.embed(["d", "e", "f"]))
    assert counting.calls[1:] == [["a", "b", "c"], ["d", "e", "f"]]
    await b.close()


async def test_one_bad_request_fails_alone(encoder):
    counting = CountingEncoder(encoder, bad="BAD")
    b = EmbedMicrobatcher(counting, window_ms=30, max_batch=16)
    f0 = METRICS.get("finchat_embed_failures_total")
    r0 = METRICS.get("finchat_embed_batch_retries_total")
    results = await asyncio.gather(b.embed_one("fine 1"), b.embed_one("BAD"),
                                   b.embed_one("fine 2"), return_exceptions=True)
    assert isinstance(results[1], ValueError)
    np.testing.assert_array_equal(results[0], encoder.embed_batch(["fine 1"])[0])
    np.testing.assert_array_equal(results[2], encoder.embed_batch(["fine 2"])[0])
    assert counting.calls == [["fine 1", "BAD", "fine 2"], ["fine 1"], ["BAD"], ["fine 2"]]
    assert METRICS.get("finchat_embed_failures_total") - f0 == 1
    assert METRICS.get("finchat_embed_batch_retries_total") - r0 == 1
    await b.close()


async def test_threadsafe_ingest_rides_the_same_window(encoder):
    b = EmbedMicrobatcher(encoder, window_ms=20, max_batch=16)
    b.bind_loop()
    d0 = METRICS.get(DISPATCHES)
    query, ingest = await asyncio.gather(
        b.embed_one("query text"),
        asyncio.to_thread(b.embed_threadsafe, ["ingest 1", "ingest 2"]),
    )
    assert METRICS.get(DISPATCHES) - d0 == 1  # the query and the ingest shared one dispatch
    assert query.shape == (encoder.dim,) and ingest.shape == (2, encoder.dim)
    np.testing.assert_array_equal(ingest, encoder.embed_batch(["ingest 1", "ingest 2"]))
    await b.close()


async def test_threadsafe_calls_the_encoder_directly_where_it_must(encoder):
    """No loop bound (tests, offline tools), a closed batcher, and a call on
    the loop's own thread (where blocking would deadlock the flusher) go
    straight to the encoder, with no dispatch counted."""
    counting = CountingEncoder(encoder)
    b = EmbedMicrobatcher(counting, window_ms=5, max_batch=8)
    d0 = METRICS.get(DISPATCHES)
    assert await asyncio.to_thread(b.embed_threadsafe, ["unbound"]) is not None
    b.bind_loop()
    on_loop = b.embed_threadsafe(["on the loop thread"])
    await b.close()
    closed = b.embed_threadsafe(["closed"])
    assert on_loop.shape == closed.shape == (1, encoder.dim)
    assert counting.calls == [["unbound"], ["on the loop thread"], ["closed"]]
    assert METRICS.get(DISPATCHES) == d0


def test_bind_loop_rebinds_after_a_loop_restart(encoder):
    b = EmbedMicrobatcher(encoder, window_ms=1, max_batch=8)
    first = asyncio.run(b.embed_one("before the restart"))
    # the first loop is gone: the next embed binds the new one
    second = asyncio.run(b.embed_one("before the restart"))
    np.testing.assert_array_equal(first, second)

    async def bind():
        b.bind_loop()

    # a binding to a loop that still runs is not taken over
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever)
    t.start()
    try:
        asyncio.run_coroutine_threadsafe(bind(), loop).result(10)
        with pytest.raises(RuntimeError, match="already bound to a live loop"):
            asyncio.run(b.embed_one("from another loop"))
    finally:
        asyncio.run_coroutine_threadsafe(b.close(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        t.join(10)
        loop.close()
    assert not t.is_alive()


def test_threadsafe_ingest_beyond_the_default_executor(encoder):
    """More concurrent ingests than the loop's default executor has threads:
    each blocks a default-executor thread in ``embed_threadsafe`` while it
    waits, and the dispatches still run (on the batcher's own thread). With
    the dispatch on the default executor (the JAX package's copy) this
    waits out every call's timeout."""
    from concurrent.futures import ThreadPoolExecutor

    async def run():
        asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(max_workers=2))
        b = EmbedMicrobatcher(encoder, window_ms=5, max_batch=8)
        b.bind_loop()
        outs = await asyncio.gather(*(asyncio.to_thread(b.embed_threadsafe, [f"t{i}"], 20.0)
                                      for i in range(6)))
        await b.close()
        return outs

    outs = asyncio.run(run())
    assert [o.shape for o in outs] == [(1, encoder.dim)] * 6
    np.testing.assert_array_equal(outs[3], encoder.embed_batch(["t3"]))


async def test_close_flushes_then_refuses(encoder):
    b = EmbedMicrobatcher(encoder, window_ms=50, max_batch=8)
    pending = asyncio.ensure_future(b.embed_one("queued"))
    await asyncio.sleep(0)
    await b.close()
    assert (await pending).shape == (encoder.dim,)
    with pytest.raises(RuntimeError, match="closed"):
        await b.embed_one("after close")
    assert (await b.embed([])).shape == (0, encoder.dim)


async def test_backpressure_bounds_pending_texts(encoder, monkeypatch):
    """At ``max_pending`` queued texts a submitter waits for the drain; the
    queue depth gauge never passes the bound."""
    b = EmbedMicrobatcher(encoder, window_ms=5, max_batch=2, max_pending=2)
    depths = []
    orig = METRICS.set_gauge

    def spy(name, value, *a, **k):
        if name == "finchat_embed_queue_depth":
            depths.append(value)
        return orig(name, value, *a, **k)

    monkeypatch.setattr(METRICS, "set_gauge", spy)
    outs = await asyncio.gather(*[b.embed([f"a{i}", f"b{i}"]) for i in range(4)])
    assert [o.shape for o in outs] == [(2, encoder.dim)] * 4
    assert max(depths) == 2
    await b.close()


async def test_embed_dispatch_fault_retries_each_request():
    """``embed.dispatch``: a failed coalesced dispatch retries per request,
    so every caller still resolves (tests/test_faults.py)."""

    class FakeEncoder:
        dim = 4

        def embed_batch(self, texts):
            return np.ones((len(texts), self.dim), np.float32)

    batcher = EmbedMicrobatcher(FakeEncoder(), window_ms=5.0, max_batch=8)
    seen = []

    def handler(**ctx):
        seen.append(ctx)
        raise RuntimeError("encoder down")

    faults.arm("embed.dispatch", handler)
    r0 = METRICS.get("finchat_embed_batch_retries_total")
    rows = await asyncio.gather(*[batcher.embed_one(f"text {i}") for i in range(3)])
    faults.disarm("embed.dispatch")
    assert all(r.shape == (4,) for r in rows)
    assert seen == [{"n_texts": 3}]
    assert METRICS.get("finchat_embed_batch_retries_total") - r0 == 1
    await batcher.close()
