"""The port's ``retrieve_transactions`` tool (``tools/retrieval.py``): the
seven cases of tests/test_retrieval.py on the port, the security post-check
and the batched-equals-serial contract on both planes
(tests/test_retrieval_plane.py), and the JAX package's retriever against
the port's over the same converted weights (fp32): the same rows, in the
same order, for the same tool arguments, on both planes."""

import asyncio
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.embed import encoder as jenc  # noqa: E402
from finchat_tpu.embed.batcher import EmbedMicrobatcher as JaxBatcher  # noqa: E402
from finchat_tpu.embed.index import DeviceVectorIndex as JaxIndex  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer  # noqa: E402
from finchat_tpu.tools.retrieval import TransactionRetriever as JaxRetriever  # noqa: E402
from finchat_tpu_torch.embed import encoder as tenc  # noqa: E402
from finchat_tpu_torch.embed.batcher import EmbedMicrobatcher  # noqa: E402
from finchat_tpu_torch.embed.index import DeviceVectorIndex  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.tools.retrieval import TransactionRetriever  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

NOW = 1_700_000_000.0
ALICE = ["GROCERY OUTLET $54.12", "RENT PAYMENT $2000", "COFFEE SHOP $4.50"]
ALICE_DATES = [NOW - 86400 * 40, NOW - 86400 * 5, NOW - 86400 * 1]


@pytest.fixture(scope="module")
def encoder():
    cfg = tenc.EMBED_PRESETS["bge-tiny"]
    params = tenc.init_bert_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return tenc.EmbeddingEncoder(cfg, params, ByteTokenizer(), device="cpu")


@pytest.fixture(scope="module")
def retriever(encoder):
    r = TransactionRetriever(encoder, DeviceVectorIndex(dim=encoder.dim, device="cpu"),
                             now=lambda: NOW)
    r.upsert_transactions("alice", ALICE, dates=ALICE_DATES)
    r.upsert_transactions("bob", ["BOB'S SECRET PURCHASE $999"], dates=[NOW - 100])
    return r


async def test_empty_user_id_returns_empty(retriever):
    assert await retriever({"search_query": "anything"}) == []
    assert await retriever({"user_id": "", "search_query": "anything"}) == []


async def test_user_isolation(retriever):
    hits = await retriever({"user_id": "alice", "search_query": "purchases"})
    assert len(hits) == 3 and all("BOB" not in h for h in hits)


async def test_time_period_filter(retriever):
    hits = await retriever({"user_id": "alice", "search_query": "purchases",
                            "time_period_days": 7})
    assert len(hits) == 2 and not any("GROCERY" in h for h in hits)


async def test_num_transactions_limit(retriever):
    assert len(await retriever({"user_id": "alice", "search_query": "purchases",
                                "num_transactions": 1})) == 1


async def test_default_limit_is_10000(retriever):
    hits = await retriever({"user_id": "alice", "search_query": "purchases",
                            "num_transactions": None})
    assert len(hits) == 3 and retriever.default_limit == 10_000


async def test_exception_returns_empty_list(retriever):
    broken = TransactionRetriever(retriever.encoder, None, now=lambda: NOW)  # type: ignore
    assert await broken({"user_id": "alice", "search_query": "x"}) == []


async def test_retrieval_runs_off_the_event_loop(retriever):
    """A slow embed (a long device sync) must not stall the loop: a 5 ms
    heartbeat keeps ticking while the retrieval is in flight."""
    slow = TransactionRetriever(retriever.encoder, retriever.index, now=lambda: NOW)
    orig_embed = slow.encoder.embed_query

    class SlowEncoder:
        def __init__(self, inner):
            self._inner = inner

        def embed_query(self, text):
            time.sleep(0.25)
            return orig_embed(text)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    slow.encoder = SlowEncoder(slow.encoder)
    beats = 0

    async def heartbeat():
        nonlocal beats
        while True:
            await asyncio.sleep(0.005)
            beats += 1

    hb = asyncio.create_task(heartbeat())
    t0 = time.perf_counter()
    hits = await slow.structured({"user_id": "alice", "search_query": "purchases"})
    elapsed = time.perf_counter() - t0
    hb.cancel()
    assert len(hits) == 3 and elapsed >= 0.25
    assert beats >= 10, f"event loop starved during retrieval ({beats} beats)"


def test_security_post_check_on_both_planes(encoder):
    """A payload whose user_id was changed after the upsert passes the
    (stale) filter column but is dropped by the post-check, on the serial
    and on the batched plane."""

    async def run():
        index = DeviceVectorIndex(dim=encoder.dim, device="cpu")
        plain = TransactionRetriever(encoder, index, now=lambda: NOW)
        plain.upsert_transactions("alice", ["ALICE TXN $1", "ALICE TXN $2"], dates=[NOW, NOW])
        index._points[1].payload["metadata"]["user_id"] = "eve"
        s0 = METRICS.get("finchat_retrieval_security_skips_total")
        serial_hits = await plain({"user_id": "alice", "search_query": "txn"})
        batcher = EmbedMicrobatcher(encoder, window_ms=0.5, max_batch=8)
        batched = TransactionRetriever(encoder, index, now=lambda: NOW, batcher=batcher)
        batched_hits = await batched({"user_id": "alice", "search_query": "txn"})
        await batcher.close()
        return serial_hits, batched_hits, METRICS.get(
            "finchat_retrieval_security_skips_total") - s0

    serial_hits, batched_hits, skips = asyncio.run(run())
    assert serial_hits == batched_hits == ["ALICE TXN $1"]
    assert skips == 2


def test_batched_retriever_matches_serial_and_times_both_stages(encoder):
    async def run():
        index = DeviceVectorIndex(dim=encoder.dim, device="cpu")
        serial = TransactionRetriever(encoder, index, now=lambda: NOW)
        serial.upsert_transactions(
            "alice", ["GROCERY $54.12", "RENT $2000", "COFFEE $4.50", "GAS $30"],
            dates=[NOW - 86400 * 40, NOW - 86400 * 5, NOW - 86400, NOW - 3600],
            metadatas=[{"amount": -54.12}, {"amount": -2000.0}, {"amount": -4.5},
                       {"amount": -30.0}])
        serial.upsert_transactions("bob", ["BOB SECRET $999"], dates=[NOW])
        batcher = EmbedMicrobatcher(encoder, window_ms=0.5, max_batch=8)
        batched = TransactionRetriever(encoder, index, now=lambda: NOW, batcher=batcher)
        args = {"user_id": "alice", "search_query": "purchases", "time_period_days": 7}
        before = METRICS.snapshot()
        a = await serial.structured(args)
        b = await batched.structured(args)
        await batcher.close()
        after = METRICS.snapshot()
        return a, b, {n: after.get(f"{n}_count", 0) - before.get(f"{n}_count", 0)
                      for n in ("finchat_retrieval_embed_seconds",
                                "finchat_retrieval_search_seconds")}

    a, b, timed = asyncio.run(run())
    assert a == b and len(a) == 3 and not any("BOB" in r["page_content"] for r in a)
    assert {r["amount"] for r in a} == {-2000.0, -4.5, -30.0}
    assert all(r["user_id"] == "alice" for r in a)
    assert timed == {"finchat_retrieval_embed_seconds": 2, "finchat_retrieval_search_seconds": 2}


ARGS = [
    {"user_id": "alice", "search_query": "coffee"},
    {"user_id": "alice", "search_query": "rent", "time_period_days": 7},
    {"user_id": "alice", "num_transactions": 2},
    {"user_id": "bob", "search_query": "purchase"},
    {"user_id": "carol"},
    {"search_query": "no user"},
]


@pytest.mark.parametrize("plane", ["serial", "batched"])
def test_same_rows_as_the_jax_package(plane):
    """Both packages' retrievers over the same fp32 weights (the JAX tree
    converted), the same upserts and the same clock give the same rows in
    the same order."""
    jcfg = jenc.BertConfig(dtype=jnp.float32)
    tcfg = tenc.BertConfig(dtype=torch.float32)
    jparams = jenc.init_bert_params(jcfg, jax.random.key(2))
    tparams = tenc.bert_params_from_numpy(jax.device_get(jparams), "cpu")
    jax_enc = jenc.EmbeddingEncoder(jcfg, jparams, JaxTokenizer())
    port_enc = tenc.EmbeddingEncoder(tcfg, tparams, ByteTokenizer(), device="cpu")
    rows = [f"{kind} {3 * i + 1}.{i:02d}" for i, kind in
            enumerate(["COFFEE", "RENT", "GROCERY", "COFFEE", "PAYROLL", "GAS", "RENT"])]
    dates = [NOW - 86400 * d for d in (1, 3, 9, 12, 20, 2, 40)]

    async def run(make_retriever, make_batcher, encoder, index):
        batcher = make_batcher(encoder, window_ms=0.5, max_batch=8) if plane == "batched" \
            else None
        r = make_retriever(encoder, index, now=lambda: NOW, batcher=batcher)
        r.upsert_transactions("alice", rows, dates=dates)
        r.upsert_transactions("bob", rows[:3], dates=dates[:3])
        out = [await r.structured(a) for a in ARGS]
        if batcher is not None:
            await batcher.close()
        return out

    want = asyncio.run(run(JaxRetriever, JaxBatcher, jax_enc, JaxIndex(dim=jcfg.dim)))
    got = asyncio.run(run(TransactionRetriever, EmbedMicrobatcher, port_enc,
                          DeviceVectorIndex(dim=tcfg.dim, device="cpu")))
    assert got == want
    assert [len(r) for r in got] == [7, 3, 2, 3, 0, 0]
