"""The port's scheduler routing of long prompts through the seq-sharded
prefill, and ``build_app`` over a ``seq`` axis, on spawned gloo ranks.

One world of 8 CPU ranks is spawned for the file (``torch_sp_ranks``: they
import only torch and the port); rank 0 of each case's mesh runs the port's
scheduler and the others mirror its engine. The oracles run in the pytest
process: the port's one-device scheduler (the same prompts chunked) and, for
the routed long prompt, the JAX one-device scheduler. The cases are
``tests/test_parallel.py``'s and ``tests/test_bounded_kv.py``'s:

- a long prompt on seq=2 x model=4 takes ``prefill_ring`` once (the default
  4,096-token segment holds it whole) and streams the one-device tokens;
- a stream decodes while a long prompt prefills in segments (``mixed_step``
  off, so the split path runs them): it gains at least one token between
  every two segments, and the long stream equals the monolithic ring's and
  one device's (counted tokens, no clock);
- a segmented ring prompt over a registered head keeps the prefix hit (its
  first segment starts past the head), on the ring path, streaming the
  uncached ring's tokens;
- data=1 x seq=2 with the mixed rounds on (``test_ring_promotion_real_seq_mesh``
  on a data=1 mesh: the port's serving refuses data): a long prompt admitted
  while a stream decodes rides the packed rounds, no seq-sharded entry runs,
  ``finchat_mixed_demotions_total{reason="ring"}`` stays pre-seeded at 0,
  the streams one device's.

In the pytest process with no mesh (the JAX tests' monkeypatch idiom):
admission skips the prefix match of a monolithic ring prompt and keeps it
for a segmented one, a ring-eligible prefix gets no partial hold, ring rows
ride the packed round with no demotion (``tests/test_bounded_kv.py:508``),
bounded rows never ring-route (``:631``). And ``build_app`` at ``mesh.seq=2
x mesh.model=2`` serves a Kafka turn whose response prompt prefills through
the ring, the stream the one-device app's.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_sp_ranks  # noqa: E402
from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401
from torch_tp_ranks import numpy_llama  # noqa: E402
from torch_train_ranks import World  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler, SequenceHandle  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

# tests/test_parallel.py's scheduler config
WIDE = dict(vocab_size=300, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128)
WIDE_TREE = numpy_llama(300, 64, 2, 8, 4, 128, 0)
# the tiny preset (tests/test_bounded_kv.py's)
TINY = dict(vocab_size=260, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=256)
TINY_TREE = numpy_llama(260, 128, 2, 4, 2, 256, 1)
SEQ2_MODEL4 = (1, 1, 2, 1, 4)
BASE = dict(max_seqs=2, page_size=8, num_pages=64, max_seq_len=256, prefill_chunk=16,
            warmup_on_start=False, session_cache=False)

LONG = ByteTokenizer().encode("x" * 60, add_bos=True)  # 61 tokens
_rng = np.random.RandomState(5)
PROGRESS_LONG = [int(x) for x in _rng.randint(5, 250, size=100)]
_rng = np.random.RandomState(9)
HEAD = [int(x) for x in _rng.randint(5, 250, size=48)]  # 6 whole pages
PREFIXED = HEAD + [int(x) for x in _rng.randint(5, 250, size=52)]  # 100 in all
_rng = np.random.default_rng(17)
PROMO_SHORT = [int(x) for x in _rng.integers(1, 260, size=8)]
PROMO_LONG = [int(x) for x in _rng.integers(1, 260, size=50)]


def _case(scenario: str, model: dict, tree: dict, sizes, ecfg: dict, **extra) -> dict:
    n = int(np.prod(sizes))
    return dict(kind="scheduler", scenario=scenario, sizes=sizes, ranks=tuple(range(n)),
                config=tllama.LlamaConfig(**model, max_seq_len=256, dtype=torch.float32),
                params=params_from_numpy(tree, "cpu"), ecfg=EngineConfig(**ecfg), **extra)


RING = dict(BASE, max_seq_len=128)
SEG = dict(BASE, mixed_step=False, ring_prefill_min_tokens=64, ring_prefill_chunk=32)
PROMO = dict(BASE, mixed_step=True, ring_prefill_min_tokens=32, ring_prefill_chunk=16)
CASES = {
    "routes": _case("routes", WIDE, WIDE_TREE, SEQ2_MODEL4,
                    dict(RING, ring_prefill_min_tokens=32), prompt=LONG, n_new=4),
    "progress": _case("progress", WIDE, WIDE_TREE, SEQ2_MODEL4, SEG, short=[1, 2, 3, 4, 5],
                      short_new=48, prompt=PROGRESS_LONG, n_new=6),
    "progress_mono": _case("progress", WIDE, WIDE_TREE, SEQ2_MODEL4,
                           dict(SEG, ring_prefill_chunk=0), short=[1, 2, 3, 4, 5], short_new=48,
                           prompt=PROGRESS_LONG, n_new=6),
    "prefix_cached": _case("prefix", WIDE, WIDE_TREE, SEQ2_MODEL4, dict(SEG, mixed_step=True),
                           register=True, head=HEAD, prompt=PREFIXED, n_new=6),
    "prefix_plain": _case("prefix", WIDE, WIDE_TREE, SEQ2_MODEL4, dict(SEG, mixed_step=True),
                          register=False, head=HEAD, prompt=PREFIXED, n_new=6),
    "promotion": _case("promotion", TINY, TINY_TREE, (1, 1, 2, 1, 1), PROMO, short=PROMO_SHORT,
                       short_new=24, prompt=PROMO_LONG, n_new=5),
}


def _port_sched(model: dict, tree: dict, ecfg: dict, **over) -> ContinuousBatchingScheduler:
    engine = InferenceEngine(tllama.LlamaConfig(**model, max_seq_len=256, dtype=torch.float32),
                             params_from_numpy(tree, "cpu"), EngineConfig(**{**ecfg, **over}),
                             device="cpu")
    return ContinuousBatchingScheduler(engine, eos_id=-1)


async def _tokens(handle) -> list[int]:
    out = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=120)
        if event["type"] == "done":
            return out
        assert event["type"] == "token", event
        out.append(event["token_id"])


def _greedy(n: int, jax_side: bool = False):
    return (JaxSampling if jax_side else SamplingParams)(temperature=0.0, max_new_tokens=n)


def _one_device(sched, prompts: list[tuple[list[int], int]], after_first=False):
    """Greedy streams on a one-device scheduler (the JAX one too); with
    ``after_first`` the second prompt is submitted once the first has a
    token."""
    jax_side = isinstance(sched, JaxScheduler)

    async def run():
        await sched.start()
        try:
            hs = [await sched.submit("s0", prompts[0][0], _greedy(prompts[0][1], jax_side))]
            if after_first:
                first = await asyncio.wait_for(hs[0].events.get(), timeout=120)
                hs.append(await sched.submit("s1", prompts[1][0],
                                             _greedy(prompts[1][1], jax_side)))
                rest = await asyncio.gather(*(_tokens(h) for h in hs))
                return [[first["token_id"]] + rest[0], rest[1]]
            hs += [await sched.submit(f"s{i}", p, _greedy(n, jax_side))
                   for i, (p, n) in enumerate(prompts[1:], start=1)]
            return list(await asyncio.gather(*(_tokens(h) for h in hs)))
        finally:
            await sched.stop()

    return asyncio.run(run())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    the spawned ranks (and the suite's other workers) share the machine's
    cores, where every process's default thread pool would oversubscribe
    them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The world's results, and the one-device oracles computed while it
    runs."""
    world = World(8, CASES, target=torch_sp_ranks.rank_main)
    try:
        oracle = {
            "routes": _one_device(_port_sched(WIDE, WIDE_TREE, RING), [(LONG, 4)])[0],
            "progress": _one_device(_port_sched(WIDE, WIDE_TREE, SEG),
                                    [([1, 2, 3, 4, 5], 48), (PROGRESS_LONG, 6)]),
            "prefix": _one_device(_port_sched(WIDE, WIDE_TREE, SEG), [(PREFIXED, 6)])[0],
            "promotion": _one_device(_port_sched(TINY, TINY_TREE, PROMO),
                                     [(PROMO_SHORT, 24), (PROMO_LONG, 5)], after_first=True),
        }
        jcfg = jllama.LlamaConfig(**WIDE, max_seq_len=256, dtype=jnp.float32)
        jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, WIDE_TREE), JaxEngineConfig(**RING),
                         attn_backend="ref")
        oracle["routes_jax"] = _one_device(JaxScheduler(jeng, eos_id=-1), [(LONG, 4)])[0]
        yield world.results(), oracle
    finally:
        world.close()


def test_scheduler_routes_long_prompts_through_ring_prefill(runs):
    """The serving path engages the seq-sharded prefill: one ``prefill_ring``
    of all 61 tokens (inside the one segment the default 4,096-token
    ``ring_prefill_chunk`` makes), four tokens equal to the port's and the
    JAX package's one-device schedulers', every page freed, every follower
    mirroring the calls."""
    world, oracle = runs
    got = world[0]["routes"]
    assert got["ring_calls"] == [61] and got["segment_calls"] == [61]
    assert got["tokens"] == oracle["routes"] == oracle["routes_jax"]
    assert got["pages_in_use"] == 0
    assert len({res["routes"]["calls"] for r, res in world.items() if r}) == 1


def test_scheduler_decode_progress_during_ring_prefill(runs):
    """With segments of 32 and the split path (``mixed_step`` off), a stream
    decoding beside a 100-token prompt gains at least one token between any
    two of its segments (four: the plain step, then three with the prefix
    fold), and the long stream equals the monolithic ring's and one
    device's; the monolithic ring runs one ``prefill_ring`` (counted tokens,
    no clock)."""
    world, oracle = runs
    seg, mono = world[0]["progress"], world[0]["progress_mono"]
    at = seg["at_calls"]
    # prefill_ring_segment (4) and the nested prefill_ring of the first
    assert len(at) == 5
    segment_at = [at[0]] + at[2:]
    assert all(b > a for a, b in zip(segment_at, segment_at[1:])), segment_at
    assert len(mono["at_calls"]) == 1
    assert seg["tokens"] == mono["tokens"] == oracle["progress"][1]
    assert seg["stream"] == oracle["progress"][0]
    assert seg["pages_in_use"] == mono["pages_in_use"] == 0


def test_segmented_ring_composes_with_prefix_cache(runs):
    """A ring-eligible prompt over a registered 48-token head keeps the hit:
    48 tokens saved, one segment started at 48 with the head folded as
    prefix (then 32 and 20 more), on the ring path; its stream equals the
    uncached ring's and one device's."""
    world, oracle = runs
    cached, plain = world[0]["prefix_cached"], world[0]["prefix_plain"]
    assert cached["saved"] == 48 and plain["saved"] == 0
    assert cached["ring_path"] and plain["ring_path"]
    assert cached["segment_calls"] == [(32, 48), (20, 80)]
    assert plain["segment_calls"] == [(32, 0), (32, 32), (32, 64), (4, 96)]
    assert cached["tokens"] == plain["tokens"] == oracle["prefix"]


def test_ring_promotion_real_seq_mesh(runs):
    """data=1 x seq=2, the mixed rounds on: the long prompt, admitted while a
    stream decodes, rides the packed ragged rounds as chunk rows (no
    seq-sharded entry), ``finchat_mixed_demotions_total{reason="ring"}`` is
    pre-seeded and stays 0, and both streams equal the one-device
    scheduler's."""
    world, oracle = runs
    got = world[0]["promotion"]
    assert got["ring_calls"] == [] and got["ring_demotions"] == 0 and got["demotion_seeded"]
    assert [got["stream"], got["tokens"]] == oracle["promotion"]


# --- no mesh: the routing rules (the JAX tests' monkeypatch idiom) ----------------------

def _tiny_sched(**over) -> ContinuousBatchingScheduler:
    return _port_sched(TINY, TINY_TREE, dict(BASE, max_seqs=4, num_pages=128), **over)


@pytest.mark.parametrize("segmented", [False, True])
def test_ring_eligible_prompts_skip_prefix_match(segmented):
    """A monolithic ring prompt matches no prefix (a hit would force it onto
    the chunked path); a segmented one keeps the head, its first segment
    starting past it; a prompt that is not ring-eligible keeps it too."""
    sched = _tiny_sched()
    tok = ByteTokenizer()
    ids = tok.encode("system: you are a terse financial assistant, answer briefly.",
                     add_bos=True)
    assert sched.register_prefix(ids) > 0
    prompt = ids + [7, 8, 9]
    sched.engine.ring_segment_tokens = lambda: 32 if segmented else 0

    def admit(ring_eligible: bool):
        sched.engine._use_ring_prefill = lambda n: ring_eligible
        handle = SequenceHandle(seq_id=f"s{ring_eligible}", prompt_ids=prompt,
                                sampling=_greedy(4))
        sched.pending.append(handle)
        sched._admit()
        assert handle.slot >= 0
        return handle

    ring = admit(True)
    if segmented:
        assert ring.prefix_entry is not None and ring.prefill_pos > 0
        assert sched._ring_routed(ring)
    else:
        assert ring.prefix_entry is None and ring.prefill_pos == 0
    chunked = admit(False)
    assert chunked.prefix_entry is not None and chunked.prefill_pos > 0
    assert not sched._ring_routed(chunked)


def test_ring_eligible_prefix_takes_no_partial_hold():
    """``submit_partial`` declines a prefix long enough for the seq-sharded
    prefill (it owns its prompt from end to end): the caller submits the
    whole prompt."""
    sched = _tiny_sched()
    sched.engine._use_ring_prefill = lambda n: n >= 16

    async def run():
        short = await sched.submit_partial("a", list(range(1, 9)), _greedy(4))
        long = await sched.submit_partial("b", list(range(1, 41)), _greedy(4))
        return short, long

    short, long = asyncio.run(run())
    assert short is not None and short.held and long is None
    sched.cancel(short)


def test_ring_promotion_no_demotion_and_identity(monkeypatch):
    """A ring-eligible prompt (no seq mesh: the predicate patched, the ring
    entry raising) admitted while a stream decodes rides the packed ragged
    round: no ``reason="ring"`` demotion, one fused dispatch a coexist round,
    and the streams equal the plain scheduler's."""

    def run(force_ring: bool):
        sched = _tiny_sched(max_seqs=4, mixed_step=True)
        if force_ring:
            monkeypatch.setattr(sched.engine, "_use_ring_prefill", lambda n: n >= 48)

            def boom(*a, **k):
                raise AssertionError("a seq-sharded entry reached from the mixed path")

            monkeypatch.setattr(sched.engine, "prefill_ring", boom)
            monkeypatch.setattr(sched.engine, "prefill_ring_segment", boom)
        rng = np.random.default_rng(13)
        short = rng.integers(1, 260, size=8).tolist()
        long_p = rng.integers(1, 260, size=3 * 16 + 5).tolist()

        async def go():
            snap0 = METRICS.snapshot()
            await sched.start()
            try:
                hs = await sched.submit("short", short, _greedy(30))
                first = await asyncio.wait_for(hs.events.get(), timeout=120)
                second = await asyncio.wait_for(hs.events.get(), timeout=120)
                hl = await sched.submit("long", long_p, _greedy(6))
                rest, tokens = await asyncio.gather(_tokens(hs), _tokens(hl))
                snap1 = METRICS.snapshot()
                delta = {k: snap1.get(k, 0) - snap0.get(k, 0)
                         for k in ('finchat_mixed_demotions_total{reason="ring"}',
                                   "finchat_coexist_dispatches_total",
                                   "finchat_coexist_iterations_total",
                                   "finchat_coexist_rounds_total")}
                return [[first["token_id"], second["token_id"]] + rest, tokens], delta
            finally:
                await sched.stop()

        return asyncio.run(go())

    plain, _ = run(False)
    promoted, delta = run(True)
    assert delta['finchat_mixed_demotions_total{reason="ring"}'] == 0
    assert promoted == plain
    assert delta["finchat_coexist_iterations_total"] > 0
    assert delta["finchat_coexist_dispatches_total"] == delta["finchat_coexist_rounds_total"]


def test_bounded_rows_never_ring_route(monkeypatch):
    """A bounded row (sink 1 + window 4 pages) never takes the seq-sharded
    prefill, even ring-eligible and past its budget: it rides chunked
    prefill, evicts and completes, the ring entries never reached."""
    sched = _tiny_sched(max_seqs=4, kv_sink_pages=1, kv_window_pages=4, mixed_step=True,
                        max_seq_len=512)

    def boom(*a, **k):
        raise AssertionError("a seq-sharded entry reached on a bounded row")

    monkeypatch.setattr(sched.engine, "_use_ring_prefill", lambda n: n >= 48)
    monkeypatch.setattr(sched.engine, "prefill_ring", boom)
    monkeypatch.setattr(sched.engine, "prefill_ring_segment", boom)
    prompt = np.random.default_rng(21).integers(1, 260, size=64).tolist()

    async def go():
        await sched.start()
        try:
            h = await sched.submit("s", prompt, _greedy(12))
            assert not sched._ring_routed(h)
            out = await _tokens(h)
            sched.allocator.check_invariants()
            return out
        finally:
            await sched.stop()

    assert len(asyncio.run(go())) == 12


# --- build_app over seq ------------------------------------------------------------------

APP_SYSTEM = ("You are Penny, a careful personal-finance assistant. Answer from the "
              "user's own accounts and transactions, briefly, and never invent numbers.")
APP_TOOL = ("Decide whether transaction data is needed. Answer with one tool call "
            "or with the words No tool call.")
APP_ENGINE = dict(max_seqs=4, page_size=32, num_pages=72, max_seq_len=1024, prefill_chunk=32,
                  max_new_tokens=12, temperature=0.0, ring_prefill_min_tokens=256)
APP_CONTEXT = {"user_id": "u9", "name": "Alex", "income": 5000, "savings_goal": 800}
APP_RETRIEVE = 'retrieve_transactions({"search_query": "coffee", "num_transactions": 2})'


async def _app_retriever(args):
    return [f"txn for {args['user_id']}", "COFFEE $4.50 on 2026-07-30"]


def _app_turn(mesh: dict) -> tuple:
    """One Kafka turn through the port's ``build_app`` on ``tiny`` (fp32,
    seed 5, greedy, the decision a stub that retrieves): the app, its
    response handle, the ``ai_response`` chunks and the seq-sharded
    entries rank 0 took."""
    from finchat_tpu_torch.engine.generator import StubGenerator
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.serve import app as tapp
    from finchat_tpu_torch.utils.config import load_config

    cfg = load_config(overrides={
        "model.preset": "tiny", "model.dtype": "float32", "model.seed": 5,
        **{f"mesh.{k}": v for k, v in mesh.items()},
        **{f"engine.{k}": v for k, v in APP_ENGINE.items()}})
    store = InMemoryStore()
    store.upsert_context("c1", APP_CONTEXT)
    store.add_user_message("c1", "How am I doing?", "u9", timestamp=100)
    broker = InMemoryBroker()
    app = tapp.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                         tool_generator=StubGenerator(default=APP_RETRIEVE),
                         retriever=_app_retriever, device="cpu")
    handles, entries = [], []
    submit = app.scheduler.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    app.scheduler.submit = recording_submit
    engine = app.scheduler.engine
    for name in ("prefill_ring", "prefill_ring_segment"):
        real = getattr(engine, name)

        def spy(*a, _real=real, _name=name, **k):
            entries.append((_name, len(a[1])))
            return _real(*a, **k)

        setattr(engine, name, spy)

    async def through_app():
        await app.start(serve_http=False)
        try:
            KafkaClient(cfg.kafka, broker=broker).produce_message(
                "user_message", "c1", {"message": "What about coffee?", "conversation_id": "c1",
                                       "user_id": "u9", "message_id": "m-sp"})
            for _ in range(60000):  # bounded: 300 s of 5 ms ticks
                if any(json.loads(m.value()).get("type") == "complete"
                       for m in broker.drain("ai_response")):
                    break
                await asyncio.sleep(0.005)
            while app._inflight:
                await asyncio.sleep(0.005)
        finally:
            await app.stop()

    try:
        asyncio.run(through_app())
    finally:
        if app.ranks is not None:
            app.ranks.close(join_s=10.0)
    return app, handles[-1], [json.loads(m.value()) for m in broker.drain("ai_response")], entries


def test_build_app_mesh_seq2_model2_serves_a_ring_turn(monkeypatch, runs):
    """``build_app`` with ``mesh.seq=2 x mesh.model=2`` on the CPU: this
    process is rank 0, three followers load their shards from the seed; the
    Kafka turn's response prompt (past ``ring_prefill_min_tokens`` 256)
    prefills through the seq-sharded path; the chunks equal the one-device
    app's; stopping leaves no follower and no process group."""
    import torch.distributed as dist

    from finchat_tpu_torch.serve import app as tapp

    monkeypatch.setattr(tapp, "load_prompts", lambda: (APP_SYSTEM, APP_TOOL))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the followers' (read at their start)
    one_app, one, one_chunks, one_entries = _app_turn({"model": 1})
    app, got, chunks, entries = _app_turn({"seq": 2, "model": 2})
    assert one_entries == []
    assert entries and all(n >= 1 for _name, n in entries)
    assert app.ranks is not None and app.ranks.closed and app.ranks.live == 0
    assert len(app.ranks.procs) == 3
    assert not dist.is_initialized()
    assert app.scheduler.engine.mesh.shape["seq"] == 2
    assert got.ring_path or any(name == "prefill_ring" for name, _n in entries)
    assert chunks[-1]["type"] == "complete" and chunks[-1]["message"] == "What about coffee?"
    assert [c for c in chunks if "type" not in c] == []  # no error chunk
    assert list(got.prompt_ids) == list(one.prompt_ids)
    assert list(got.history) == list(one.history)
    assert chunks == one_chunks
