"""The port's free-running loop against the JAX package's, on CPU at fp32.

- Staging: ``ops/freerun.stage_freerun`` gives arrays and host bookkeeping
  equal to the JAX package's for the same ``RowSpec``s (exact).
- Engine level: ``ragged_multi_round`` over a staged 3-round queue (a
  prompt completing in round 0 and decoding after it, a decode row with a
  fused tail every round) is byte-identical to three host-stepped
  ``ragged_mixed_step`` calls of the port over the same descriptors, and
  gives the JAX package's ``ragged_multi_round`` tokens, counts, tails and
  context lengths on the same converted ``tiny`` fp32 weights; the stop
  mask: a row whose slot holds EOS rides every round inert (emits 0, its
  context and pages untouched), as in the JAX engine.
- The scheduler, within the port: captured streams byte-identical to the
  host-stepped ones (a long prompt admitted mid-decode, a mid-run EOS),
  dispatches a round below 1, a preemption mid-capture delivering every
  token exactly once, a cancel mid-capture sparing the completion inside
  it, the divergence anomaly, and waves of admissions leaving no page or
  slot behind.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401  (the leak audit)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.engine import commit_first_token as jax_commit  # noqa: E402
from finchat_tpu.engine.engine import prefill_step as jax_prefill_step  # noqa: E402
from finchat_tpu.engine.engine import ragged_multi_round as jax_multi_round  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.ops import freerun as jfreerun  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler,
    _InFlightRing,
)
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.ops import freerun as tfreerun  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    the suite runs six workers on the machine's cores, where each worker's
    default thread pool would oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CHUNK = 8
VOCAB = 260
ENGINE = dict(max_seqs=4, page_size=8, num_pages=64, max_seq_len=128, prefill_chunk=CHUNK,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


# --- staging -------------------------------------------------------------------------


def _specs(mod):
    S = mod.RowSpec
    return [
        [S(slot=1, kind="prefill", ids=list(range(1, 2 * CHUNK + 3)), pos=CHUNK, budget=6,
           loop_ok=True, temperature=0.0),
         S(slot=0, kind="decode", budget=9, loop_ok=True, top_k=5),
         S(slot=3, kind="job", ids=list(range(40, 40 + 3 * CHUNK)), pos=0, arm=False),
         S(slot=2, kind="prefill", ids=list(range(70, 70 + CHUNK + 1)), pos=0, arm=False)],
        [S(slot=0, kind="decode", budget=3, loop_ok=True),
         S(slot=2, kind="decode", budget=1)],
        [S(slot=2, kind="prefill", ids=list(range(9, 9 + 4)), pos=0, budget=2, top_p=0.5)],
    ]


def _bucket(n):
    return max(64, 1 << (n - 1).bit_length())


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("loop_depth", [1, 2, 3])
def test_stage_freerun_equals_jax(case, loop_depth):
    kw = dict(rounds=4, chunk=CHUNK, loop_depth=loop_depth, max_seqs=4, bucket=_bucket)
    got = tfreerun.stage_freerun(_specs(tfreerun)[case], **kw)
    want = jfreerun.stage_freerun(_specs(jfreerun)[case], **kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


# --- the engine ----------------------------------------------------------------------


def _prepare(models, jax_side):
    """Slot 0 decoding (its first token committed), slot 1 with the first
    chunk of a two-chunk prompt prefilled; the JAX side's first token is
    forced onto the port's engine."""
    jcfg, jparams, tcfg, tparams = models
    ecfg = dict(ENGINE, decode_loop_depth=2, freerun_rounds=3)
    if jax_side:
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ecfg), attn_backend="ref")
    else:
        eng = InferenceEngine(tcfg, tparams, EngineConfig(**ecfg), device="cpu")
    p0, p1 = [3, 7, 11, 200, 42], list(range(1, CHUNK + 6))
    eng.set_page_table_row(0, list(range(1, 5)))
    eng.set_page_table_row(1, list(range(5, 9)))
    logits = eng.prefill(0, p0)
    if jax_side:
        eng.state, tok = jax_commit(eng.state, jnp.int32(0), logits, jnp.float32(0.0),
                                    jnp.float32(1.0), jnp.int32(0))
        eng.state, _ = jax_prefill_step(
            eng.params, eng.state, jnp.asarray([p1[:CHUNK]], jnp.int32),
            jnp.asarray([1], jnp.int32), jnp.asarray([0], jnp.int32),
            jnp.asarray([CHUNK], jnp.int32), config=eng.config, page_size=8,
            attn_backend=eng.attn_backend)
    else:
        tok = eng.commit_first_token(0, logits, 0.0, 1.0, 0)
        eng.prefill_chunk([p1[:CHUNK]], [1], [0], [CHUNK])
    return eng, p1, int(tok)


def _plan(p1):
    specs = [tfreerun.RowSpec(slot=1, kind="prefill", ids=p1, pos=CHUNK, budget=16,
                              loop_ok=False),
             tfreerun.RowSpec(slot=0, kind="decode", budget=16, loop_ok=True)]
    return tfreerun.stage_freerun(specs, rounds=3, chunk=CHUNK, loop_depth=2, max_seqs=4,
                                  bucket=_bucket)


def _multi_args(plan):
    B = 4
    return (plan.tokens, plan.tok_row, plan.row_slot, plan.row_start, plan.row_len,
            plan.row_from_device, plan.row_arm, plan.temperature, plan.top_p, plan.top_k,
            plan.loop_active, np.zeros(B, np.float32), np.ones(B, np.float32),
            np.zeros(B, np.int32))


def test_multi_round_matches_stepped_rounds_and_jax(models):
    jeng, p1, first = _prepare(models, jax_side=True)
    plan = _plan(p1)
    assert plan.completes_at == {0: 0} and plan.loop_active[:, 0].all()
    # the port, one captured dispatch
    cap, _p1, tfirst = _prepare(models, jax_side=False)
    assert tfirst == first
    ring = [t.numpy() for t in cap.ragged_multi(*_multi_args(plan), eos_id=-1)]
    # the port, three host-stepped rounds over the same descriptors
    step, _p1, _f = _prepare(models, jax_side=False)
    R, B = 4, 4
    zB, oB, kB = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    stepped = [[], [], []]
    for r in range(3):
        em, n, _lg, blk = step.ragged_mixed(
            plan.tokens[r], plan.tok_row[r], plan.row_slot, plan.row_start[r], plan.row_len[r],
            plan.row_from_device[r], plan.row_arm[r], plan.temperature, plan.top_p, plan.top_k,
            np.zeros(R, np.int32), plan.loop_active[r], zB, oB, kB, -1)
        for i, t in enumerate((em[:, 0], n, blk)):
            stepped[i].append(t.numpy())
    for got, want in zip(ring, stepped):
        np.testing.assert_array_equal(got, np.stack(want))
    for name in ("context_lens", "last_tokens", "k_pages", "v_pages"):
        assert torch.equal(getattr(cap.state, name), getattr(step.state, name)), name
    # the JAX package's captured run
    jeng.state, *jring = jax_multi_round(
        jeng.params, jeng.state, *(jnp.asarray(a) for a in _multi_args(plan)), jnp.int32(-1),
        config=jeng.config, page_size=8, attn_backend=jeng.attn_backend, loop_depth=2)
    for got, want in zip(ring, jring):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(cap.state.context_lens.numpy(),
                                  np.asarray(jeng.state.context_lens))
    np.testing.assert_array_equal(cap.state.last_tokens.numpy(),
                                  np.asarray(jeng.state.last_tokens))


def test_multi_round_eos_stop_mask_matches_jax(models):
    """Slot 0's last token is the stop token: its decode row rides all
    three rounds inert (emits 0, context and pages as they were, no tail)
    while slot 1's prompt completes and decodes."""
    jeng, p1, first = _prepare(models, jax_side=True)
    eng, _p1, _f = _prepare(models, jax_side=False)
    plan = _plan(p1)
    ctx0 = eng.state.context_lens.clone()
    pages0 = eng.state.k_pages[:, 1:5].clone()
    ring = [t.numpy() for t in eng.ragged_multi(*_multi_args(plan), eos_id=first)]
    jeng.state, *jring = jax_multi_round(
        jeng.params, jeng.state, *(jnp.asarray(a) for a in _multi_args(plan)),
        jnp.int32(first), config=jeng.config, page_size=8, attn_backend=jeng.attn_backend,
        loop_depth=2)
    tokens, n, blocks = ring
    assert (n[:, 1] == 0).all() and (blocks[:, :, 0] == -1).all()
    assert n[:, 0].tolist() == [1, 1, 1]
    assert int(eng.state.context_lens[0]) == int(ctx0[0])
    assert torch.equal(eng.state.k_pages[:, 1:5], pages0)
    for got, want in zip(ring, jring):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(eng.state.context_lens.numpy(),
                                  np.asarray(jeng.state.context_lens))


# --- the scheduler ---------------------------------------------------------------------


def _stack(models, freerun, eos_id=-1, loop_depth=2):
    _j, _jp, tcfg, tparams = models
    cfg = EngineConfig(**{**ENGINE, "num_pages": 128}, decode_loop_depth=loop_depth,
                       freerun_rounds=freerun)
    return ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, cfg, device="cpu"),
                                       eos_id=eos_id)


async def _drain(handle, out, errors=None):
    while True:
        ev = await asyncio.wait_for(handle.events.get(), timeout=120)
        if ev["type"] == "token":
            out.append(ev["token_id"])
        elif ev["type"] == "done":
            return
        elif errors is not None:
            errors.append(ev)
            return
        else:
            raise AssertionError(ev)


def _prompts(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, VOCAB, size=10).tolist(), rng.integers(1, VOCAB, size=14).tolist(),
            rng.integers(1, VOCAB, size=5 * CHUNK + 2).tolist())


def _run_workload(models, freerun, eos_id=-1, mid_flight=None):
    """Two decode streams, then a long prompt admitted mid-decode, so the
    captures carry prefill rows, a completion flip and decode rows.
    ``mid_flight(sched, handles)`` runs once the first capture is in
    flight. Returns (streams, metric window)."""
    sched = _stack(models, freerun, eos_id=eos_id)
    short_a, short_b, long_p = _prompts()
    names = ("finchat_freerun_dispatches_total", "finchat_coexist_dispatches_total",
             "finchat_coexist_rounds_total", "finchat_freerun_epoch_breaks_total",
             "finchat_preemptions_total")

    async def go():
        before = {k: METRICS.get(k) for k in names}
        await sched.start()
        try:
            ha = await sched.submit("a", short_a, SamplingParams(temperature=0.0,
                                                                 max_new_tokens=28))
            hb = await sched.submit("b", short_b, SamplingParams(temperature=0.0,
                                                                 max_new_tokens=22))
            outs = {"a": [], "b": [], "long": []}
            tasks = [asyncio.create_task(_drain(ha, outs["a"])),
                     asyncio.create_task(_drain(hb, outs["b"]))]
            while len(outs["a"]) < 2 or len(outs["b"]) < 2:
                await asyncio.sleep(0.002)
            hl = await sched.submit("long", long_p, SamplingParams(temperature=0.0,
                                                                   max_new_tokens=8))
            tasks.append(asyncio.create_task(_drain(hl, outs["long"])))
            if mid_flight is not None:
                while METRICS.get(names[0]) == before[names[0]] and not hl.finished:
                    await asyncio.sleep(0.0005)
                mid_flight(sched, ha)
            await asyncio.gather(*tasks)
            await asyncio.sleep(0.05)  # a last tick books the coexist window
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0 and sorted(sched.free_slots) == [0, 1, 2, 3]
            return outs, {k: METRICS.get(k) - before[k] for k in names}
        finally:
            await sched.stop()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def stepped(models):
    return _run_workload(models, 1)


def test_freerun_streams_byte_identical_and_fewer_dispatches(models, stepped):
    base, win1 = stepped
    fr, win = _run_workload(models, 4)
    assert fr == base and [len(base[k]) for k in ("a", "b", "long")] == [28, 22, 8]
    assert win["finchat_freerun_dispatches_total"] >= 1
    assert win["finchat_coexist_rounds_total"] > 0
    assert win["finchat_coexist_dispatches_total"] / win["finchat_coexist_rounds_total"] < 1
    assert win1["finchat_coexist_dispatches_total"] >= win1["finchat_coexist_rounds_total"] > 0


def test_freerun_mid_run_eos_byte_identical(models, stepped):
    stream = stepped[0]["a"]
    eos = stream[len(stream) // 2]
    base_eos, _w = _run_workload(models, 1, eos_id=eos)
    fr_eos, win = _run_workload(models, 4, eos_id=eos)
    assert len(base_eos["a"]) < len(stream)
    assert win["finchat_freerun_dispatches_total"] >= 1
    assert fr_eos == base_eos


def test_freerun_preempt_mid_capture_exactly_once(models, stepped):
    """A stream preempted while a capture is in flight has its stale ring
    tokens dropped once and replays: every stream equals the host-stepped
    run, no token duplicated or lost, and the epoch break is counted."""
    outs, win = _run_workload(models, 4, mid_flight=lambda s, h: None if h.finished
                              else s._preempt(h))
    assert outs == stepped[0]
    assert win["finchat_preemptions_total"] >= 1
    assert win["finchat_freerun_epoch_breaks_total"] >= 1


def test_freerun_cancel_mid_capture_spares_completions(models):
    """Cancelling the only decode stream mid-capture leaves the ragged
    path with the ring undrained while the long prompt that completed
    inside it is still prefilling: the ring drains before any split
    prefill round, and the long stream equals the host-stepped one."""
    short_a, _b, long_p = _prompts()
    long_p = long_p[: 3 * CHUNK + 2]

    def run(freerun, cancel_after=None):
        sched = _stack(models, freerun, loop_depth=1)

        async def go():
            d0 = METRICS.get("finchat_freerun_dispatches_total")
            errs: list = []
            await sched.start()
            try:
                ha = await sched.submit("a", short_a, SamplingParams(temperature=0.0,
                                                                     max_new_tokens=40))
                outs = {"a": [], "long": []}
                ta = asyncio.create_task(_drain(ha, outs["a"], errs))
                while len(outs["a"]) < 2:
                    await asyncio.sleep(0.002)
                hl = await sched.submit("long", long_p, SamplingParams(temperature=0.0,
                                                                       max_new_tokens=6))
                tl = asyncio.create_task(_drain(hl, outs["long"], errs))
                if cancel_after is not None:
                    while (METRICS.get("finchat_freerun_dispatches_total") - d0 < cancel_after
                           and not hl.finished):
                        await asyncio.sleep(0.0005)
                    sched.cancel(ha)
                await asyncio.gather(ta, tl)
                sched.allocator.check_invariants()
                assert sched.allocator.used_count == 0
                return outs, errs
            finally:
                await sched.stop()

        return asyncio.run(go())

    base, errs = run(1)
    assert not errs
    for trigger in (1, 2):
        outs, errs = run(4, cancel_after=trigger)
        assert not errs and outs["long"] == base["long"], (trigger, outs["long"])


def test_freerun_divergence_anomaly_detected(models):
    """A ring round that emits where the staged plan armed nothing is a
    divergence: counted, and nothing delivered."""
    sched = _stack(models, 2)
    F, R, B = 2, 4, 4
    ring = _InFlightRing(
        tokens=torch.full((F, R), 5, dtype=torch.int32),
        n_emitted=torch.ones((F, R), dtype=torch.int32),
        blocks=torch.full((F, 0, B), -1, dtype=torch.int32),
        rounds=F, members=[], armed=np.zeros((F, R), bool),
        loop_rounds=np.zeros((F, B), bool), completes_at={}, ahead={})
    d0 = METRICS.get("finchat_freerun_divergences_total")
    asyncio.run(sched._consume_ring(ring))
    assert METRICS.get("finchat_freerun_divergences_total") - d0 == 1


def test_freerun_waves_leak_free(models):
    sched = _stack(models, 4)
    rng = np.random.default_rng(5)
    captured = []
    real = sched.engine.ragged_multi

    def counting(*a, **k):
        captured.append(1)
        return real(*a, **k)

    sched.engine.ragged_multi = counting

    async def go():
        await sched.start()
        try:
            for wave in range(3):
                handles, outs = [], []
                for i in range(3):
                    p = rng.integers(1, VOCAB, size=int(rng.integers(6, 2 * CHUNK + 4))).tolist()
                    handles.append(await sched.submit(f"w{wave}-{i}", p, SamplingParams(
                        temperature=0.0, max_new_tokens=int(rng.integers(4, 16)))))
                    outs.append([])
                await asyncio.gather(*[_drain(h, o) for h, o in zip(handles, outs)])
                assert all(outs)
                sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0 and sorted(sched.free_slots) == [0, 1, 2, 3]
        finally:
            await sched.stop()

    asyncio.run(go())
    assert captured  # the waves rode captures
