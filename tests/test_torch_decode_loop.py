"""The port's fused decode loop against the JAX package's, on CPU at fp32.

The same converted ``tiny`` fp32 weights serve a JAX engine (reference
attention backend) and the port's engine; the JAX side's ``decode_loop_step``
and single decode steps are the reference.

- Engine level: a K-block equals K single steps of the port exactly
  (the same iteration body at the same shapes), and the JAX package's block
  wherever the JAX top-2 logit margin exceeds 1e-3 (a slot's comparison
  stops at its first near tie: the 2e-4 logit noise between the frameworks
  may flip it, and a block cannot be teacher-forced); the EOS stop mask and
  inactive slots' sentinels and frozen state as the JAX engine leaves them.
- Scheduler level, within the port: streams at depth K byte-identical to
  depth 1 (budget edges demote to single steps), a mid-block EOS and its
  wasted tail, a constrained slot demoted to single steps, and the
  membership-snapshot regression of the JAX package's
  tests/test_decode_loop.py (both dispatches of an iteration from one
  snapshot).

The CUDA graph that serves the block on the card is held against this
eager function in tests/test_torch_cuda.py (``-m cuda``).
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
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import PageAllocator, pages_needed  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler,
    SequenceHandle,
)
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
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

K = 4
MARGIN = 1e-3
ENGINE = dict(max_seqs=4, page_size=8, num_pages=64, max_seq_len=128, prefill_chunk=8,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0)
PROMPTS = {0: [3, 7, 11, 200, 42], 2: [100, 101, 102]}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _jax_engine(models, depth=K):
    jcfg, jparams, _t, _p = models
    return JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, decode_loop_depth=depth),
                     attn_backend="ref")


def _engine(models, depth=K, **extra):
    _j, _jp, tcfg, tparams = models
    return InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **extra},
                                                       decode_loop_depth=depth), device="cpu")


def _arm(eng, n_new, jax_side=False):
    """Prefill PROMPTS into their slots and commit each first token; returns
    {slot: first token}."""
    alloc = PageAllocator(eng.engine_cfg.num_pages)
    first = {}
    for slot, prompt in PROMPTS.items():
        pages = alloc.allocate(f"s{slot}", pages_needed(len(prompt) + n_new, eng.page_size))
        eng.set_page_table_row(slot, pages)
        logits = eng.prefill(slot, prompt)
        if jax_side:
            eng.state, tok = jax_commit(eng.state, jnp.int32(slot), logits, jnp.float32(0.0),
                                        jnp.float32(1.0), jnp.int32(0))
        else:
            tok = eng.commit_first_token(slot, logits, 0.0, 1.0, 0)
        first[slot] = int(tok)
    return first


def _greedy(B):
    return np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)


def _active(B, slots):
    active = np.zeros(B, bool)
    active[list(slots)] = True
    return active


def _jax_steps(models, n_steps):
    """The JAX engine's single greedy steps from PROMPTS: tokens and top-2
    margins, {slot: [(token, margin), ...]}."""
    je = _jax_engine(models, depth=1)
    _arm(je, 3 * K, jax_side=True)
    B = ENGINE["max_seqs"]
    temp, top_p, top_k = (jnp.asarray(a) for a in _greedy(B))
    out = {s: [] for s in PROMPTS}
    for _ in range(n_steps):
        toks, logits = je.decode(jnp.asarray(_active(B, PROMPTS)), temp, top_p, top_k,
                                 return_logits=True)
        toks, logits = np.asarray(toks), np.asarray(logits)
        for s in PROMPTS:
            top2 = np.sort(logits[s])[-2:]
            out[s].append((int(toks[s]), float(top2[1] - top2[0])))
    return out


def test_block_matches_single_steps_and_jax(models):
    """Two K-blocks give exactly the 2K tokens 2K single steps of the port
    give, for two slots at different context lengths, with the same context
    lengths and last tokens after; and the JAX package's decode_loop_step
    tokens up to each slot's first near tie."""
    B = ENGINE["max_seqs"]
    ref = _engine(models, depth=1)
    _arm(ref, 3 * K)
    steps = {s: [] for s in PROMPTS}
    for _ in range(2 * K):
        nxt = ref.decode(_active(B, PROMPTS), *_greedy(B))
        for s in PROMPTS:
            steps[s].append(int(nxt[s]))
    eng = _engine(models)
    _arm(eng, 3 * K)
    blocks = [eng.decode_loop(_active(B, PROMPTS), *_greedy(B), eos_id=-1).numpy()
              for _ in range(2)]
    got = {s: [int(b[i, s]) for b in blocks for i in range(K)] for s in PROMPTS}
    assert got == steps
    assert torch.equal(eng.state.context_lens, ref.state.context_lens)
    assert torch.equal(eng.state.last_tokens, ref.state.last_tokens)

    je = _jax_engine(models)
    _arm(je, 3 * K, jax_side=True)
    temp, top_p, top_k = (jnp.asarray(a) for a in _greedy(B))
    jblocks = [np.asarray(je.decode_loop(jnp.asarray(_active(B, PROMPTS)), temp, top_p, top_k,
                                         eos_id=-1)) for _ in range(2)]
    margins = _jax_steps(models, 2 * K)
    compared = 0
    for s in PROMPTS:
        want = [int(b[i, s]) for b in jblocks for i in range(K)]
        for i, (tok, margin) in enumerate(margins[s]):
            assert tok == want[i]  # the JAX block is its own single steps
            if margin <= MARGIN:
                break
            assert got[s][i] == want[i], (s, i)
            compared += 1
    assert compared >= K


def test_eos_stop_mask_and_inactive_sentinels(models):
    """A slot that samples the stop token mid-block has it recorded, then
    emits -1 with its context frozen; an inactive slot emits -1 throughout
    and keeps its context, last token and pages; both as the JAX engine."""
    B = ENGINE["max_seqs"]
    probe = _engine(models)
    first = _arm(probe, 3 * K)
    stream = probe.decode_loop(_active(B, [0]), *_greedy(B), eos_id=-1).numpy()[:, 0]
    eos = int(stream[1])
    assert eos not in stream[:1].tolist()

    eng = _engine(models)
    _arm(eng, 3 * K)
    ctx0 = eng.state.context_lens.clone()
    pages2 = eng.state.page_table[2].long()
    pages2 = pages2[pages2 > 0]  # the row's own pages (0 is the trash page)
    kv2 = eng.state.k_pages[:, pages2].clone()
    block = eng.decode_loop(_active(B, [0]), *_greedy(B), eos_id=eos).numpy()
    assert block[:2, 0].tolist() == stream[:2].tolist()
    assert (block[2:, 0] == -1).all() and (block[:, 1:] == -1).all()
    assert int(eng.state.context_lens[0]) == int(ctx0[0]) + 2
    assert int(eng.state.context_lens[2]) == int(ctx0[2])
    assert int(eng.state.last_tokens[0]) == eos
    assert int(eng.state.last_tokens[2]) == first[2]
    assert torch.equal(eng.state.k_pages[:, pages2], kv2)

    je = _jax_engine(models)
    _arm(je, 3 * K, jax_side=True)
    jblock = np.asarray(je.decode_loop(jnp.asarray(_active(B, [0])),
                                       *(jnp.asarray(a) for a in _greedy(B)), eos_id=eos))
    margins = _jax_steps(models, 2)[0]
    if all(m > MARGIN for _t, m in margins):
        np.testing.assert_array_equal(block, jblock)
        np.testing.assert_array_equal(eng.state.context_lens.numpy(),
                                      np.asarray(je.state.context_lens))


# --- the scheduler -----------------------------------------------------------------


def _stack(models, depth, eos_id=-1, **extra):
    eng = _engine(models, depth=depth, num_pages=128, prefill_chunk=16, **extra)
    return ContinuousBatchingScheduler(eng, eos_id=eos_id)


async def _collect(sched, budgets, constraint=None):
    tok = ByteTokenizer()
    handles = []
    for i, n in enumerate(budgets):
        handles.append(await sched.submit(
            f"s{i}", tok.encode(f"prompt {i}", add_bos=True),
            SamplingParams(temperature=0.0, max_new_tokens=n),
            constraint=constraint(i) if constraint else None))
    streams = []
    for h in handles:
        toks = []
        while True:
            event = await asyncio.wait_for(h.events.get(), timeout=120)
            if event["type"] == "token":
                toks.append(event["token_id"])
            elif event["type"] == "done":
                break
            else:
                raise AssertionError(event)
        streams.append(toks)
    return streams


def _run(models, depth, budgets, eos_id=-1, constraint=None, spy=None):
    async def go():
        sched = _stack(models, depth, eos_id=eos_id)
        if spy is not None:
            spy(sched)
        await sched.start()
        try:
            return await _collect(sched, budgets, constraint)
        finally:
            await sched.stop()
            assert not sched.decoding and not sched.prefilling
            assert sched.allocator.free_count == sched.engine.engine_cfg.num_pages - 1

    return asyncio.run(go())


@pytest.fixture(scope="module")
def depth1_streams(models):
    """Greedy streams at depth 1 with budgets at the block's edges: 3 < K
    never rides a block, 7 and 13 end on single steps."""
    return _run(models, 1, [3, 7, 13])


def test_scheduler_streams_identical_to_single_step(models, depth1_streams):
    blocks = []

    def spy(sched):
        real = sched.engine.decode_loop

        def counting(active, *a, **k):
            blocks.append(int(np.sum(active)))
            return real(active, *a, **k)

        sched.engine.decode_loop = counting

    streams = _run(models, K, [3, 7, 13], spy=spy)
    assert [len(s) for s in depth1_streams] == [3, 7, 13]
    assert streams == depth1_streams
    assert blocks and max(blocks) >= 2


def test_eos_mid_block_matches_single_step_and_counts_waste(models, depth1_streams):
    eos = depth1_streams[2][K + 1]  # mid-block: the rest of the block is free-run waste
    # a stream ends at the stop token, which is not delivered as a token
    want = [s[: s.index(eos)] if eos in s else s for s in depth1_streams]
    before = METRICS.get("finchat_decode_loop_wasted_tail_tokens_total")
    assert _run(models, K, [3, 7, 13], eos_id=eos) == want
    assert METRICS.get("finchat_decode_loop_wasted_tail_tokens_total") > before


class _Greedy:
    """A constraint that picks the argmax (the grammar plane's interface, no
    grammar): the slot's stream is the greedy one, but it needs the host's
    pick every token, so it must never ride a block."""

    def pick(self, logits, temperature, rng, *, remaining, top_p, top_k):
        return int(np.argmax(logits))


def test_constrained_slot_demoted_to_single_step(models, depth1_streams):
    seen = []

    def spy(sched):
        real = sched.engine.decode_loop

        def recording(active, *a, **k):
            for slot, h in sched.decoding.items():
                seen.append((h.seq_id, bool(active[slot])))
            return real(active, *a, **k)

        sched.engine.decode_loop = recording

    streams = _run(models, K, [3, 7, 13], constraint=lambda i: _Greedy() if i == 2 else None,
                   spy=spy)
    assert streams == depth1_streams
    assert not any(on for seq, on in seen if seq == "s2")
    assert any(on for seq, on in seen if seq == "s1")


def test_demoted_step_pinned_to_membership_snapshot(models):
    """Both dispatches of a loop iteration come from one membership
    snapshot: a slot vacated and filled again between the block and the
    demoted step is not swept into the step (the JAX package's regression,
    tests/test_decode_loop.py)."""
    sched = _stack(models, K)
    samp = SamplingParams(temperature=0.0, max_new_tokens=64)
    hA = SequenceHandle(seq_id="A", prompt_ids=[1, 2, 3], sampling=samp, owner=sched)
    hB = SequenceHandle(seq_id="B", prompt_ids=[4, 5], sampling=samp, owner=sched)
    hC = SequenceHandle(seq_id="C", prompt_ids=[6], sampling=samp, owner=sched)
    hA.slot, hB.slot = 0, 1
    hB.generated = 62  # 2 tokens of budget left < K: demoted to a single step
    sched.decoding = {0: hA, 1: hB}
    sched.free_slots.remove(0)
    sched.free_slots.remove(1)
    real_loop = sched.engine.decode_loop

    def hijack(*args, **kwargs):
        block = real_loop(*args, **kwargs)
        # a fault handler between the two dispatches: B evicted, its slot
        # taken at once by another handle
        sched._evict(hB, "error", error="injected mid-iteration fault")
        hC.slot = 1
        sched.free_slots.remove(1)
        sched.decoding[1] = hC
        return block

    sched.engine.decode_loop = hijack
    blk = sched._dispatch_decode_loop()
    assert [h.seq_id for _s, h, _e in blk.block_members] == ["A"]
    assert [h.seq_id for _s, h, _e in blk.step.members] == ["B"]
    asyncio.run(sched._consume_block(blk))
    assert hC.generated == 0 and hC.events.empty()
    assert hA.generated == K


def test_warmup_counts_the_planes_variants_as_jax(models):
    """With spec decode, the loop and free-run on, ``warmup()`` runs the JAX
    engine's variants (the ragged buckets at the spec width and loop depth,
    the multi-round a bucket, the block, both verify variants) and counts
    them the same; it leaves every page but the trash page zero and every
    context at 0."""
    jcfg, jparams, tcfg, tparams = models
    planes = dict(ENGINE, prefill_chunk=16, spec_tokens=2, decode_loop_depth=2,
                  freerun_rounds=2)
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**planes), attn_backend="ref")
    te = InferenceEngine(tcfg, tparams, EngineConfig(**planes), device="cpu")
    je.warmup()
    te.warmup()
    assert te.compiled_variants == je.compiled_variants == 11
    assert not te.state.k_pages[:, 1:].any() and not te.state.v_pages[:, 1:].any()
    assert not te.state.context_lens.any()


# --- what the schedulers dispatch between a submit and its first token --------

MINI_ENGINE = dict(max_seqs=4, page_size=16, num_pages=64, max_seq_len=512, prefill_chunk=32,
                   prefix_cache=False, session_cache=False, preemption=False,
                   breaker_threshold=0, decode_loop_depth=K)


@pytest.fixture(scope="module")
def mini_models():
    jcfg = dataclasses.replace(jllama.PRESETS["mini"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _second_wave_dispatches(models, side: str, bounded: bool) -> list:
    """Two streams decode in loop-4 blocks; once the third block has been
    dispatched a second wave (a 70-token prompt) is submitted from a task of
    its own, as a client's request arrives. Returns every dispatch from that
    submit to the wave's first token as (kind, sorted row modes), with the
    submit and the first token marked where they fell."""
    from finchat_tpu.engine.sampler import SamplingParams as JaxSampling
    from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler
    from finchat_tpu.utils.tracing import TRACER as JAX_TRACER
    from finchat_tpu_torch.utils.tracing import TRACER

    jcfg, jparams, tcfg, tparams = models
    extra = dict(kv_sink_pages=1, kv_window_pages=4) if bounded else {}
    if side == "jax":
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**MINI_ENGINE, **extra), attn_backend="ref")
        sched, sampling, tracer = JaxScheduler(eng, eos_id=-1), JaxSampling, JAX_TRACER
    else:
        eng = InferenceEngine(tcfg, tparams, EngineConfig(**MINI_ENGINE, **extra), device="cpu")
        sched, sampling = ContinuousBatchingScheduler(eng, eos_id=-1), SamplingParams
        tracer = TRACER
    tracer.configure(enabled=True)
    rng = np.random.default_rng(5)
    wave1 = [rng.integers(1, 255, size=40).tolist() for _ in range(2)]
    wave2 = rng.integers(1, 255, size=70).tolist()
    log: list = []
    state = {"blocks": 0, "task": None, "submitted": False, "first": False}
    trace_dispatch, deliver, submit = sched._trace_dispatch, sched._deliver, sched.submit

    async def submit_wave2():
        state["handle"] = await submit("w2", wave2, sampling(temperature=0.0, max_new_tokens=4))
        state["submitted"] = True
        log.append(("submit",))

    def traced(kind, rows, **kw):
        if state["submitted"] and not state["first"]:
            log.append((kind, tuple(sorted(r[2] for r in rows))))
        if kind == "decode_loop":
            state["blocks"] += 1
            if state["blocks"] == 3:
                state["task"] = asyncio.get_running_loop().create_task(submit_wave2())
        return trace_dispatch(kind, rows, **kw)

    def delivering(handle, token_id):
        if handle.seq_id == "w2" and handle.generated == 0:
            state["first"] = True
            log.append(("first_token",))
        return deliver(handle, token_id)

    sched._trace_dispatch, sched._deliver = traced, delivering

    async def go():
        handles = [await sched.submit(f"w1-{i}", p, sampling(temperature=0.0, max_new_tokens=56))
                   for i, p in enumerate(wave1)]
        await sched.start()
        try:
            for h in handles:
                while not h.finished:
                    await asyncio.wait_for(h.events.get(), timeout=300)
            while "handle" not in state or not state["handle"].finished:
                await asyncio.sleep(0.01)
        finally:
            await sched.stop()
        assert sched.allocator.used_count == 0
        return [h.kv_gap for h in handles]

    gaps = asyncio.run(go())
    assert all(g > 0 for g in gaps) == bounded, gaps
    return log


@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded", "bounded"])
def test_second_wave_dispatches_equal_jax(mini_models, bounded):
    """The TTFT behind a decode-loop block: from a submit that lands while
    loop-4 blocks stream to that request's first token, the port's scheduler
    makes the JAX scheduler's dispatches, kind for kind and row for row, with
    bounded KV off and on (mini, fp32). The wait is the plane's own: the
    block in flight drains, then the prompt's chunks ride ragged rounds."""
    got = _second_wave_dispatches(mini_models, "port", bounded)
    want = _second_wave_dispatches(mini_models, "jax", bounded)
    assert got == want
    assert got[0] == ("submit",) and got[-1] == ("first_token",)
    kinds = [entry[0] for entry in got[1:-1]]
    assert kinds and "ragged" in kinds
