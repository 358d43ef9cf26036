"""The port's speculative decoding against the JAX package's, on CPU at fp32.

- The proposer: ``NgramIndex`` (pushed token by token) and
  ``propose_ngram_drafts`` give the JAX package's drafts on the same
  seeded histories, the bounded build included. Exact.
- ``verify_step``: emitted tokens, ``n_emitted`` and context lengths equal
  the JAX engine's on the same converted ``tiny`` fp32 weights and the same
  drafts (right, wrong and half-right), and the emitted stream is the
  port's plain greedy stream. Exact: every comparison here is of greedy
  tokens whose JAX top-2 margin is far above the frameworks' 2e-4 logit
  noise (asserted through the JAX engine's position-0 logits).
- ``ragged_mixed_step`` with a spec row (drafts in the packed buffer) and a
  fused loop tail beside a prefill chunk and a plain decode row: the same
  emissions, counts, tail block and context lengths as the JAX engine's.
- The scheduler, within the port: greedy streams with ``spec_tokens`` 3
  equal the plain ones (a repetitive prompt whose drafts are accepted, a
  non-repetitive one that goes through the all-miss demotion and the
  re-probe), a sampled and a constrained slot riding draft-free beside a
  drafting one, and the demotion streak's bookkeeping equal to the JAX
  scheduler's.
"""

import asyncio
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401  (the leak audit)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine import spec as jspec  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.engine import commit_first_token as jax_commit  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine import spec as tspec  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import PageAllocator, pages_needed  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
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

KD = 3
MARGIN = 1e-3
ENGINE = dict(max_seqs=4, page_size=8, num_pages=64, max_seq_len=128, prefill_chunk=8,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0,
              spec_tokens=KD)
PROMPT = [5, 9, 2, 100, 17, 3]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _engines(models, **extra):
    jcfg, jparams, tcfg, tparams = models
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **extra}), attn_backend="ref")
    te = InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **extra}), device="cpu")
    return je, te


def _arm(je, te, slot, prompt, budget):
    """Prefill ``prompt`` into ``slot`` of both engines; both commit the JAX
    engine's first token (teacher forcing). Returns it."""
    pages = list(range(1 + 8 * slot, 1 + 8 * slot + pages_needed(len(prompt) + budget, 8)))
    je.set_page_table_row(slot, pages)
    te.set_page_table_row(slot, pages)
    lj = je.prefill(slot, prompt)
    te.prefill(slot, prompt)
    je.state, tok = jax_commit(je.state, jnp.int32(slot), lj, jnp.float32(0.0),
                               jnp.float32(1.0), jnp.int32(0))
    te.set_last_token(slot, int(tok))
    return int(tok)


def _greedy(B):
    return np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)


# --- the proposer ------------------------------------------------------------------


def test_proposer_and_index_equal_jax():
    cases = [([1, 2, 3, 4, 5, 6, 9, 3, 4], 2, {}), ([1, 2, 3, 7, 7, 2, 3, 8, 1, 2, 3], 1,
                                                     {"ngram": 3}),
             ([1, 2, 3, 4, 5], 4, {}), ([1, 2, 3, 4, 1, 2], 10, {}), ([], 4, {}), ([1, 2], 0, {})]
    for hist, k, kw in cases:
        assert tspec.propose_ngram_drafts(hist, k, **kw) == jspec.propose_ngram_drafts(hist, k,
                                                                                         **kw)
    rng = random.Random(7)
    history = [rng.randrange(6) for _ in range(400)]  # a small alphabet: many repeats
    live_t, live_j = tspec.NgramIndex(), jspec.NgramIndex()
    for i, tok in enumerate(history):
        live_t.push(tok)
        live_j.push(tok)
        assert live_t.propose(4) == live_j.propose(4)
        if i % 17 == 0:
            assert live_t.propose(4) == tspec.propose_ngram_drafts(history[: i + 1], 4)
    ancient = [1, 2, 3, 9, 9, 9] + list(range(4, 9)) * 1000 + [1, 2, 3]
    for cap in (100, 10_000):
        t, j = tspec.NgramIndex(ancient, max_history=cap), jspec.NgramIndex(ancient,
                                                                             max_history=cap)
        assert (len(t._h), t.propose(3)) == (len(j._h), j.propose(3))
    assert tspec.NgramIndex(ancient, max_history=100).propose(3) == []


# --- the verify step -----------------------------------------------------------------


def _port_greedy(models, n_new):
    """The port's plain decode_step greedy stream of PROMPT (the oracle)."""
    _je, te = _engines(models)
    alloc = PageAllocator(te.engine_cfg.num_pages)
    te.set_page_table_row(0, alloc.allocate("r", pages_needed(len(PROMPT) + n_new, 8)))
    out = [int(te.commit_first_token(0, te.prefill(0, PROMPT), 0.0, 1.0, 0))]
    B = te.engine_cfg.max_seqs
    active = np.zeros(B, bool)
    active[0] = True
    while len(out) < n_new:
        out.append(int(te.decode(active, *_greedy(B))[0]))
    return out


@pytest.mark.parametrize("drafting", ["right", "wrong", "half"])
def test_verify_step_matches_jax_and_plain_greedy(models, drafting):
    n_new = 9
    want = _port_greedy(models, n_new)

    def drafts_for(i):
        good = want[i: i + KD]
        if drafting == "wrong":
            return [(t + 1) % 260 for t in good]
        if drafting == "half" and len(good) >= 2:
            return [good[0], (good[1] + 1) % 260, good[0]]
        return good

    je, te = _engines(models)
    out = [_arm(je, te, 0, PROMPT, n_new)]
    B = ENGINE["max_seqs"]
    active = np.zeros(B, bool)
    active[0] = True
    temp, top_p, top_k = _greedy(B)
    steps = 0
    while len(out) < n_new:
        prop = drafts_for(len(out))[: n_new - len(out) - 1]
        drafts = np.zeros((B, KD), np.int32)
        n_drafts = np.zeros(B, np.int32)
        drafts[0, : len(prop)] = prop
        n_drafts[0] = len(prop)
        em_j, n_j, logits_j = je.decode_spec(
            jnp.asarray(active), jnp.asarray(drafts), jnp.asarray(n_drafts), jnp.asarray(temp),
            jnp.asarray(top_p), jnp.asarray(top_k), return_logits=True)
        em_t, n_t = te.decode_spec(active, drafts, n_drafts, temp, top_p, top_k)
        top2 = np.sort(np.asarray(logits_j)[0])[-2:]
        assert top2[1] - top2[0] > MARGIN
        n = int(n_j[0])
        assert int(n_t[0]) == n and 1 <= n <= len(prop) + 1
        assert em_t[0, :n].tolist() == np.asarray(em_j)[0, :n].tolist()
        np.testing.assert_array_equal(te.state.context_lens.numpy(),
                                      np.asarray(je.state.context_lens))
        out.extend(int(t) for t in em_t[0, :n])
        steps += 1
    assert out == want
    expect = {"right": -(-(n_new - 1) // (KD + 1)), "wrong": n_new - 1}
    if drafting in expect:
        assert steps == expect[drafting]


def test_ragged_spec_row_and_loop_tail_match_jax(models):
    """One ragged round at spec width 3 and loop depth 3: a prefill chunk
    (slot 3), a spec row with two right drafts and one wrong (slot 0), a
    decode row with the fused tail (slot 1), a plain decode row (slot 2)."""
    want = _port_greedy(models, 4)
    je, te = _engines(models, decode_loop_depth=3)
    _arm(je, te, 0, PROMPT, 16)
    _arm(je, te, 1, [7, 7, 3, 250], 16)
    _arm(je, te, 2, [40, 41, 42], 16)
    pages3 = list(range(25, 29))
    je.set_page_table_row(3, pages3)
    te.set_page_table_row(3, pages3)
    R = B = ENGINE["max_seqs"]
    chunk = [11, 12, 13, 14, 15, 16, 17, 18]
    drafts = [want[1], want[2], (want[3] + 1) % 260]
    packed = chunk + [0] + drafts + [0, 0]
    tok_row = [0] * 8 + [1] * 4 + [2, 3]
    T = te.ragged_bucket(len(packed))
    packed += [0] * (T - len(packed))
    tok_row += [R] * (T - len(tok_row))
    args = [np.asarray(packed, np.int32), np.asarray(tok_row, np.int32),
            np.asarray([3, 0, 1, 2], np.int32), np.zeros(R, np.int32),
            np.asarray([8, 4, 1, 1], np.int32), np.asarray([False, True, True, True]),
            np.asarray([False, True, True, True])]
    n_drafts = np.asarray([0, 3, 0, 0], np.int32)
    temp, top_p, top_k = _greedy(R)
    loop_active = np.asarray([False, True, False, False])
    em_j, n_j, _lj, blk_j = je.ragged_mixed(
        *[jnp.asarray(a) for a in args], jnp.asarray(n_drafts), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(top_k), jnp.asarray(loop_active),
        *(jnp.asarray(a) for a in _greedy(B)), -1)
    em_t, n_t, _lt, blk_t = te.ragged_mixed(*args, temp, top_p, top_k, n_drafts, loop_active,
                                            *_greedy(B), -1)
    n_j = np.asarray(n_j)
    assert n_t.tolist() == n_j.tolist() == [0, 3, 1, 1]
    for r in range(R):
        assert em_t[r, : n_j[r]].tolist() == np.asarray(em_j)[r, : n_j[r]].tolist()
    assert em_t[1, :3].tolist() == want[1:4]
    np.testing.assert_array_equal(blk_t.numpy(), np.asarray(blk_j))
    assert (blk_t[:, 1] >= 0).all() and (blk_t[:, [0, 2, 3]] == -1).all()
    np.testing.assert_array_equal(te.state.context_lens.numpy(),
                                  np.asarray(je.state.context_lens))
    np.testing.assert_array_equal(te.state.last_tokens.numpy(), np.asarray(je.state.last_tokens))


# --- the scheduler -------------------------------------------------------------------


class _Greedy:
    """A constraint that picks the argmax: the slot needs the host's pick
    every token, so it rides draft-free."""

    def pick(self, logits, temperature, rng, *, remaining, top_p, top_k):
        return int(np.argmax(logits))


def _streams(models, spec_tokens, requests):
    """Run ``requests`` [(prompt, budget, temperature, constraint)] on a
    port scheduler; returns (streams, accepted, demotions)."""
    _j, _jp, tcfg, tparams = models
    cfg = EngineConfig(**{**ENGINE, "spec_tokens": spec_tokens, "num_pages": 128,
                          "prefill_chunk": 16})
    sched = ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, cfg, device="cpu"),
                                        eos_id=-1)
    acc0 = METRICS.get("finchat_spec_tokens_accepted_total")
    dem0 = METRICS.get("finchat_spec_demotions_total")

    async def go():
        await sched.start()
        try:
            handles = [await sched.submit(f"s{i}", prompt, SamplingParams(
                temperature=temp, max_new_tokens=n), constraint=con)
                for i, (prompt, n, temp, con) in enumerate(requests)]
            out = []
            for h in handles:
                toks = []
                while (event := await asyncio.wait_for(h.events.get(), 120))["type"] == "token":
                    toks.append(event["token_id"])
                assert event["type"] == "done", event
                out.append(toks)
            return out
        finally:
            await sched.stop()
            assert sched.allocator.free_count == cfg.num_pages - 1

    out = asyncio.run(go())
    return (out, METRICS.get("finchat_spec_tokens_accepted_total") - acc0,
            METRICS.get("finchat_spec_demotions_total") - dem0)


def test_scheduler_spec_streams_equal_plain_greedy(models):
    tok = ByteTokenizer()
    # on these weights the first stream loops (its drafts get accepted),
    # the second never repeats early (all-miss steps)
    loop_prompt = tok.encode("xyzxyzxyzxyz", add_bos=True)
    flat = tok.encode("abcabcabcabcabcabc", add_bos=True)
    reqs = [(loop_prompt, 40, 0.0, None), (flat, 24, 0.0, None)]
    plain, _a, _d = _streams(models, 0, reqs)
    spec, accepted, _d = _streams(models, KD, reqs)
    assert spec == plain and [len(s) for s in plain] == [40, 24]
    assert accepted > 0
    lone, _a, demotions = _streams(models, KD, [reqs[1]])
    assert lone == plain[1:] and demotions >= 1  # the all-miss path demoted and re-probed


def test_sampled_and_constrained_slots_ride_draft_free(models):
    tok = ByteTokenizer()
    greedy = (tok.encode("xyzxyzxyzxyz", add_bos=True), 24, 0.0, None)
    plain, _a, _d = _streams(models, 0, [greedy])
    mixed, accepted, _d = _streams(models, KD, [greedy, (tok.encode("hi", add_bos=True), 12,
                                                         0.8, None),
                                                (tok.encode("tool", add_bos=True), 12, 0.0,
                                                 _Greedy())])
    assert mixed[0] == plain[0] and [len(s) for s in mixed[1:]] == [12, 12]
    assert accepted > 0


def test_demotion_bookkeeping_equals_jax(models):
    jcfg, jparams, tcfg, tparams = models
    jsched = JaxScheduler(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE),
                                    attn_backend="ref"), eos_id=258)
    tsched = ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, EngineConfig(**ENGINE),
                                                         device="cpu"), eos_id=258)
    assert (tsched.SPEC_MISS_DEMOTE, tsched.SPEC_RETRY_EVERY) == (jsched.SPEC_MISS_DEMOTE,
                                                                  jsched.SPEC_RETRY_EVERY)
    for accepted in [0, 0, 0, 2, 0, 0, 0, 0, 1, 0]:
        jsched._spec_note_step(accepted=accepted)
        tsched._spec_note_step(accepted=accepted)
        assert (tsched._spec_miss_streak, tsched._spec_cooldown) == (
            jsched._spec_miss_streak, jsched._spec_cooldown)
    assert tsched._spec_cooldown == tsched.SPEC_RETRY_EVERY


# --- the feature mix in one ragged round -----------------------------------------------


def _combo(models, side, mixed, seed, recorded=None):
    """The JAX package's combo workload (tests/test_mixed_step.py): spec
    decode and the decode loop on, a grammar-constrained stream, a greedy
    bystander, and a long prompt with a short tail admitted once the spec
    stream has a live proposal. ``side`` is "port" or "jax"; ``recorded``
    collects, per ragged dispatch of the port, which features rode it."""
    jcfg, jparams, tcfg, tparams = models
    chunk = 16
    kw = dict(max_seqs=5, page_size=8, num_pages=256, max_seq_len=128, prefill_chunk=chunk,
              mixed_step=mixed, session_cache=False, spec_tokens=2, decode_loop_depth=3)
    if side == "port":
        from finchat_tpu_torch.agent.constrained import GrammarVocab, TokenConstraint
        sched = ContinuousBatchingScheduler(
            InferenceEngine(tcfg, tparams, EngineConfig(**kw), device="cpu"), eos_id=-1)
        sampling = SamplingParams
    else:
        from finchat_tpu.agent.constrained import GrammarVocab, TokenConstraint
        from finchat_tpu.engine.sampler import SamplingParams as sampling
        sched = JaxScheduler(JaxEngine(jcfg, jparams, JaxEngineConfig(**kw)), eos_id=-1)
    if recorded is not None:
        real = sched.engine.ragged_mixed

        def spy(tokens, tok_row, row_slot, row_start, row_len, row_from_device, row_arm,
                temperature, top_p, top_k, row_n_drafts, loop_active, *rest):
            rl, fd = np.asarray(row_len), np.asarray(row_from_device)
            recorded.append({
                "prefill": bool(((rl > 0) & ~fd).any()),
                "spec": bool((np.asarray(row_n_drafts) > 0).any()),
                "loop": bool(np.asarray(loop_active).any()),
                "constrained": any(h.constraint is not None for h in sched.decoding.values()),
                "short_tail": bool(((rl > 0) & ~fd & (rl < chunk)).any())})
            return real(tokens, tok_row, row_slot, row_start, row_len, row_from_device, row_arm,
                        temperature, top_p, top_k, row_n_drafts, loop_active, *rest)

        sched.engine.ragged_mixed = spy
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 260, size=4).tolist()
    spec_prompt = (base * 5)[:18]
    by_prompt = rng.integers(1, 260, size=9).tolist()
    long_p = rng.integers(1, 260, size=5 * chunk + 3).tolist()

    async def drain(h, out):
        while (ev := await asyncio.wait_for(h.events.get(), 120))["type"] == "token":
            out.append(ev["token_id"])
        assert ev["type"] == "done", ev

    async def go():
        await sched.start()
        try:
            outs = {"spec": [], "by": [], "tool": [], "long": []}
            hs = await sched.submit("spec", spec_prompt, sampling(temperature=0.0,
                                                                  max_new_tokens=64))
            hb = await sched.submit("by", by_prompt, sampling(temperature=0.0, max_new_tokens=56))
            hc = await sched.submit("tool", tok.encode("decide", add_bos=True),
                                    sampling(temperature=0.0, max_new_tokens=40),
                                    constraint=TokenConstraint(GrammarVocab.for_tokenizer(tok)))
            tasks = [asyncio.create_task(drain(h, outs[k]))
                     for h, k in ((hs, "spec"), (hb, "by"), (hc, "tool"))]
            for _ in range(30_000):
                if hs.finished or (sched._spec_cooldown == 0 and hs.ngram_index is not None
                                   and hs.ngram_index.propose(2)):
                    break
                await asyncio.sleep(0.001)
            hl = await sched.submit("long", long_p, sampling(temperature=0.0, max_new_tokens=5))
            tasks.append(asyncio.create_task(drain(hl, outs["long"])))
            await asyncio.gather(*tasks)
            assert sched.allocator.used_count == 0
            return outs
        finally:
            await sched.stop()

    return asyncio.run(go())


@pytest.mark.parametrize("seed", [7, 41])
def test_ragged_combo_byte_identity(models, seed):
    """Spec rows, fused loop tails, a constrained stream and a short-tail
    prefill in one ragged round: the port's streams byte-identical ragged
    against split, with the ragged run carrying the mix, and equal to the
    JAX package's ragged streams on the same weights."""
    split = _combo(models, "port", mixed=False, seed=seed)
    recorded: list[dict] = []
    ragged = _combo(models, "port", mixed=True, seed=seed, recorded=recorded)
    assert ragged == split
    for feature in ("constrained", "loop", "spec"):
        assert any(r["prefill"] and r[feature] for r in recorded), (feature, recorded)
    assert any(r["short_tail"] for r in recorded)
    assert ragged == _combo(models, "jax", mixed=True, seed=seed)
