"""The port's grammar-constrained decoding against the JAX package's.

Host side, held against tests/test_constrained.py (its accept and reject
texts are the parametrised cases): the DFA's verdicts, ``GrammarVocab``'s
masks and end states for ``ByteTokenizer`` and a SentencePiece-style fake,
and ``TokenConstraint.pick`` sequences for the same logits and numpy seed
at temperature 0 and 0.7 with top-p and top-k, all equal.

Engine side, on CPU at fp32 with the converted ``tiny`` weights in both
packages (the JAX engine on its reference attention): a sampled generation
through the port's generator is grammatical and parsable, and greedy
constrained streams through both schedulers are equal teacher-forced (equal
up to their first difference, where the JAX forward's top-2 margin under
the grammar mask is within 1e-3) on every path a constrained row takes: the
prefill round, the packed ragged round (a constrained completion and
constrained decode rows), the depth-2 pipelined decode where the slot sits
out the step dispatched before its pick, and the depth-1 branch when every
decoding slot waits on a pick.

Port only: the host pick lands in the ``last_tokens`` tensor the slot's
next dispatch reads.
"""

import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.agent import constrained as jcon  # noqa: E402
from finchat_tpu.agent.toolcall import parse_tool_decision as jax_parse  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.tracing import TRACER as JAX_TRACER  # noqa: E402
from finchat_tpu_torch.agent import constrained as tcon  # noqa: E402
from finchat_tpu_torch.agent.toolcall import parse_tool_decision  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.tracing import TRACER  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
ENGINE = dict(max_seqs=4, page_size=8, num_pages=96, max_seq_len=160, prefill_chunk=16,
              session_cache=False)

ACCEPT = [
    "No tool call",
    'retrieve_transactions({"search_query": "grocery store purchases", "num_transactions": 20})',
    'retrieve_transactions({"search_query": "all purchases", "time_period_days": 2})',
    "retrieve_transactions({})",
    'retrieve_transactions({"num_transactions": 100})',
    'retrieve_transactions({ "search_query" : "coffee" , "num_transactions" : 5 })',
    "  No tool call",
    'create_financial_plot({"chart_type": "bar", "title": "Spending This Month", '
    '"search_query": "all purchases", "time_period_days": 30})',
    'create_financial_plot({"chart_type": "pie"})',
    "create_financial_plot({})",
]
REJECT = [
    "Hello! I'm here to help",
    "no tool call",
    "retrieve_transactions(",
    'retrieve_transactions({"user_id": "u1"})',
    'retrieve_transactions({"search_query": 5})',
    'retrieve_transactions({"num_transactions": "many"})',
    "retrieve_transactions({}) extra",
    "make_coffee({})",
    'create_financial_plot({"chart_type": "donut"})',
    'create_financial_plot({"chart_type": bar})',
    'retrieve_transactions({"search_query": "food} 2024"})',
    "retrieve_transactions({\t\t\t})",
]


@pytest.fixture(scope="module")
def dfas():
    return tcon.build_tool_grammar(), jcon.build_tool_grammar()


@pytest.fixture(scope="module")
def byte_vocabs():
    return (tcon.GrammarVocab.for_tokenizer(ByteTokenizer()),
            jcon.GrammarVocab.for_tokenizer(JaxTokenizer()))


def _states(dfa, text):
    """The DFA's state after every prefix of ``text``."""
    out, state = [], dfa.start
    for ch in text:
        state = dfa.step(state, ch)
        out.append(state)
    return out


# --- the DFA --------------------------------------------------------------

@pytest.mark.parametrize("text", ACCEPT + REJECT)
def test_dfa_verdicts_match_jax(dfas, text):
    tdfa, jdfa = dfas
    assert _states(tdfa, text) == _states(jdfa, text)
    t_end, j_end = tdfa.step_string(tdfa.start, text), jdfa.step_string(jdfa.start, text)
    accepts = t_end != tcon.DEAD and tdfa.eos_ok[t_end]
    assert accepts == (j_end != jcon.DEAD and jdfa.eos_ok[j_end])
    assert accepts == (text in ACCEPT)


def test_dfa_structure_matches_jax(dfas):
    tdfa, jdfa = dfas
    assert tdfa.edges == jdfa.edges and tdfa.eos_ok == jdfa.eos_ok
    assert [[dst for _p, dst in c] for c in tdfa.classes] == \
        [[dst for _p, dst in c] for c in jdfa.classes]
    assert tcon._distance_to_accept(tdfa) == jcon._distance_to_accept(jdfa)


# --- masks ------------------------------------------------------------------

def _assert_masks_equal(tv, jv, state):
    t_allowed, t_eos, t_ends = tv.mask(state)
    j_allowed, j_eos, j_ends = jv.mask(state)
    np.testing.assert_array_equal(t_allowed, j_allowed)
    np.testing.assert_array_equal(t_ends, j_ends)
    assert t_eos == j_eos


@pytest.mark.parametrize("text", ACCEPT)
def test_byte_vocab_masks_match_jax_along_each_text(byte_vocabs, text):
    tv, jv = byte_vocabs
    assert tv.token_strs == jv.token_strs and tv.eos_id == jv.eos_id
    t_state = j_state = tv.dfa.start
    _assert_masks_equal(tv, jv, t_state)
    for b in text.encode():
        t_state, j_state = tv.advance(t_state, b), jv.advance(j_state, b)
        assert t_state == j_state
        _assert_masks_equal(tv, jv, t_state)
    _assert_masks_equal(tv, jv, tcon.DEAD)


class _FakeSPInner:
    all_special_ids = [0]
    PIECES = ["<s>", "▁No", "▁tool", "call", "<0x7B>", "to", "retrieve", "_transactions", "(",
              "{\"", "search", "_query", "\":", "▁\"", "coffee", "\"}", ")", "▁call", "<0xZZ>",
              "create_financial_plot", "chart_type", "pie", "▁", "12", "}", ","]

    def convert_ids_to_tokens(self, ids):
        return [self.PIECES[i] for i in ids]


class _FakeSPTokenizer:
    """A SentencePiece-style tokenizer: single-token decode strips the
    leading-space marker (the trap ``token_texts`` avoids)."""

    vocab_size = len(_FakeSPInner.PIECES)
    eos_id = 0
    _tok = _FakeSPInner()

    def decode(self, ids):
        return "".join("" if i == 0 else _FakeSPInner.PIECES[i].replace("▁", "") for i in ids)


def test_sentencepiece_token_texts_and_masks_match_jax():
    tok = _FakeSPTokenizer()
    texts = tcon.token_texts(tok)
    assert texts == jcon.token_texts(tok)
    assert texts[:6] == ["", " No", " tool", "call", "{", "to"]
    tv = tcon.GrammarVocab(tcon.build_tool_grammar(), texts, tok.eos_id)
    jv = jcon.GrammarVocab(jcon.build_tool_grammar(), texts, tok.eos_id)
    # walk the vocab greedily along two accepted outputs, masks equal at every state
    for path in ([1, 2, 17], [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]):
        t_state = j_state = tv.dfa.start
        for token in path:
            _assert_masks_equal(tv, jv, t_state)
            assert tv.mask(t_state)[0][token], (token, texts[token])
            t_state, j_state = tv.advance(t_state, token), jv.advance(j_state, token)
            assert t_state == j_state
        _assert_masks_equal(tv, jv, t_state)
        assert tv.dfa.eos_ok[t_state]


# --- picks ------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_p,top_k,budget", [
    (0.0, 1.0, 0, None), (0.0, 1.0, 0, 48), (0.7, 1.0, 0, 96), (0.7, 0.9, 0, 96),
    (0.7, 1.0, 20, 64), (0.7, 0.8, 12, 40), (1.0, 0.95, 5, None),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_sequences_match_jax(byte_vocabs, temperature, top_p, top_k, budget, seed):
    tv, jv = byte_vocabs
    tc, jc = tcon.TokenConstraint(tv), jcon.TokenConstraint(jv)
    t_rng, j_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    logit_rng = np.random.default_rng(100 + seed)
    t_out, j_out = [], []
    for step in range(budget or 96):
        logits = np.asarray(logit_rng.normal(size=(len(tv.token_strs),)) * 3, np.float32)
        remaining = None if budget is None else budget - step
        t = tc.pick(logits, temperature, t_rng, remaining=remaining, top_p=top_p, top_k=top_k)
        j = jc.pick(logits, temperature, j_rng, remaining=remaining, top_p=top_p, top_k=top_k)
        t_out.append(t)
        j_out.append(j)
        assert tc.state == jc.state
        if t == tv.eos_id or j == jv.eos_id:
            break
    assert t_out == j_out
    text = ByteTokenizer().decode([t for t in t_out if t != tv.eos_id])
    assert tv.dfa.step_string(tv.dfa.start, text) != tcon.DEAD
    assert _as_tuple(parse_tool_decision(text)) == _as_tuple(jax_parse(text))


def _as_tuple(call):
    return None if call is None else (call.name, call.args)


# --- through the engine -----------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _sides(models):
    jcfg, jparams, tcfg, tparams = models
    t_vocab = tcon.GrammarVocab.for_tokenizer(ByteTokenizer())
    j_vocab = jcon.GrammarVocab.for_tokenizer(JaxTokenizer())

    def port(**over):
        engine = InferenceEngine(tcfg, tparams, EngineConfig(**dict(ENGINE, **over)),
                                 device="cpu")
        return ContinuousBatchingScheduler(engine, eos_id=ByteTokenizer().eos_id)

    def jax_(**over):
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**dict(ENGINE, **over)), attn_backend="ref")
        return JaxScheduler(eng, eos_id=JaxTokenizer().eos_id)

    return {
        "port": SimpleNamespace(make=port, tracer=TRACER, vocab=t_vocab,
                                constraint=lambda: tcon.TokenConstraint(t_vocab),
                                greedy=lambda n: SamplingParams(temperature=0.0, max_new_tokens=n)),
        "jax": SimpleNamespace(make=jax_, tracer=JAX_TRACER, vocab=j_vocab,
                               constraint=lambda: jcon.TokenConstraint(j_vocab),
                               greedy=lambda n: JaxSampling(temperature=0.0, max_new_tokens=n)),
    }


async def _drain(handle):
    tokens = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=120)
        if event["type"] == "token":
            tokens.append(event["token_id"])
        elif event["type"] == "done":
            return tokens
        else:
            raise AssertionError(event)


def _masked_logits(vocab, prefix_tokens, logits, remaining):
    """The JAX forward's logits under the pick's mask after ``prefix_tokens``
    (the grammar state they lead to, the budget's feasibility, EOS where
    the state accepts)."""
    state = vocab.dfa.start
    for t in prefix_tokens:
        if t != vocab.eos_id:
            state = vocab.advance(state, t)
    allowed, eos_ok, ends = vocab.mask(state)
    feasible = allowed & (vocab._distance_np[ends] <= remaining - 2)
    if feasible.any() or eos_ok:
        allowed = feasible
    allowed = allowed.copy()
    if eos_ok:
        allowed[vocab.eos_id] = True
    return np.where(allowed, logits.astype(np.float64), -np.inf)


def _assert_teacher_forced(models, prompt, got, want, budget, vocab):
    """The port's constrained greedy stream equals the JAX one up to their
    first difference, and there the JAX forward's top-2 margin under the
    grammar mask is a near tie."""
    jcfg, jparams, _tc, _tp = models
    assert got and want
    n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return
    ids = jnp.asarray([prompt + want[:n]], jnp.int32)
    logits = np.asarray(jllama.forward_full(jparams, ids, jnp.arange(ids.shape[1])[None],
                                            config=jcfg, attn_backend="ref"))[0, -1]
    masked = _masked_logits(vocab, want[:n], logits, budget - n)
    top2 = np.sort(masked)[-2:]
    assert top2[1] - top2[0] <= MARGIN, (n, got[n], want[n], top2)


def _assert_grammatical(vocab, tokens):
    text = ByteTokenizer().decode([t for t in tokens if t != vocab.eos_id])
    assert vocab.dfa.step_string(vocab.dfa.start, text) != tcon.DEAD, text
    parse_tool_decision(text)  # never raises
    return text


PROMPTS = {
    "c0": list(range(1, 20)),
    "c1": list(range(30, 52)),
    "p1": list(range(60, 90)),
    "c2": list(range(100, 110)),
    "p2": list(range(120, 184)),  # four chunks: ragged rounds beside c1's decode
}
BUDGET = {"c0": 40, "c1": 40, "p1": 48, "c2": 32, "p2": 8}


def _rows(tracer, kind):
    return [[(r[1], r[2]) for r in ev[5]["rows"]] for ev in tracer.snapshot()
            if ev[2] == "dispatch" and ev[5]["kind"] == kind]


def test_constrained_streams_match_jax_on_every_path(models):
    """c0 alone (the prefill round and the depth-1 branch); then c1 and p1
    decode together (the depth-2 decode with c1 sitting out), p2's chunks
    ride ragged rounds beside c1's constrained decode rows, and c2 completes
    its prompt inside a ragged round."""

    async def run(side):
        side.tracer.configure(enabled=True)
        side.tracer.clear()
        sched = side.make()
        await sched.start()
        try:
            c0 = await sched.submit("c0", PROMPTS["c0"], side.greedy(BUDGET["c0"]),
                                    constraint=side.constraint(), trace_id="c0")
            out = {"c0": await _drain(c0)}
            c1 = await sched.submit("c1", PROMPTS["c1"], side.greedy(BUDGET["c1"]),
                                    constraint=side.constraint(), trace_id="c1")
            p1 = await sched.submit("p1", PROMPTS["p1"], side.greedy(BUDGET["p1"]),
                                    trace_id="p1")
            tasks = {"c1": asyncio.create_task(_drain(c1)), "p1": asyncio.create_task(_drain(p1))}
            while c1.generated < 3 and not c1.finished:
                await asyncio.sleep(0.001)
            c2 = await sched.submit("c2", PROMPTS["c2"], side.greedy(BUDGET["c2"]),
                                    constraint=side.constraint(), trace_id="c2")
            p2 = await sched.submit("p2", PROMPTS["p2"], side.greedy(BUDGET["p2"]),
                                    trace_id="p2")
            tasks.update(c2=asyncio.create_task(_drain(c2)), p2=asyncio.create_task(_drain(p2)))
            for name, task in tasks.items():
                out[name] = await task
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0
        finally:
            await sched.stop()
        return out, {k: _rows(side.tracer, k) for k in ("prefill", "ragged", "decode")}

    results = {}
    for name, side in _sides(models).items():
        results[name] = asyncio.run(run(side))
    vocab = _sides(models)["port"].vocab
    for name, (out, rows) in results.items():
        for rid in ("c0", "c1", "c2"):
            _assert_grammatical(vocab, out[rid])
        # every path was taken, in both packages
        assert any(("c0", "prefill") in r for r in rows["prefill"]), name
        assert any(("c1", "constrained") in r for r in rows["ragged"]), name
        assert any(("c2", "prefill") in r for r in rows["ragged"]), name
        assert not any(("c2", "prefill") in r for r in rows["prefill"]), name
        sat_out = [r for r in rows["decode"] if ("p1", "decode") in r
                   and ("c1", "decode") not in r]
        assert sat_out, name  # c1 sat out a step while its pick was pending
    tout, jout = results["port"][0], results["jax"][0]
    for rid, prompt in PROMPTS.items():
        if rid.startswith("c"):
            _assert_teacher_forced(models, prompt, tout[rid], jout[rid], BUDGET[rid], vocab)
    TRACER.clear()
    JAX_TRACER.clear()


def test_engine_sampled_constrained_generation_is_grammatical(models):
    """A random-weight model through the port's generator at temperature
    0.7 produces grammatical, parsable tool decisions: the structure comes
    from the constraint alone (tests/test_constrained.py's end-to-end
    case)."""
    side = _sides(models)["port"]

    async def go():
        sched = side.make(max_seqs=2)
        gen = EngineGenerator(sched, ByteTokenizer())
        await sched.start()
        try:
            texts = await asyncio.gather(*[gen.generate(
                f"User {i}: What did I spend on coffee?",
                SamplingParams(temperature=0.7, max_new_tokens=96, grammar="tool_call"))
                for i in range(3)])
        finally:
            await sched.stop()
        return texts, len(gen._grammar_vocabs)

    texts, n_builds = asyncio.run(go())
    assert n_builds == 1  # one single-flight build for the three requests
    dfa = tcon.build_tool_grammar()
    for text in texts:
        assert dfa.step_string(dfa.start, text) != tcon.DEAD, text
        parse_tool_decision(text)


def test_grammar_without_constraint_is_served_and_unknown_grammar_raises(models):
    """The scheduler no longer refuses ``sampling.grammar``: with no
    constraint it serves the request unconstrained, as the JAX scheduler
    does; the generator refuses a grammar it does not know."""
    side = _sides(models)["port"]

    async def go():
        sched = side.make()
        await sched.start()
        try:
            h = await sched.submit("g", PROMPTS["c0"], SamplingParams(
                temperature=0.0, max_new_tokens=6, grammar="tool_call"))
            tokens = await _drain(h)
            plain = await _drain(await sched.submit("p", PROMPTS["c0"], side.greedy(6)))
            with pytest.raises(ValueError, match="unknown grammar"):
                await EngineGenerator(sched, ByteTokenizer()).generate(
                    "x", SamplingParams(max_new_tokens=4, grammar="sql"))
        finally:
            await sched.stop()
        return tokens, plain

    tokens, plain = asyncio.run(go())
    assert tokens == plain


# --- port only --------------------------------------------------------------

def test_host_pick_lands_in_the_tensor_the_next_dispatch_reads(models):
    """At every dispatch that carries a constrained slot (a decode step or a
    ragged round's decode row), the slot's input in ``state.last_tokens`` is
    its last delivered token, the host pick, and not the token the device
    sampled without the grammar. A pick written into the tensor of the step
    before (which the next step rebinds) is lost without an error; this
    fails then."""
    side = _sides(models)["port"]
    checked = []

    async def go():
        sched = side.make()
        eng = sched.engine
        decode, ragged = eng.decode, eng.ragged_mixed

        def check(slots):
            for slot in slots:
                h = sched.decoding.get(slot)
                if h is not None and h.constraint is not None:
                    checked.append((int(eng.state.last_tokens[slot]), h.history[-1]))

        def checking_decode(active, *a, **k):
            check([s for s in range(len(active)) if active[s]])
            return decode(active, *a, **k)

        def checking_ragged(tokens, tok_row, row_slot, row_start, row_len, row_from_device,
                            *rest):
            check([int(s) for s, d, n in zip(row_slot, row_from_device, row_len) if d and n])
            return ragged(tokens, tok_row, row_slot, row_start, row_len, row_from_device, *rest)

        eng.decode, eng.ragged_mixed = checking_decode, checking_ragged
        await sched.start()
        try:
            c1 = await sched.submit("c1", PROMPTS["c1"], side.greedy(BUDGET["c1"]),
                                    constraint=side.constraint())
            p1 = await sched.submit("p1", PROMPTS["p1"], side.greedy(BUDGET["p1"]))
            t1, t2 = asyncio.create_task(_drain(c1)), asyncio.create_task(_drain(p1))
            while c1.generated < 3 and not c1.finished:
                await asyncio.sleep(0.001)
            p2 = await sched.submit("p2", PROMPTS["p2"], side.greedy(BUDGET["p2"]))
            await asyncio.gather(t1, t2, _drain(p2))
        finally:
            await sched.stop()

    asyncio.run(go())
    assert len(checked) >= 8
    assert all(dev == host for dev, host in checked), checked
