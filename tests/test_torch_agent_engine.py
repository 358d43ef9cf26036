"""The port's agent over each package's ``EngineGenerator`` on ``mini``
(fp32, the JAX weights converted by ``models/convert.py``), against the JAX
package's: the engine-backed cases of tests/test_torch_agent.py, in a file
of their own so that a test run spreading files over workers runs them
beside the stub cases.

- A Penny turn with both roles on the engine, the decision
  grammar-constrained and greedy; the retrieval overlap's turn with a stub
  tool role, on and off; a turn abandoned by ``aclose()`` or by cancelling
  its consumer (port only).
- Each served stream is held by gate (b) of the numerics contract: at every
  position where the JAX forward's top-2 margin exceeds 1e-3 (under the
  grammar mask for the decision), the port's token is the JAX argmax; the
  two packages' streams are equal up to their first difference, where that
  margin is at most 1e-3.

No wall-clock assertion: the order of what happened is recorded and
asserted on, with the counters.
"""

import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.agent.graph import LLMAgent as JaxAgent  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.generator import EngineGenerator as JaxEngineGenerator  # noqa: E402
from finchat_tpu.engine.generator import StubGenerator as JaxStub  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer  # noqa: E402
from finchat_tpu.utils import faults as jax_faults  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu_torch.agent import LLMAgent  # noqa: E402
from finchat_tpu_torch.agent.constrained import GrammarVocab  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator, StubGenerator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils import faults  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

SYSTEM = "You are Penny."
TOOL = "Decide retrieval."
MARGIN = 1e-3
COUNTERS = ("finchat_tool_launches_total", "finchat_tool_speculative_cancels_total",
            "finchat_tool_fallbacks_total", "finchat_tool_overlap_saved_seconds_count",
            "finchat_partial_holds_total", "finchat_partial_grafts_total",
            "finchat_partial_fallbacks_total")

SIDES = {
    "port": SimpleNamespace(Agent=LLMAgent, Stub=StubGenerator, Sampling=SamplingParams,
                            metrics=METRICS),
    "jax": SimpleNamespace(Agent=JaxAgent, Stub=JaxStub, Sampling=JaxSampling,
                           metrics=JAX_METRICS),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: the suite runs six workers
    on the machine's cores, where each worker's default thread pool would
    oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.disarm_all()
    jax_faults.disarm_all()


def _counters(metrics) -> dict:
    snap = metrics.snapshot()
    return {name: snap.get(name, 0.0) for name in COUNTERS}


def _delta(metrics, before: dict) -> dict:
    now = _counters(metrics)
    return {name: now[name] - v for name, v in before.items()}


async def _events(agent, *args, **kwargs):
    return [e async for e in agent.stream_with_status(*args, **kwargs)]


# --- over the engine: mini, both packages -----------------------------------------

PAGE = 32
MAX_LEN = 512
# a hold outlives a slow CPU's decision decode: the TTL reap (held against
# its own tests) would turn a graft into the serial fallback under load
ENGINE = dict(max_seqs=4, page_size=PAGE, num_pages=4 * (MAX_LEN // PAGE) + 8,
              max_seq_len=MAX_LEN, prefill_chunk=32, session_cache=False,
              partial_hold_ttl_seconds=600.0)
ROWS = ["COFFEE $4.50 on 2026-07-30", "RENT $2000 on 2026-07-01"]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["mini"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _engine_sides(models):
    jcfg, jparams, tcfg, tparams = models

    def port():
        engine = InferenceEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
        sched = ContinuousBatchingScheduler(engine, eos_id=ByteTokenizer().eos_id)
        return sched, EngineGenerator(sched, ByteTokenizer())

    def jax_():
        engine = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), attn_backend="ref")
        sched = JaxScheduler(engine, eos_id=JaxTokenizer().eos_id)
        return sched, JaxEngineGenerator(sched, JaxTokenizer())

    return {"port": SimpleNamespace(**vars(SIDES["port"]), make=port),
            "jax": SimpleNamespace(**vars(SIDES["jax"]), make=jax_)}


def _recording(sched) -> list:
    """Every handle the scheduler is given (holds included: ``submit_partial``
    submits through ``submit``)."""
    handles = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    return handles


def _jax_logits(models, ids: list[int]) -> np.ndarray:
    jcfg, jparams, _tc, _tp = models
    x = jnp.asarray([ids], jnp.int32)
    return np.asarray(jllama.forward_full(jparams, x, jnp.arange(len(ids))[None], config=jcfg,
                                          attn_backend="ref"))[0]


def _grammar_rows(vocab, served, budget, logits):
    """``logits`` (one row a served token) under the mask each token was
    picked from: the grammar's state after the tokens before it, the
    budget's feasibility, EOS where the state accepts."""
    out = np.empty(logits.shape, np.float64)
    state = vocab.dfa.start
    for i, token in enumerate(served):
        allowed, eos_ok, ends = vocab.mask(state)
        feasible = allowed & (vocab._distance_np[ends] <= budget - i - 2)
        if feasible.any() or eos_ok:
            allowed = feasible
        allowed = allowed.copy()
        if eos_ok:
            allowed[vocab.eos_id] = True
        out[i] = np.where(allowed, logits[i].astype(np.float64), -np.inf)
        if token != vocab.eos_id:
            state = vocab.advance(state, token)
    return out


def _gate_b(models, handle, vocab=None) -> int:
    """Gate (b) over one served stream: wherever the JAX forward's top-2
    margin (under the grammar mask with ``vocab``) exceeds 1e-3, the served
    token is the JAX argmax. Returns how many positions were decided."""
    prompt = list(handle.prompt_ids)
    served = list(handle.history[len(prompt):])
    assert served
    logits = _jax_logits(models, prompt + served[:-1])[len(prompt) - 1:]
    if vocab is not None:
        logits = _grammar_rows(vocab, served, handle.sampling.max_new_tokens, logits)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > MARGIN
    want = logits.argmax(-1)
    bad = [i for i in range(len(served)) if decided[i] and want[i] != served[i]]
    assert not bad, (handle.seq_id, bad[:4])
    return int(decided.sum())


def _assert_first_difference_near_tie(models, prompt, got, want, vocab=None, budget=0):
    """The two packages' streams are equal up to their first difference,
    and there the JAX forward's top-2 margin is at most 1e-3."""
    n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return True
    row = _jax_logits(models, prompt + want[:n])[-1:]
    if vocab is not None:
        row = _grammar_rows(vocab, want[: n + 1], budget, np.repeat(row, n + 1, 0))[n:]
    top2 = np.sort(row[0])[-2:]
    assert top2[1] - top2[0] <= MARGIN, (n, got[n], want[n], top2)
    return False


def test_penny_turn_on_the_engine_matches_jax(models):
    """Both roles on each package's ``EngineGenerator`` (mini, fp32): the
    decision decode grammar-constrained and greedy (96 new tokens at most),
    streamed through the parser, then the response (16 greedy tokens).
    The decision leaves the grammar's DFA live and ``parse_tool_decision``
    agrees with the parser's ``finish``; both streams pass gate (b); the
    event streams are equal wherever the tokens are; the scheduler is left
    with no page."""
    vocab = GrammarVocab.for_tokenizer(ByteTokenizer())

    async def run(side):
        sched, gen = side.make()
        handles = _recording(sched)
        calls = []

        async def retriever(args):
            calls.append(dict(args))
            await asyncio.sleep(0.05)
            return list(ROWS)

        await sched.start()
        try:
            agent = side.Agent(
                gen, gen, retriever, SYSTEM, TOOL, today=lambda: "2026-08-03",
                tool_sampling=side.Sampling(temperature=0.0, max_new_tokens=96,
                                            grammar="tool_call"),
                response_sampling=side.Sampling(temperature=0.0, max_new_tokens=16))
            assert agent.metrics is sched.metrics
            events = await _events(agent, "what did I spend on coffee?", "u1",
                                   "Income: 6,200/month.", [], conversation_id="conv-1")
        finally:
            await sched.stop()
        assert sched.allocator.used_count == 0
        sched.allocator.check_invariants()
        return events, handles, calls

    got = {name: asyncio.run(run(side)) for name, side in _engine_sides(models).items()}
    events, handles, calls = got["port"]
    jevents, jhandles, _ = got["jax"]
    tok = ByteTokenizer()
    decision = handles[0]
    text = tok.decode([t for t in decision.history[len(decision.prompt_ids):]
                       if t != tok.eos_id])
    from finchat_tpu_torch.agent.constrained import DEAD
    from finchat_tpu_torch.agent.streamparse import StreamingToolParser
    from finchat_tpu_torch.agent.toolcall import parse_tool_decision

    assert vocab.dfa.step_string(vocab.dfa.start, text) != DEAD, text
    parser = StreamingToolParser()
    parser.feed(text)
    assert parser.finish() == parse_tool_decision(text)
    retrieved = parse_tool_decision(text) is not None
    assert [e["type"] for e in events][-1] == "complete"
    assert ("retrieval_complete" in [e["type"] for e in events]) == retrieved
    assert bool(calls) == retrieved
    # the decision, then the response (its hold at name-commit, when a
    # tool was named and the overlap took it)
    assert _gate_b(models, decision, vocab) > 0
    response = handles[-1]
    assert response.history[len(response.prompt_ids):]
    assert response.grafted == retrieved  # the hold taken at name-commit, grafted
    _gate_b(models, response)
    # across packages: the decision, and the response when the decisions
    # were equal (then its prompt is the same)
    jdecision = jhandles[0]
    same = _assert_first_difference_near_tie(
        models, list(decision.prompt_ids), decision.history[len(decision.prompt_ids):],
        jdecision.history[len(jdecision.prompt_ids):], vocab, 96)
    if same:
        jresponse = jhandles[-1]
        assert list(response.prompt_ids) == list(jresponse.prompt_ids)
        if _assert_first_difference_near_tie(
                models, list(response.prompt_ids), response.history[len(response.prompt_ids):],
                jresponse.history[len(jresponse.prompt_ids):]):
            assert events == jevents


def test_agent_overlap_stream_identical_to_serial(models):
    """A stub tool role, the response on the engine: the greedy response
    with ``retrieval_overlap`` on equals the serial path's byte for byte in
    each package, the overlap run grafted once and the serial run not at
    all, and the port's response passes gate (b) and equals the JAX
    package's up to a near tie."""

    async def run(side, overlap):
        sched, gen = side.make()
        handles = _recording(sched)

        async def retriever(args):
            await asyncio.sleep(0.2)  # the embed + search
            return list(ROWS)

        before = _counters(side.metrics)
        await sched.start()
        try:
            agent = side.Agent(
                side.Stub(default='retrieve_transactions({"search_query": "spending"})'),
                gen, retriever, SYSTEM, TOOL,
                response_sampling=side.Sampling(temperature=0.0, max_new_tokens=8),
                today=lambda: "2026-08-03", retrieval_overlap=overlap)
            events = await _events(agent, "what did I spend?", "u1", "CTX", [])
        finally:
            await sched.stop()
        assert sched.allocator.used_count == 0
        text = "".join(e["content"] for e in events if e["type"] == "response_chunk")
        return text, events, handles, _delta(side.metrics, before)

    got = {}
    for name, side in _engine_sides(models).items():
        on = asyncio.run(run(side, True))
        off = asyncio.run(run(side, False))
        assert on[0] == off[0] and on[0], name  # byte-identical, not empty
        assert on[1] == off[1], name
        assert on[3]["finchat_partial_grafts_total"] == 1, name
        assert on[3]["finchat_partial_holds_total"] == 1, name
        assert off[3]["finchat_partial_grafts_total"] == 0, name
        assert on[2][-1].grafted and len(on[2]) == 1, name
        got[name] = on
    handle, jhandle = got["port"][2][-1], got["jax"][2][-1]
    _gate_b(models, handle)
    assert list(handle.prompt_ids) == list(jhandle.prompt_ids)
    if _assert_first_difference_near_tie(models, list(handle.prompt_ids),
                                         handle.history[len(handle.prompt_ids):],
                                         jhandle.history[len(jhandle.prompt_ids):]):
        assert got["port"][1] == got["jax"][1]


@pytest.mark.parametrize("how", ["aclose", "cancel"])
def test_abandoned_turn_leaves_no_hold_slot_or_page(models, how):
    """A consumer that goes away once the response streams: it closes
    ``stream_with_status`` after the first response chunk (``aclose``), or
    the task iterating it is cancelled once the response has a token, as a
    client disconnect does (``cancel``). The stream's handle is cancelled,
    the grafted hold with it, and the scheduler keeps no slot and no page
    (port only)."""
    side = _engine_sides(models)["port"]

    async def go():
        sched, gen = side.make()
        handles = _recording(sched)

        async def retriever(args):
            await asyncio.sleep(0.05)
            return list(ROWS)

        await sched.start()
        try:
            agent = LLMAgent(
                StubGenerator(default='retrieve_transactions({"search_query": "spending"})'),
                gen, retriever, SYSTEM, TOOL, today=lambda: "2026-08-03",
                response_sampling=SamplingParams(temperature=0.0, max_new_tokens=32))
            stream = agent.stream_with_status("what did I spend?", "u1", "CTX", [])
            seen = []

            async def consume():
                async for event in stream:
                    seen.append(event["type"])
                    if how == "aclose" and event["type"] == "response_chunk":
                        break

            task = asyncio.create_task(consume())
            if how == "cancel":
                while not (handles and handles[-1].generated >= 1):
                    assert not task.done()
                    await asyncio.sleep(0.001)
                task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                assert how == "cancel"
            await stream.aclose()
            for _ in range(200):
                if not sched.prefilling and not sched.decoding and not sched.pending:
                    break
                await asyncio.sleep(0.01)
            assert not sched.prefilling and not sched.decoding and not sched.pending
            assert sched.allocator.used_count == 0
            assert len(sched.free_slots) == ENGINE["max_seqs"]
            sched.allocator.check_invariants()
        finally:
            await sched.stop()
        return seen, handles

    seen, handles = asyncio.run(go())
    assert "retrieval_complete" in seen and "complete" not in seen
    if how == "aclose":
        assert seen[-1] == "response_chunk"
    assert len(handles) == 1 and handles[0].grafted and handles[0].finished
    assert not handles[0].held
