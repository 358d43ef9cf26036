"""The port's agent (``agent/graph.py``) against the JAX package's, over the
cases of tests/test_agent.py, tests/test_tool_streaming.py,
tests/test_windowing.py, the agent cases of tests/test_faults.py,
tests/test_tracing.py and tests/test_prefix_cache.py, and
tests/test_retrieval_plane.py::test_agent_overlap_stream_identical_to_serial.

- Over ``StubGenerator`` both agents run the same scenario: the event
  streams of ``stream_with_status`` are equal dict for dict (status
  strings included), and so are ``query``'s results, the prompts each
  generator saw, the retriever's calls and the ``finchat_tool_*`` and
  ``finchat_partial_*`` counter deltas; the event-protocol cases run with
  ``tool_streaming`` and ``retrieval_overlap`` each on and off.

The turns over each package's ``EngineGenerator`` on ``mini`` are in
tests/test_torch_agent_engine.py.

No wall-clock assertion: where the reference times an eager launch or the
hold, the order of what happened is recorded and asserted on, with the
counters.
"""

import asyncio
import base64
import dataclasses
import io
import itertools
import types
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finchat_tpu.agent.graph import LLMAgent as JaxAgent  # noqa: E402
from finchat_tpu.agent.state import AgentState as JaxAgentState  # noqa: E402
from finchat_tpu.engine.generator import StubGenerator as JaxStub  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.io.schemas import ChatMessage as JaxChatMessage  # noqa: E402
from finchat_tpu.utils import faults as jax_faults  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu.utils.tracing import TRACER as JAX_TRACER  # noqa: E402
from finchat_tpu_torch.agent import END, LLMAgent, StateGraph  # noqa: E402
from finchat_tpu_torch.agent.state import AgentState  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator, StubGenerator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.io.schemas import ChatMessage  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils import faults  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402
from finchat_tpu_torch.utils.tracing import TRACER  # noqa: E402

torch.set_float32_matmul_precision("highest")

SYSTEM = "You are Penny."
TOOL = "Decide retrieval."
MARGIN = 1e-3
COUNTERS = ("finchat_tool_launches_total", "finchat_tool_speculative_cancels_total",
            "finchat_tool_fallbacks_total", "finchat_tool_overlap_saved_seconds_count",
            "finchat_partial_holds_total", "finchat_partial_grafts_total",
            "finchat_partial_fallbacks_total")

SIDES = {
    "port": SimpleNamespace(Agent=LLMAgent, Stub=StubGenerator, Msg=ChatMessage,
                            State=AgentState, Sampling=SamplingParams, faults=faults,
                            metrics=METRICS, tracer=TRACER),
    "jax": SimpleNamespace(Agent=JaxAgent, Stub=JaxStub, Msg=JaxChatMessage,
                           State=JaxAgentState, Sampling=JaxSampling, faults=jax_faults,
                           metrics=JAX_METRICS, tracer=JAX_TRACER),
}
MODES = list(itertools.product([True, False], [True, False]))
MODE_IDS = [f"stream{int(s)}-overlap{int(o)}" for s, o in MODES]


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.disarm_all()
    jax_faults.disarm_all()


def _both(scenario):
    """Run ``scenario(side)`` on each package, each on a loop of its own."""
    return {name: asyncio.run(scenario(side)) for name, side in SIDES.items()}


def _counters(metrics) -> dict:
    snap = metrics.snapshot()
    return {name: snap.get(name, 0.0) for name in COUNTERS}


def _delta(metrics, before: dict) -> dict:
    now = _counters(metrics)
    return {name: now[name] - v for name, v in before.items()}


def _same(got: dict):
    """The port's value equals the JAX package's; returns it."""
    assert got["port"] == got["jax"], (got["port"], got["jax"])
    return got["port"]


def _outcome(result: dict) -> dict:
    """``query``'s result without the state object, plus the state's
    fields that say what the turn did."""
    state = result["state"]
    return dict(response=result["response"], count=result["retrieved_transactions_count"],
                plot=result["plot_data_uri"], rows=state.retrieved_transactions,
                history=[(m.sender, m.message) for m in state.chat_history],
                tool_calls=list(state.tool_calls), partial=state.partial_prefill,
                tool_stream=state.tool_stream)


def make_agent(side, tool_response="No tool call", response_text="Here is my advice.",
               retriever=None, **kwargs):
    async def default_retriever(args):
        return [f"txn for {args['user_id']}"]

    return side.Agent(
        side.Stub(default=tool_response), side.Stub(default=response_text),
        retriever or default_retriever, SYSTEM, TOOL, today=lambda: "2026-07-29", **kwargs)


async def _events(agent, *args, **kwargs):
    return [e async for e in agent.stream_with_status(*args, **kwargs)]


# --- the graph ------------------------------------------------------------------

def test_state_graph_walks_conditional_and_static_edges():
    order = []

    async def node(name, state):
        order.append(name)
        return state

    graph = StateGraph()
    for name in ("a", "b", "c"):
        graph.add_node(name, lambda s, n=name: node(n, s))
    graph.set_entry_point("a")
    graph.add_conditional_edges("a", lambda s: "skip" if s.user_query == "skip" else "go",
                                {"go": "b", "skip": "c"})
    graph.add_edge("b", "c")
    graph.add_edge("c", END)
    asyncio.run(graph.ainvoke(AgentState(user_query="go", user_id="u")))
    asyncio.run(graph.ainvoke(AgentState(user_query="skip", user_id="u")))
    assert order == ["a", "b", "c", "a", "c"]


# --- tests/test_agent.py ----------------------------------------------------------

@pytest.mark.parametrize("streaming,overlap", MODES, ids=MODE_IDS)
def test_no_retrieval_path(streaming, overlap):
    async def run(side):
        agent = make_agent(side, tool_streaming=streaming, retrieval_overlap=overlap)
        return _outcome(await agent.query("How should I invest?", "u1", "CTX", []))

    out = _same(_both(run))
    assert out["response"] == "Here is my advice." and out["count"] == 0


@pytest.mark.parametrize("streaming,overlap", MODES, ids=MODE_IDS)
def test_retrieval_path_injects_user_id(streaming, overlap):
    async def run(side):
        seen = {}

        async def retriever(args):
            seen.update(args)
            return ["t1", "t2"]

        agent = make_agent(
            side, retriever=retriever, tool_streaming=streaming, retrieval_overlap=overlap,
            tool_response='retrieve_transactions({"search_query": "groceries", '
                          '"user_id": "attacker"})')
        result = await agent.query("What did I spend?", "real-user", "CTX", [])
        return seen, _outcome(result)

    seen, out = _same(_both(run))
    assert seen["user_id"] == "real-user"  # the server-side value wins
    assert out["count"] == 2


@pytest.mark.parametrize("streaming", [True, False], ids=["stream1", "stream0"])
def test_retrieval_failure_degrades(streaming):
    async def run(side):
        async def failing(args):
            raise RuntimeError("index down")

        agent = make_agent(side, tool_response='retrieve_transactions({"search_query": "x"})',
                           retriever=failing, tool_streaming=streaming)
        before = _counters(side.metrics)
        out = _outcome(await agent.query("spending?", "u1"))
        return out, _delta(side.metrics, before)

    out, delta = _same(_both(run))
    # an Error marker in the rows, the answer still generated
    assert out["response"] == "Here is my advice."
    assert out["rows"] == ["Error: index down"]
    assert delta["finchat_tool_fallbacks_total"] == (1 if streaming else 0)


@pytest.mark.parametrize("streaming,overlap", MODES, ids=MODE_IDS)
def test_stream_event_protocol_with_retrieval(streaming, overlap):
    async def run(side):
        agent = make_agent(side, tool_response='retrieve_transactions({"search_query": "q"})',
                           tool_streaming=streaming, retrieval_overlap=overlap)
        return await _events(agent, "spending?", "u1", "CTX", [])

    events = _same(_both(run))
    types_ = [e["type"] for e in events]
    assert types_[0] == "status" and events[0]["message"] == "Starting query processing..."
    rc = events[types_.index("retrieval_complete")]
    assert rc == {"type": "retrieval_complete", "count": 1, "message": "Retrieved 1 transactions"}
    assert events[-1] == {"type": "complete", "message": "Query processing completed"}
    chunks = [e["content"] for e in events if e["type"] == "response_chunk"]
    assert "".join(chunks) == "Here is my advice."


@pytest.mark.parametrize("streaming,overlap", MODES, ids=MODE_IDS)
def test_stream_event_protocol_without_retrieval(streaming, overlap):
    async def run(side):
        agent = make_agent(side, tool_response="No tool call", tool_streaming=streaming,
                           retrieval_overlap=overlap)
        return await _events(agent, "hello", "u1")

    events = _same(_both(run))
    messages = [e.get("message") for e in events if e["type"] == "status"]
    assert "No transaction data retrieval needed" in messages
    assert all(e["type"] != "retrieval_complete" for e in events)


def test_prompt_contains_context_history_and_date():
    async def run(side):
        tool_stub, response_stub = side.Stub(default="No tool call"), side.Stub(default="ok")

        async def retriever(args):
            return []

        agent = side.Agent(tool_stub, response_stub, retriever, SYSTEM, TOOL,
                           today=lambda: "2026-07-29")
        history = [side.Msg(sender="UserMessage", message="earlier question")]
        await agent.query("now?", "u1", "MY CONTEXT BLOCK", history)
        return tool_stub.calls, response_stub.calls

    tool_calls, response_calls = _same(_both(run))
    assert "The current date is 2026-07-29" in tool_calls[0]
    assert "MY CONTEXT BLOCK" in tool_calls[0]
    assert "earlier question" in response_calls[0]
    assert SYSTEM in response_calls[0]


def test_retrieved_data_lands_in_response_prompt():
    async def run(side):
        response_stub = side.Stub(default="ok")

        async def retriever(args):
            return ["COFFEE $4", "RENT $2000"]

        agent = side.Agent(side.Stub(default='retrieve_transactions({"search_query": "x"})'),
                           response_stub, retriever, SYSTEM, TOOL, today=lambda: "2026-07-29")
        await agent.query("spending?", "u1", "CTX")
        return response_stub.calls

    prompt = _same(_both(run))[0]
    assert "Retrieved Transaction Data:" in prompt
    assert "COFFEE $4" in prompt and "RENT $2000" in prompt


def _pixels(uri: str) -> np.ndarray:
    import matplotlib.image as mpimg

    prefix = "data:image/png;base64,"
    assert uri.startswith(prefix)
    return mpimg.imread(io.BytesIO(base64.b64decode(uri[len(prefix):])), format="png")


@pytest.mark.parametrize("streaming", [True, False], ids=["stream1", "stream0"])
def test_plot_tool_call_renders_chart_and_streams_event(streaming):
    """create_financial_plot through the agent: the structured retrieval
    feeds the chart (``user_id`` set on the server), the stream carries a
    plot event, and the batch path the chart too; both packages' charts
    decode to equal pixels."""

    class FakeStructuredRetriever:
        def __init__(self):
            self.calls = []

        async def __call__(self, args):
            return [r["page_content"] for r in await self.structured(args)]

        async def structured(self, args):
            self.calls.append(args)
            return [
                {"page_content": "coffee $4", "amount": 4.0, "date": 1.0, "user_id": args["user_id"]},
                {"page_content": "coffee $5", "amount": 5.0, "date": 2.0, "user_id": args["user_id"]},
            ]

    async def run(side):
        retriever = FakeStructuredRetriever()
        tool_gen = side.Stub(default='create_financial_plot({"chart_type": "bar", '
                                     '"title": "Coffee", "search_query": "coffee"})')
        agent = side.Agent(tool_gen, side.Stub(default="Here is your chart."), retriever,
                           "sys", "tool", tool_streaming=streaming, today=lambda: "2026-07-29")
        events = await _events(agent, "chart my coffee", "u1")
        result = await agent.query("chart my coffee", "u1")
        return events, result["plot_data_uri"], retriever.calls

    got = _both(run)
    (events, uri, calls), (jevents, juri, jcalls) = got["port"], got["jax"]
    plots = [e for e in events if e["type"] == "plot"]
    assert len(plots) == 1 and calls == jcalls
    assert calls[0]["user_id"] == "u1" and calls[0]["chart_type"] == "bar"
    strip = [{k: v for k, v in e.items() if k != "data_uri"} for e in events]
    assert strip == [{k: v for k, v in e.items() if k != "data_uri"} for e in jevents]
    np.testing.assert_array_equal(_pixels(plots[0]["data_uri"]),
                                  _pixels([e for e in jevents if e["type"] == "plot"][0]
                                          ["data_uri"]))
    np.testing.assert_array_equal(_pixels(uri), _pixels(juri))


# --- tests/test_tool_streaming.py -----------------------------------------------

def _paced(side, text, log, chunk_delay=0.01):
    """A word-paced decision decode that logs when its stream ended: the
    point an eager launch must come before."""

    class PacedToolGenerator(side.Stub):
        async def stream(self, *args, **kwargs):
            async for piece in super().stream(*args, **kwargs):
                yield piece
            log.append("decode_end")

    return PacedToolGenerator(default=text, chunk_delay=chunk_delay)


class OrderedRetriever:
    """A retriever that logs each call in the shared order log."""

    def __init__(self, log, rows=("COFFEE $4",), delay=0.0):
        self.log, self.rows, self.delay = log, list(rows), delay
        self.calls = []

    async def __call__(self, args):
        self.log.append("retriever_call")
        self.calls.append(dict(args))
        if self.delay:
            await asyncio.sleep(self.delay)
        return list(self.rows)


def test_tool_launches_before_decode_completes():
    async def run(side):
        log = []
        tool_gen = _paced(side, 'retrieve_transactions({"search_query": "coffee", '
                                '"num_transactions": 5, "time_period_days": 30})',
                          log, chunk_delay=0.02)
        retriever = OrderedRetriever(log, delay=0.01)
        agent = side.Agent(tool_gen, side.Stub(default="ok"), retriever, SYSTEM, TOOL,
                           today=lambda: "2026-08-03")
        before = _counters(side.metrics)
        saved0 = side.metrics.snapshot().get("finchat_tool_overlap_saved_seconds_sum", 0.0)
        result = await agent.query("what did I spend on coffee?", "u1")
        saved = side.metrics.snapshot()["finchat_tool_overlap_saved_seconds_sum"] - saved0
        return log, retriever.calls, _outcome(result), _delta(side.metrics, before), saved > 0

    log, calls, out, delta, saved = _same(_both(run))
    assert out["count"] == 1
    # the eager launch came before the end of the decision decode ...
    assert log.index("retriever_call") < log.index("decode_end")
    # ... and the histogram saw tool time hidden under it
    assert saved and delta["finchat_tool_overlap_saved_seconds_count"] == 1
    # the adopted launch: search_query then the later commits re-launched it
    assert calls[-1]["search_query"] == "coffee" and calls[-1]["num_transactions"] == 5
    assert calls[-1]["user_id"] == "u1"
    assert delta["finchat_tool_launches_total"] == len(calls)


@pytest.mark.parametrize("tool_text", [
    'retrieve_transactions({"search_query": "groceries", "num_transactions": 2})',
    "No tool call",
    'retrieve_transactions({bad json})',  # the named-without-arguments rescue
    "I cannot help with that",  # off the grammar, no tool named
], ids=["call", "no-tool", "rescue", "off-grammar"])
def test_streaming_matches_serial_path_byte_identical(tool_text):
    async def run(side):
        outcomes = {}
        for streaming in (False, True):
            retriever = OrderedRetriever([], rows=["t1", "t2"])
            agent = side.Agent(_paced(side, tool_text, []), side.Stub(default="Here is my advice."),
                               retriever, SYSTEM, TOOL, today=lambda: "2026-08-03",
                               tool_streaming=streaming)
            out = _outcome(await agent.query("spending?", "u7", "CTX", []))
            outcomes[streaming] = (out["response"], out["rows"],
                                   retriever.calls[-1].get("user_id") if retriever.calls else None)
        return outcomes

    outcomes = _same(_both(run))
    assert outcomes[True] == outcomes[False]


def test_late_arg_commit_cancels_and_relaunches():
    """A late commit that invalidates the eager launch (the date window
    changes which rows score) cancels it; only the relaunch is adopted."""

    class UnblockOnSecond(OrderedRetriever):
        async def __call__(self, args):
            self.calls.append(dict(args))
            if len(self.calls) > 1:
                return ["windowed row"]
            await asyncio.sleep(5.0)  # the stale launch never finishes
            return ["stale row"]

    async def run(side):
        retriever = UnblockOnSecond([])
        agent = side.Agent(
            _paced(side, 'retrieve_transactions({"search_query": "rent", "time_period_days": 7})',
                   []), side.Stub(default="Here is my advice."), retriever, SYSTEM, TOOL,
            today=lambda: "2026-08-03")
        before = _counters(side.metrics)
        out = _outcome(await agent.query("rent?", "u1"))
        return out["rows"], [c.get("time_period_days") for c in retriever.calls], \
            _delta(side.metrics, before)

    rows, windows, delta = _same(_both(run))
    assert rows == ["windowed row"] and windows == [None, 7]
    assert delta["finchat_tool_speculative_cancels_total"] >= 1


def test_late_refine_key_adopts_sliced_superset():
    async def run(side):
        retriever = OrderedRetriever([], rows=["a", "b", "c"], delay=0.01)
        agent = side.Agent(
            _paced(side, 'retrieve_transactions({"search_query": "rent", "num_transactions": 2})',
                   []), side.Stub(default="Here is my advice."), retriever, SYSTEM, TOOL,
            today=lambda: "2026-08-03")
        out = _outcome(await agent.query("rent?", "u1"))
        return out["rows"], retriever.calls

    rows, calls = _same(_both(run))
    assert rows == ["a", "b"]
    assert len(calls) == 1 and "num_transactions" not in calls[0]  # ran once, speculative


def test_tool_execute_fault_falls_back_to_serial_retry():
    async def run(side):
        retriever = OrderedRetriever([], rows=["row A"])
        agent = side.Agent(_paced(side, 'retrieve_transactions({"search_query": "x"})', []),
                           side.Stub(default="Answer."), retriever, SYSTEM, TOOL,
                           today=lambda: "2026-08-03")
        before = _counters(side.metrics)
        with side.faults.armed("tool.execute",
                               side.faults.one_shot(RuntimeError("index down"))):
            out = _outcome(await agent.query("spending?", "u1"))
        return out["response"], out["rows"], _delta(side.metrics, before)

    response, rows, delta = _same(_both(run))
    assert response == "Answer." and rows == ["row A"]  # the serial retry won
    assert delta["finchat_tool_fallbacks_total"] == 1


def test_tool_execute_persistent_fault_degrades_like_serial():
    def always(**ctx):
        raise RuntimeError("index down")

    async def run(side):
        agent = side.Agent(_paced(side, 'retrieve_transactions({"search_query": "x"})', []),
                           side.Stub(default="Here is my advice."), OrderedRetriever([]),
                           SYSTEM, TOOL, today=lambda: "2026-08-03")
        with side.faults.armed("tool.execute", always):
            out = _outcome(await agent.query("spending?", "u1"))
        return out["response"], out["rows"]

    response, rows = _same(_both(run))
    assert response == "Here is my advice." and rows == ["Error: index down"]


def _partial_generator(side, log):
    """A response-role double with the hold-park-graft seam, so the early
    prefix hold is testable without an engine; it logs each hold."""

    class FakePartialGenerator(side.Stub):
        def __init__(self):
            super().__init__(default="resp")
            self.begun, self.released, self.stream_partials = [], [], []

        async def begin_partial(self, prefix_text, sampling, conversation_id=None,
                                deadline=None, trace_id=None):
            log.append("hold")
            self.begun.append(prefix_text)
            return types.SimpleNamespace(hold=len(self.begun))

        def release_partial(self, partial):
            # the generator's rule: only an unclaimed hold is released
            if not getattr(partial, "_partial_claimed", False):
                self.released.append(partial.hold)

        async def stream(self, prompt, sampling, conversation_id=None, deadline=None,
                         partial=None, trace_id=None):
            if partial is not None:
                partial._partial_claimed = True
            self.stream_partials.append(None if partial is None else partial.hold)
            async for piece in super().stream(prompt, sampling):
                yield piece

        async def generate(self, prompt, sampling, conversation_id=None, deadline=None,
                           partial=None, trace_id=None):
            if partial is not None:
                partial._partial_claimed = True
            self.stream_partials.append(None if partial is None else partial.hold)
            return self.default

    return FakePartialGenerator()


@pytest.mark.parametrize("via", ["query", "stream"])
def test_prefix_hold_taken_at_name_commit_and_consumed(via):
    async def run(side):
        log = []
        resp = _partial_generator(side, log)
        agent = side.Agent(_paced(side, 'retrieve_transactions({"search_query": "coffee"})',
                                  log, chunk_delay=0.02),
                           resp, OrderedRetriever([]), SYSTEM, TOOL, today=lambda: "2026-08-03")
        if via == "query":
            text = (await agent.query("coffee?", "u1"))["response"]
        else:
            text = "".join(e["content"] for e in await _events(agent, "coffee?", "u1")
                           if e["type"] == "response_chunk")
        return text, log, resp.begun, resp.stream_partials, resp.released

    text, log, begun, partials, released = _same(_both(run))
    assert text == "resp" and len(begun) == 1
    assert log.index("hold") < log.index("decode_end")  # taken during the decode
    assert partials == [1] and released == []  # handed to the response, not leaked


def test_prefix_hold_released_when_serial_parse_overrules():
    """A grammatical call whose value holds the no-tool literal: the
    incremental plane commits a name (hold taken, tool launched) but the
    serial parse refuses the turn. The plane follows the serial outcome: no
    retrieval, the launch abandoned, the hold released."""

    async def run(side):
        resp = _partial_generator(side, [])
        agent = side.Agent(
            _paced(side, 'retrieve_transactions({"search_query": "No tool call"})', []),
            resp, OrderedRetriever([]), SYSTEM, TOOL, today=lambda: "2026-08-03")
        before = _counters(side.metrics)
        out = _outcome(await agent.query("hello", "u1"))
        return out["count"], out["response"], _delta(side.metrics, before), resp.begun, \
            resp.released

    count, response, delta, begun, released = _same(_both(run))
    assert count == 0 and response == "resp"
    assert delta["finchat_tool_fallbacks_total"] == 1
    assert len(begun) == 1 and released == [1]


# --- tests/test_windowing.py ------------------------------------------------------

def _budgeted(side, budget, **kw):
    """A stub with the generator's budget protocol (a byte-count budget)."""

    class BudgetedStub(side.Stub):
        def count_tokens(self, text):
            return len(text.encode("utf-8")) + 1

        def prompt_budget(self, sampling):
            return budget

    return BudgetedStub(**kw)


def test_windowing_drops_oldest_turns_first():
    async def run(side):
        gen = _budgeted(side, 700, default="No tool call")
        agent = side.Agent(gen, gen, lambda args: [], "SYSTEM", "TOOLPROMPT",
                           today=lambda: "2026-07-29")
        history = [side.Msg(sender="UserMessage", message=f"OLD-TURN-{i} " + "x" * 80)
                   for i in range(10)] + [side.Msg(sender="AIMessage", message="NEWEST-TURN fits")]
        result = await agent.query("current question", "u1", "ctx", history)
        return result["response"], gen.calls

    response, calls = _same(_both(run))
    prompt = calls[-1]
    assert response and "NEWEST-TURN" in prompt and "OLD-TURN-0" not in prompt
    assert "current question" in prompt and "SYSTEM" in prompt


def test_windowing_halves_retrieved_rows():
    rows = [f"row-{i}: spent $[{i}] at merchant {'m' * 40}" for i in range(32)]

    async def run(side):
        gen = _budgeted(side, 600, default="here is your answer",
                        rules=[(lambda p: "TOOLPROMPT" in p,
                                'retrieve_transactions({"search_query": "x"})')])

        async def retriever(args):
            return rows

        agent = side.Agent(gen, gen, retriever, "SYSTEM", "TOOLPROMPT",
                           today=lambda: "2026-07-29")
        return _outcome(await agent.query("what did I spend?", "u1"))

    out = _same(_both(run))
    assert out["response"] == "here is your answer"
    assert 0 < out["count"] < 32  # retrieved, then halved to fit


def _tiny_port_stack(max_seq_len):
    tok = ByteTokenizer()
    cfg = dataclasses.replace(tllama.PRESETS["tiny"], dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = InferenceEngine(cfg, params, EngineConfig(
        max_seqs=2, page_size=16, num_pages=64, max_seq_len=max_seq_len, prefill_chunk=32,
        session_cache=False), device="cpu")
    sched = ContinuousBatchingScheduler(engine, eos_id=tok.eos_id)
    return sched, EngineGenerator(sched, tok)


def test_overlong_conversation_still_answers_through_engine():
    """History far past ``max_seq_len`` is windowed and answers."""

    async def run():
        sched, gen = _tiny_port_stack(256)
        await sched.start()
        try:
            agent = LLMAgent(gen, gen, lambda args: [], "SYSTEM", "TOOLPROMPT",
                             tool_sampling=SamplingParams(temperature=0.0, max_new_tokens=16),
                             response_sampling=SamplingParams(temperature=0.0, max_new_tokens=16))
            history = [ChatMessage(sender="UserMessage" if i % 2 == 0 else "AIMessage",
                                   message=f"turn {i}: " + "blah " * 10) for i in range(40)]
            result = await agent.query("so what should I do?", "u1", "context", history)
        finally:
            await sched.stop()
        assert sched.allocator.used_count == 0
        return result

    result = asyncio.run(run())
    assert isinstance(result["response"], str)
    assert 0 < len(result["state"].chat_history) < 40


def test_token_level_backstop_splices():
    """A single prompt over budget (no history to drop) still streams."""

    async def run():
        sched, gen = _tiny_port_stack(128)
        await sched.start()
        try:
            return await gen.generate("y" * 4000, SamplingParams(temperature=0.0, max_new_tokens=8))
        finally:
            await sched.stop()

    assert isinstance(asyncio.run(run()), str)


# --- tests/test_faults.py, tests/test_tracing.py, tests/test_prefix_cache.py ------

def test_retrieval_fault_degrades_to_error_marker():
    """The serial path (``tool_streaming=False``): a retriever fault leaves
    the Error marker and the answer is still made."""

    async def run(side):
        class FaultyRetriever:
            async def __call__(self, args):
                side.faults.inject("retriever.call", seq_id=None)
                return ["row"]

        side.faults.arm("retriever.call", side.faults.one_shot(RuntimeError("vector index down")))
        agent = side.Agent(side.Stub(default='retrieve_transactions({"search_query": "x"})'),
                           side.Stub(default="Here's what I can say without your data."),
                           FaultyRetriever(), "sys", "tool", tool_streaming=False,
                           today=lambda: "2026-07-29")
        return _outcome(await agent.query("what did I spend?", "u1"))

    out = _same(_both(run))
    assert out["response"].startswith("Here's")
    assert out["rows"] == ["Error: vector index down"]


def test_agent_marks_and_streamed_output_identity():
    tool_text = 'retrieve_transactions({"search_query": "coffee", "num_transactions": 2})'

    async def retriever(args):
        await asyncio.sleep(0.005)
        return ["COFFEE $4", "COFFEE $6"]

    def run_turn(side, traced):
        side.tracer.configure(enabled=True)
        side.tracer.clear()
        agent = side.Agent(side.Stub(default=tool_text, chunk_delay=0.005),
                           _partial_generator(side, []), retriever, "SYSTEM", "TOOL",
                           today=lambda: "2026-08-04")
        events = asyncio.run(_events(agent, "coffee spend?", "u1", "CTX", [],
                                     conversation_id="c1",
                                     trace_id="req-agent" if traced else None))
        return events, [e["name"] for e in side.tracer.export("req-agent")["traceEvents"]]

    got = {}
    for name, side in SIDES.items():
        prev = side.tracer.enabled
        try:
            traced, names = run_turn(side, True)
            untraced, none = run_turn(side, False)
        finally:
            side.tracer.configure(enabled=prev)
            side.tracer.clear()
        for mark in ("decide_start", "name_commit", "tool_launch", "tool_adopted",
                     "response_prefill_hold"):
            assert mark in names, (name, mark, names)
        assert names.index("name_commit") < names.index("tool_adopted")
        assert none == []  # no trace id, no events
        assert traced == untraced  # tracing never changes the streamed events
        got[name] = (traced, sorted(names))
    _same(got)


def test_agent_prompt_heads_are_rendered_prompt_prefixes():
    def heads(side):
        stub = side.Stub(default="x")
        agent = side.Agent(stub, stub, None, "SYSTEM RULES", "TOOL RULES",
                           today=lambda: "2026-07-29")
        state = side.State(user_query="how much did I spend?", user_id="u",
                           user_context="name: Pat")
        tool_head, resp_head = agent.prompt_heads()
        assert agent._tool_prompt_text(state).startswith(tool_head)
        state.retrieved_transactions = ["row1", "row2"]
        assert agent._response_prompt_text(state).startswith(resp_head)
        assert agent._response_prompt_text(state).startswith(agent._response_prefix_text(state))
        return tool_head, resp_head, agent._response_prompt_text(state)

    assert heads(SIDES["port"]) == heads(SIDES["jax"])


def test_metrics_view_is_the_tool_schedulers():
    """The ``finchat_tool_*`` family lands in the tool generator's
    scheduler's registry (the global one in the port, as in a one-replica
    app); an explicit registry wins; a stub falls back to the global."""
    sched = SimpleNamespace(metrics=object())
    gen = SimpleNamespace(scheduler=sched)
    assert LLMAgent(gen, StubGenerator(), None, "s", "t").metrics is sched.metrics
    assert LLMAgent(StubGenerator(), StubGenerator(), None, "s", "t").metrics is METRICS
    mine = object()
    assert LLMAgent(gen, StubGenerator(), None, "s", "t", metrics=mine).metrics is mine
