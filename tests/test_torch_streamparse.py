"""The port's streaming tool parser and launcher against the JAX package's,
each case of tests/test_streamparse.py:

- the parser's events and commit points (a string commits at its closing
  quote, an int at its terminator), the no-tool literal and the anomaly;
- the split-point invariance fuzz and the truncated prefixes: the same
  seeded chunkings fed to both packages' parsers give equal event streams
  and equal ``finish()`` results, and ``finish()`` equals the serial
  ``parse_tool_decision`` within each package;
- the launcher's eager launch and adoption, the late invalidating commit
  that cancels and relaunches, the late refine key that keeps the launch,
  the mismatch re-run, the structured retryable failure, ``abandon``, the
  grown refine key that relaunches, ``refinable``'s direction, and the
  agent's ``_settle_prefix`` propagating the caller's cancellation.

Host code only: the comparisons are exact. No wall clock is asserted on.
"""

import asyncio
import dataclasses
import random

import pytest

pytest.importorskip("torch")

from finchat_tpu.agent import streamparse as jsp  # noqa: E402
from finchat_tpu.agent.toolcall import parse_tool_decision as jax_parse  # noqa: E402
from finchat_tpu_torch.agent.state import ToolCall  # noqa: E402
from finchat_tpu_torch.agent.streamparse import (  # noqa: E402
    ArgComplete,
    CallComplete,
    NoToolComplete,
    ParseAnomaly,
    StreamingToolParser,
    ToolLauncher,
    ToolNameComplete,
    ToolResult,
    ToolStreamError,
    refinable,
)
from finchat_tpu_torch.agent.toolcall import parse_tool_decision  # noqa: E402

VALID_RETRIEVE = (
    'retrieve_transactions({"search_query": "coffee shops", '
    '"num_transactions": 25, "time_period_days": 30})'
)
VALID_PLOT = (
    'create_financial_plot({"chart_type": "pie", "title": "Spending", '
    '"search_query": "all spending"})'
)


def feed_all(parser, text, pieces=None):
    events = []
    for piece in pieces if pieces is not None else [text]:
        events.extend(parser.feed(piece))
    return events


def _plain(value):
    """An event, a call or a list of them as plain tuples, so the two
    packages' dataclasses compare."""
    if isinstance(value, list):
        return [_plain(v) for v in value]
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,) + tuple(
            _plain(getattr(value, f.name)) for f in dataclasses.fields(value))
    return value


# --- event semantics ------------------------------------------------------

def test_valid_call_event_stream_and_commit_order():
    parser = StreamingToolParser()
    events = feed_all(parser, VALID_RETRIEVE, list(VALID_RETRIEVE))  # char by char
    kinds = [type(e).__name__ for e in events]
    assert kinds == [
        "ToolNameComplete", "ArgComplete", "ArgComplete", "ArgComplete",
        "CallComplete",
    ]
    assert events[0] == ToolNameComplete("retrieve_transactions")
    assert events[1] == ArgComplete("search_query", "coffee shops")
    assert events[2] == ArgComplete("num_transactions", 25)
    assert events[3] == ArgComplete("time_period_days", 30)
    final = parser.finish()
    assert final == events[-1].call
    assert final == parse_tool_decision(VALID_RETRIEVE)
    jparser = jsp.StreamingToolParser()
    assert _plain(feed_all(jparser, VALID_RETRIEVE, list(VALID_RETRIEVE))) == _plain(events)
    assert _plain(jparser.finish()) == _plain(final)


def test_string_arg_commits_only_at_closing_quote():
    parser = StreamingToolParser()
    evs = parser.feed('retrieve_transactions({"search_query": "half a quer')
    assert not any(isinstance(e, ArgComplete) for e in evs)
    assert parser.launchable_call() is None  # not launchable yet
    evs = parser.feed("y")
    assert not any(isinstance(e, ArgComplete) for e in evs)
    evs = parser.feed('"')  # the commit point
    assert evs == [ArgComplete("search_query", "half a query")]
    call = parser.launchable_call()
    assert call is not None and call.args["search_query"] == "half a query"


def test_int_arg_commits_at_terminator():
    parser = StreamingToolParser()
    parser.feed('retrieve_transactions({"search_query": "x", "num_transactions": 41')
    assert parser.feed("2") == []  # still taking digits
    evs = parser.feed("}")  # the terminator commits and closes the object
    assert evs == [ArgComplete("num_transactions", 412)]
    assert isinstance(parser.feed(")")[0], CallComplete)


def test_no_tool_literal_and_anomaly():
    parser = StreamingToolParser()
    assert feed_all(parser, "No tool call") == [NoToolComplete()]
    assert parser.finish() is None

    parser = StreamingToolParser()
    events = feed_all(parser, "Sure! I will retrieve_transactions({})")
    assert len(events) == 1 and isinstance(events[0], ParseAnomaly)
    # the serial parser still decides (its pattern searches anywhere)
    assert parser.finish() == parse_tool_decision("Sure! I will retrieve_transactions({})")
    assert parser.feed("more") == []  # disengaged for good


def test_launchable_requires_name_and_required_args():
    parser = StreamingToolParser()
    parser.feed("retrieve_transactions(")
    assert parser.launchable_call() is None  # search_query not committed
    parser.feed('{"num_transactions": 5, ')
    assert parser.launchable_call() is None
    parser.feed('"search_query": "rent"')
    call = parser.launchable_call()
    assert call.name == "retrieve_transactions"
    assert call.args["search_query"] == "rent"
    assert call.args["num_transactions"] == 5  # committed extras ride along


# --- split-point invariance, across packages ------------------------------

CORPUS = [
    VALID_RETRIEVE,
    VALID_PLOT,
    'retrieve_transactions({})',
    'retrieve_transactions({"search_query": "café ümläut €99"})',
    'retrieve_transactions({"num_transactions": 10000})',
    'create_financial_plot({"chart_type": "bar", "title": "T"})',
    "No tool call",
    "No tool call.",  # trailing junk: off the grammar, still parses serially
    "no tool call",  # case drift: off the grammar, the serial no-tool rule applies
    "",
    "   \n\t  ",
    "I don't know what you mean.",
    "Sure — retrieve_transactions is the tool I'd use",  # named, no parentheses
    'retrieve_transactions({"search_query": "a}b"})',
    'retrieve_transactions({"search_query": "unterminated',
    'retrieve_transactions({"search_query": "x", "num_transactions":',
    'retrieve_transactions({bad json})',
    'retrieve_transactions  ({"search_query": "x"})',  # whitespace the pattern takes
    'create_financial_plot({"chart_type": "volcano"})',  # off the enum
    'retrieve_transactions({"num_transactions": 007})',  # leading zeros
    'retrieve_transactions({"search_query": "x"}) trailing words',
    'ééé retrieve_transactions({"search_query": "x"})',
    # a grammatical call whose value holds the no-tool literal: the serial
    # no-tool scan overrules the incremental CallComplete
    'retrieve_transactions({"search_query": "No tool call"})',
]


def chunkings(text, rng):
    yield [text]
    yield list(text)  # one character a chunk
    for _ in range(4):  # random decode-burst splits, mid-string included
        if not text:
            yield []
            continue
        cuts = sorted(rng.sample(range(1, len(text) + 1), min(rng.randint(1, 7), len(text))))
        pieces, prev = [], 0
        for cut in cuts:
            pieces.append(text[prev:cut])
            prev = cut
        if prev < len(text):
            pieces.append(text[prev:])
        yield pieces


@pytest.mark.parametrize("text", CORPUS, ids=[f"c{i}" for i in range(len(CORPUS))])
def test_split_point_invariance_matches_jax(text):
    """For every chunking (whole, a character each, four seeded random
    splits), both packages' parsers give the same events and ``finish()``;
    within each, ``finish()`` is the serial parse and the events do not
    depend on the chunking."""
    rng = random.Random(9 + CORPUS.index(text))
    serial = parse_tool_decision(text)
    assert _plain(serial) == _plain(jax_parse(text))
    reference_events = None
    for pieces in chunkings(text, rng):
        parser, jparser = StreamingToolParser(), jsp.StreamingToolParser()
        events = feed_all(parser, text, pieces)
        jevents = feed_all(jparser, text, pieces)
        assert _plain(events) == _plain(jevents), (text, pieces)
        final = parser.finish()
        assert final == serial, (text, pieces)
        assert _plain(final) == _plain(jparser.finish()), (text, pieces)
        assert parser.anomaly == jparser.anomaly and parser.no_tool == jparser.no_tool
        if reference_events is None:
            reference_events = events
        else:
            assert events == reference_events, (text, pieces)


@pytest.mark.parametrize("text", [VALID_RETRIEVE, VALID_PLOT], ids=["retrieve", "plot"])
def test_truncated_prefixes_never_complete_and_match_jax(text):
    for cut in range(len(text)):
        prefix = text[:cut]
        parser, jparser = StreamingToolParser(), jsp.StreamingToolParser()
        events = feed_all(parser, prefix, list(prefix))
        assert not any(isinstance(e, CallComplete) for e in events)
        assert _plain(events) == _plain(feed_all(jparser, prefix, list(prefix))), prefix
        assert _plain(parser.launchable_call()) == _plain(jparser.launchable_call()), prefix
        final = parser.finish()
        assert final == parse_tool_decision(prefix), prefix
        assert _plain(final) == _plain(jparser.finish()), prefix


# --- launcher lifecycle ---------------------------------------------------

class Recorder:
    """The execute seam's double: records launches, and can stall so a
    later commit can invalidate an in-flight one."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.started: list[dict] = []
        self.finished: list[dict] = []
        self.cancelled: list[dict] = []

    async def __call__(self, call) -> ToolResult:
        self.started.append(call.args)
        try:
            if self.delay:
                await asyncio.sleep(self.delay)
        except asyncio.CancelledError:
            self.cancelled.append(call.args)
            raise
        self.finished.append(call.args)
        return ToolResult([f"rows for {call.args.get('search_query')}"])


def _drive(parser, launcher, text):
    for event in parser.feed(text):
        if isinstance(event, ParseAnomaly):
            launcher.abandon()
        elif isinstance(event, CallComplete):
            launcher.update(event.call)
        elif isinstance(event, ArgComplete):
            launcher.update(parser.launchable_call())


async def test_launcher_eager_launch_and_adoption():
    recorder = Recorder()
    parser = StreamingToolParser()
    launcher = ToolLauncher(recorder)
    _drive(parser, launcher, 'retrieve_transactions({"search_query": "rent"')
    await asyncio.sleep(0)  # let the launched task start
    assert len(recorder.started) == 1  # launched before ")" decodes
    _drive(parser, launcher, "})")
    launcher.mark_decode_done()
    result = await launcher.result_for(parser.finish())
    assert result.texts == ["rows for rent"]
    assert len(recorder.started) == 1  # adopted, not run again


async def test_late_token_invalidates_eager_launch():
    """A later commit of a result-changing argument (the date window, not a
    refine key) cancels the in-flight launch and relaunches."""
    recorder = Recorder(delay=10.0)  # the first launch cannot finish in time
    parser = StreamingToolParser()
    launcher = ToolLauncher(recorder, refine=lambda result, call: result)
    _drive(parser, launcher, 'retrieve_transactions({"search_query": "rent", ')
    await asyncio.sleep(0)
    assert len(recorder.started) == 1
    _drive(parser, launcher, '"time_period_days": 3')
    await asyncio.sleep(0)
    assert len(recorder.started) == 1  # the int has not committed
    _drive(parser, launcher, "0})")
    await asyncio.sleep(0)
    assert len(recorder.started) == 2  # relaunched with the new arguments
    recorder.delay = 0.0
    launcher.mark_decode_done()
    result = await launcher.result_for(parser.finish())
    assert result.texts == ["rows for rent"]
    await asyncio.sleep(0)  # let the cancelled task unwind
    assert recorder.cancelled == [{"search_query": "rent"}]
    assert recorder.finished == [{"search_query": "rent", "time_period_days": 30}]


async def test_late_refine_key_keeps_launch_and_refines_at_adoption():
    """A late refine key (num_transactions) keeps the in-flight launch: the
    adopter cuts the speculative superset."""
    recorder = Recorder()

    async def execute(call):
        recorder.started.append(call.args)
        await asyncio.sleep(0.05)
        recorder.finished.append(call.args)
        return ToolResult(["r1", "r2", "r3", "r4"])

    def refine(result, call):
        n = call.args.get("num_transactions")
        return ToolResult(result.texts[:n]) if n else result

    parser = StreamingToolParser()
    launcher = ToolLauncher(execute, refine=refine)
    _drive(parser, launcher, 'retrieve_transactions({"search_query": "rent", ')
    await asyncio.sleep(0)
    assert len(recorder.started) == 1
    _drive(parser, launcher, '"num_transactions": 2})')
    await asyncio.sleep(0)
    assert len(recorder.started) == 1  # a refine key: the launch stays
    launcher.mark_decode_done()
    result = await launcher.result_for(parser.finish())
    assert result.texts == ["r1", "r2"]  # the superset cut at adoption
    assert recorder.finished == [{"search_query": "rent"}]  # ran once


async def test_launcher_mismatch_reruns_final_call():
    recorder = Recorder()
    launcher = ToolLauncher(recorder)
    launcher.update(ToolCall("retrieve_transactions", {"search_query": "a"}))
    await asyncio.sleep(0.01)
    result = await launcher.result_for(ToolCall("retrieve_transactions", {"search_query": "b"}))
    assert result.texts == ["rows for b"]
    assert recorder.started == [{"search_query": "a"}, {"search_query": "b"}]


async def test_launcher_failure_is_structured_retryable():
    async def boom(call):
        raise RuntimeError("index down")

    launcher = ToolLauncher(boom)
    launcher.update(ToolCall("retrieve_transactions", {"search_query": "x"}))
    with pytest.raises(ToolStreamError) as exc:
        await launcher.result_for(ToolCall("retrieve_transactions", {"search_query": "x"}))
    assert exc.value.code == "tool_execute_failed"
    assert exc.value.retryable is True


async def test_abandon_cancels_without_adoption():
    recorder = Recorder(delay=10.0)
    launcher = ToolLauncher(recorder)
    launcher.update(ToolCall("retrieve_transactions", {"search_query": "x"}))
    await asyncio.sleep(0)
    launcher.abandon()
    await asyncio.sleep(0)
    assert recorder.cancelled == [{"search_query": "x"}]
    assert launcher.abandoned


async def test_refine_key_growing_via_duplicate_commit_relaunches():
    """The grammar does not track used keys, so a duplicate key can grow
    num_transactions after the launch (5 to 20). A cut only shrinks: the
    launcher cancels and relaunches instead of adopting the smaller fetch."""
    recorder = Recorder()
    parser = StreamingToolParser()
    launcher = ToolLauncher(recorder, refine=lambda result, call: result)
    text = ('retrieve_transactions({"num_transactions": 5, '
            '"search_query": "coffee", "num_transactions": 20})')
    assert parse_tool_decision(text).args["num_transactions"] == 20  # the last wins
    cut = text.index('"coffee"') + len('"coffee"')  # search_query committed
    _drive(parser, launcher, text[:cut])
    await asyncio.sleep(0)
    assert recorder.started == [{"search_query": "coffee", "num_transactions": 5}]
    _drive(parser, launcher, text[cut:])
    await asyncio.sleep(0)
    assert len(recorder.started) == 2  # the grown limit invalidated n=5
    launcher.mark_decode_done()
    result = await launcher.result_for(parser.finish())
    assert result.texts == ["rows for coffee"]
    assert recorder.finished[-1]["num_transactions"] == 20


def test_refinable_direction_contract():
    base = ToolCall("retrieve_transactions", {"search_query": "x"})
    grown = ToolCall("retrieve_transactions", {"search_query": "x", "num_transactions": 7})
    tighter = ToolCall("retrieve_transactions", {"search_query": "x", "num_transactions": 3})
    cases = [(base, grown, True), (grown, base, False), (grown, tighter, True),
             (tighter, grown, False)]
    for b, f, want in cases:
        assert refinable(b, f) is want
        assert jsp.refinable(jsp.ToolCall(b.name, b.args), jsp.ToolCall(f.name, f.args)) is want


def test_launch_and_refine_keys_match_jax():
    from finchat_tpu_torch.agent import streamparse as tsp

    assert tsp.LAUNCH_KEYS == jsp.LAUNCH_KEYS and tsp.REFINE_KEYS == jsp.REFINE_KEYS


async def test_settle_prefix_propagates_caller_cancellation():
    """A cancellation delivered while the agent awaits the prefix settle
    cancels the turn, and the in-flight hold task is reaped."""
    from finchat_tpu_torch.agent.graph import LLMAgent
    from finchat_tpu_torch.engine.generator import StubGenerator

    agent = LLMAgent(StubGenerator(), StubGenerator(), None, "s", "t")

    async def hold():
        await asyncio.sleep(30)

    state = type("S", (), {"partial_prefill": None})()
    prefix_task = asyncio.ensure_future(hold())

    async def settle():
        await agent._settle_prefix(state, prefix_task, keep=True)
        return "not cancelled"

    outer = asyncio.ensure_future(settle())
    await asyncio.sleep(0.01)
    outer.cancel()
    with pytest.raises(asyncio.CancelledError):
        await outer
    await asyncio.sleep(0)
    assert prefix_task.cancelled()
