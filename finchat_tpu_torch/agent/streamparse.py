"""Tool streaming: incremental tool-call parsing and eager tool execution
during the decision decode (own copy of the JAX package's
``agent/streamparse.py``; host code, no device work).

The decision model emits a tool call as text, up to 96 grammar-constrained
tokens. Parsed only at the end, every tool turn pays decode + tool in
series. This module parses the partial output as chunks arrive and launches
the tool as soon as enough of the call has committed:

- :class:`StreamingToolParser`: an event-emitting character scanner run in
  lockstep with the same grammar DFA the constrained pick uses
  (``agent/constrained.py`` ``build_tool_grammar``). Events:
  ``ToolNameComplete`` (the ``(`` after the name), ``ArgComplete(key,
  value)`` (the argument's closing delimiter decoded: a string's closing
  quote, an int's terminator), ``CallComplete`` (the closing ``)``),
  ``NoToolComplete``, and ``ParseAnomaly`` (the stream left the grammar:
  the scanner disengages and the serial parser decides).
- :class:`ToolLauncher`: launches the tool once the name and every
  launch-required argument have committed, cancels and relaunches (a
  counted speculative cancel) when a later commit invalidates the launch,
  and adopts the task in ``result_for`` when it serves the final call.

The streaming plane only moves when things start. The final decision is
always ``parse_tool_decision`` over the whole text (:meth:`StreamingToolParser.finish`),
equal to the decode-then-parse path however the text was chunked.

Metrics, through the launcher's ``metrics`` registry:
``finchat_tool_launches_total``, ``finchat_tool_speculative_cancels_total``,
``finchat_tool_fallbacks_total`` (counted by the agent: streaming
disengaged, or a failed speculative run retried serially) and the
``finchat_tool_overlap_saved_seconds`` histogram (the tool time an adopted
launch hid under the rest of the decode).

Fault site: ``tool.execute`` (utils/faults.py) fires inside every tool
execution, speculative and serial (``agent/graph.py``).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

from finchat_tpu_torch.agent.constrained import DEAD, CharDFA, build_tool_grammar
from finchat_tpu_torch.agent.state import ToolCall
from finchat_tpu_torch.agent.toolcall import (
    NO_TOOL_LITERAL,
    PLOT_TOOL_NAME,
    TOOL_NAME,
    VALIDATORS,
    parse_tool_decision,
)
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS
from finchat_tpu_torch.utils.tracing import TRACER

logger = get_logger(__name__)

# Arguments that must have committed before a speculative launch is
# worthwhile: the search query is the embedding's input, while the other
# arguments have stable validated defaults that a later commit only refines
# (a counted relaunch). Tools absent here never launch before CallComplete.
LAUNCH_KEYS: dict[str, tuple[str, ...]] = {
    TOOL_NAME: ("search_query",),
    PLOT_TOOL_NAME: ("search_query",),
}

# Keys whose late commit does not invalidate an in-flight launch: the
# adopter cuts the speculative superset on the host instead of relaunching.
# ``num_transactions`` is a pure top-k cut over score-ordered rows. Keys
# that change which rows score (the query, the date window, the chart's
# look baked into the render) are absent: their late commit relaunches.
REFINE_KEYS: dict[str, tuple[str, ...]] = {
    TOOL_NAME: ("num_transactions",),
    PLOT_TOOL_NAME: (),
}


def refinable(base: ToolCall, final: ToolCall) -> bool:
    """May ``final`` be served by cutting ``base``'s speculative result?
    Same tool, and every differing key is a refine key that tightens: absent
    from ``base`` (fetched at the generous default) or with a base value
    that covers the final one. The grammar does not track used keys, so a
    duplicate key can grow a value, and growing cannot be cut."""
    if base.name != final.name:
        return False
    allowed = REFINE_KEYS.get(final.name, ())
    for key in set(base.args) | set(final.args):
        b, f = base.args.get(key), final.args.get(key)
        if b == f:
            continue
        if key not in allowed:
            return False
        if key in base.args and not (
            isinstance(b, int) and isinstance(f, int) and b >= f
        ):
            return False
    return True


_WS = " \t\n"


# --- parse events ---------------------------------------------------------

@dataclass(frozen=True)
class ToolNameComplete:
    name: str


@dataclass(frozen=True)
class ArgComplete:
    key: str
    value: Any  # decoded raw value (str or int), before validation


@dataclass(frozen=True)
class CallComplete:
    call: ToolCall  # validated


@dataclass(frozen=True)
class NoToolComplete:
    pass


@dataclass(frozen=True)
class ParseAnomaly:
    reason: str


@dataclass
class ToolResult:
    """What one tool execution produced: returned, not written to the agent
    state, so an unadopted speculative run can be dropped."""

    texts: list[str]
    plot_data_uri: str | None = None


class ToolStreamError(RuntimeError):
    """A speculative tool execution failed. ``code`` and ``retryable``
    follow the generator's structured error fields (``GenerationError``);
    the agent's first recourse is a serial retry."""

    def __init__(self, message: str, *, code: str | None = None,
                 retryable: bool = False):
        super().__init__(message)
        self.code = code
        self.retryable = retryable


# --- incremental parser ---------------------------------------------------

_GRAMMAR_DFA: CharDFA | None = None


def _tool_dfa() -> CharDFA:
    """The process-wide grammar DFA (a duplicate build under a racing first
    call is harmless: the character automaton is cheap)."""
    global _GRAMMAR_DFA
    if _GRAMMAR_DFA is None:
        _GRAMMAR_DFA = build_tool_grammar()
    return _GRAMMAR_DFA


class StreamingToolParser:
    """Incremental tool-decision parser over decode chunks.

    ``feed(chunk)`` works character by character, so the events do not
    depend on how the text was chunked, and returns the events the chunk
    completed. Two automata run in lockstep:

    - the grammar DFA answers membership: the first character off the
      grammar raises ``ParseAnomaly`` and disengages the scanner for good
      (the serial parser still decides at ``finish``);
    - a scanner, trusting the DFA for structure, tracks which production a
      character advances (name, key, string or int value) and emits the
      commit-point events.
    """

    def __init__(self) -> None:
        self._dfa = _tool_dfa()
        self._dfa_state = self._dfa.start
        self._chunks: list[str] = []
        self.anomaly: str | None = None
        self.completed_call: ToolCall | None = None
        self.no_tool = False
        # scanner state
        self._mode = "lead"
        self._buf: list[str] = []
        self._key = ""
        self._name: str | None = None
        self._raw_args: dict[str, Any] = {}

    @property
    def text(self) -> str:
        return "".join(self._chunks)

    # -- public API --------------------------------------------------------

    def feed(self, chunk: str) -> list[Any]:
        self._chunks.append(chunk)
        if self.anomaly is not None:
            return []
        events: list[Any] = []
        for ch in chunk:
            nxt = self._dfa.step(self._dfa_state, ch)
            if nxt == DEAD:
                self.anomaly = "stream left the tool-call grammar"
                events.append(ParseAnomaly(self.anomaly))
                break
            self._dfa_state = nxt
            produced = self._scan(ch)
            if produced:
                events.extend(produced)
        return events

    def launchable_call(self) -> ToolCall | None:
        """The call the launcher may run now: the name and every
        launch-required argument committed. Its arguments are the validated
        view of what has committed; a later commit may invalidate it."""
        if self.anomaly is not None or self._name is None:
            return None
        required = LAUNCH_KEYS.get(self._name)
        if required is None or any(k not in self._raw_args for k in required):
            return None
        return ToolCall(name=self._name, args=VALIDATORS[self._name](dict(self._raw_args)))

    def finish(self) -> ToolCall | None:
        """The final decision: always the serial parser over the whole text.
        A disagreement with the incremental ``CallComplete`` (only a scanner
        bug reaches it) is logged and flagged as an anomaly, so the caller
        counts the fallback and drops the speculative result; the serial
        result wins."""
        final = parse_tool_decision(self.text)
        if self.anomaly is None and self.completed_call is not None and (
            final is None or final != self.completed_call
        ):
            logger.warning(
                "incremental parse disagrees with serial parse (%r vs %r); serial wins",
                self.completed_call, final,
            )
            self.anomaly = "incremental/serial parse mismatch"
        return final

    # -- scanner -----------------------------------------------------------
    # Only grammatical characters reach here (the DFA stepped first), so a
    # mode recognizes the transitions the grammar allows from it; anything
    # else is structural whitespace.

    def _scan(self, ch: str) -> list[Any]:
        mode = self._mode
        if mode == "lead":
            if not self._buf and ch in _WS:
                return []  # bounded leading whitespace
            self._buf.append(ch)
            if ch == "(":
                self._name = "".join(self._buf[:-1])
                self._buf = []
                self._mode = "pre_obj"
                return [ToolNameComplete(self._name)]
            if "".join(self._buf) == NO_TOOL_LITERAL:
                self.no_tool = True
                self._buf = []
                self._mode = "done"
                return [NoToolComplete()]
            return []
        if mode == "pre_obj":
            if ch == "{":
                self._mode = "obj"
            return []
        if mode in ("obj", "pre_key"):
            if ch == '"':
                self._buf = []
                self._mode = "key"
            elif ch == "}":  # the empty object
                self._mode = "post_obj"
            return []
        if mode == "key":
            if ch == '"':
                self._key = "".join(self._buf)
                self._buf = []
                self._mode = "post_key"
            else:
                self._buf.append(ch)
            return []
        if mode == "post_key":
            if ch == ":":
                self._mode = "pre_val"
            return []
        if mode == "pre_val":
            if ch == '"':
                self._buf = []
                self._mode = "str_val"
            elif ch.isdigit():
                self._buf = [ch]
                self._mode = "int_val"
            return []
        if mode == "str_val":
            if ch == '"':  # commit point: the closing quote
                value = "".join(self._buf)
                self._buf = []
                self._mode = "post_val"
                return self._commit_arg(value)
            self._buf.append(ch)
            return []
        if mode == "int_val":
            if ch.isdigit():
                self._buf.append(ch)
                return []
            # commit point: an int has no closing character; its terminator
            # ("," / "}" / whitespace) commits it and advances the object
            value = int("".join(self._buf))
            self._buf = []
            if ch == ",":
                self._mode = "pre_key"
            elif ch == "}":
                self._mode = "post_obj"
            else:
                self._mode = "post_val"
            return self._commit_arg(value)
        if mode == "post_val":
            if ch == ",":
                self._mode = "pre_key"
            elif ch == "}":
                self._mode = "post_obj"
            return []
        if mode == "post_obj":
            if ch == ")":
                self._mode = "done"
                return self._complete_call()
            return []
        return []  # "done": the DFA rejects any further character

    def _commit_arg(self, value: Any) -> list[Any]:
        self._raw_args[self._key] = value  # a duplicate key: the last wins, as json.loads
        return [ArgComplete(self._key, value)]

    def _complete_call(self) -> list[Any]:
        assert self._name is not None  # "(" was seen to get here
        self.completed_call = ToolCall(
            name=self._name, args=VALIDATORS[self._name](dict(self._raw_args))
        )
        return [CallComplete(self.completed_call)]


# --- speculative launcher -------------------------------------------------

def _swallow(task: asyncio.Task) -> None:
    # a cancelled or failed launch nobody adopted must not log "Task
    # exception was never retrieved"
    if not task.cancelled():
        task.exception()


class ToolLauncher:
    """Speculative tool execution for one decision decode.

    ``execute`` is an async ``ToolCall -> ToolResult`` (the agent binds the
    server-side ``user_id`` into it: the launcher only sees validated model
    arguments).

    Lifecycle: ``update(call)`` at each commit event (launch, keep, or
    cancel and relaunch), ``mark_decode_done()`` when the decode ends,
    ``result_for(final_call)`` to adopt or re-run, ``abandon()`` when
    nothing will be adopted.
    """

    def __init__(
        self,
        execute: Callable[[ToolCall], Awaitable[ToolResult]],
        *,
        refine: Callable[[ToolResult, ToolCall], ToolResult] | None = None,
        metrics=None,
        trace_id: str | None = None,
    ):
        self._execute = execute
        # host-side refinement for late-committed REFINE_KEYS (the top-k
        # cut); None = exact-match adoption only
        self._refine = refine
        self.metrics = metrics if metrics is not None else METRICS
        # launches and adoptions land on the request's trace timeline
        self.trace_id = trace_id
        self._task: asyncio.Task | None = None
        self._task_call: ToolCall | None = None
        self._task_started = 0.0
        self._decode_done_at: float | None = None
        self.abandoned = False

    def update(self, call: ToolCall | None) -> None:
        """Reconcile the in-flight launch with the call the committed text
        implies now. A launch that can still serve it (identical, or
        differing only in refine keys) is kept; an invalidated one is
        cancelled (a counted speculative cancel) and relaunched."""
        if self.abandoned or call is None:
            return
        if self._task is not None:
            if self._task_call == call or (
                self._refine is not None and refinable(self._task_call, call)
            ):
                return
            self._drop_task(cancelled_speculation=True)
        self._launch(call)

    def mark_decode_done(self) -> None:
        """The decision decode ended: the point the overlap-saved histogram
        measures against (a serial turn would only start the tool now)."""
        self._decode_done_at = time.perf_counter()

    def abandon(self) -> None:
        """Cancel any in-flight launch; no adoption will happen."""
        self.abandoned = True
        self._drop_task(cancelled_speculation=True)

    async def result_for(self, call: ToolCall) -> ToolResult:
        """Adopt the in-flight launch when it can serve the final ``call``
        (identical arguments, or differing only in refine keys, refined on
        the host); otherwise cancel it and run ``call`` through the same
        execute seam. A failure raises :class:`ToolStreamError` (structured,
        retryable) for the caller's serial fallback."""
        adoptable = (
            not self.abandoned
            and self._task is not None
            and (self._task_call == call
                 or (self._refine is not None
                     and refinable(self._task_call, call)))
        )
        if not adoptable:
            self._drop_task(cancelled_speculation=True)
            self.abandoned = False
            self._launch(call)
        task = self._task
        task_call = self._task_call
        started = self._task_started
        assert task is not None and task_call is not None
        self._task, self._task_call = None, None  # ownership moves here
        try:
            result, ended = await task
        except asyncio.CancelledError:
            if task.cancelled():  # the task's own cancellation, not ours
                raise ToolStreamError(
                    "speculative tool launch was cancelled",
                    code="tool_execute_cancelled", retryable=True,
                ) from None
            task.cancel()  # we are being cancelled: do not orphan the tool
            raise
        except Exception as e:
            raise ToolStreamError(
                f"tool execution failed: {e}",
                code="tool_execute_failed", retryable=True,
            ) from e
        if self._decode_done_at is not None:
            # the part of the adopted run that hid under the decode
            saved = max(0.0, min(ended, self._decode_done_at) - started)
            self.metrics.observe("finchat_tool_overlap_saved_seconds", saved,
                                 trace_id=self.trace_id)
        if self.trace_id is not None and TRACER.enabled:
            # the adopted execution as a complete span (started to ended)
            TRACER.event("tool_adopted", self.trace_id, ts=started,
                         dur=max(0.0, ended - started), track="agent",
                         args={"tool": call.name})
        if task_call != call:
            assert self._refine is not None  # adoptable implies it
            result = self._refine(result, call)
        return result

    # -- internals ---------------------------------------------------------

    def _launch(self, call: ToolCall) -> None:
        self._task_call = call
        self._task_started = time.perf_counter()
        self._task = asyncio.ensure_future(self._timed(call))
        self._task.add_done_callback(_swallow)
        self.metrics.inc("finchat_tool_launches_total")
        if self.trace_id is not None and TRACER.enabled:
            TRACER.event("tool_launch", self.trace_id, track="agent",
                         args={"tool": call.name})

    async def _timed(self, call: ToolCall) -> tuple[ToolResult, float]:
        # the end is stamped inside the task: adoption may come long after
        # the tool finished, and the histogram measures the tool's run
        result = await self._execute(call)
        return result, time.perf_counter()

    def _drop_task(self, cancelled_speculation: bool) -> None:
        task = self._task
        self._task, self._task_call = None, None
        if task is None:
            return
        if not task.done():
            task.cancel()
        if cancelled_speculation:
            self.metrics.inc("finchat_tool_speculative_cancels_total")
