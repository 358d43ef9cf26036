"""The three-node agent graph and its streaming bypass (own copy of the JAX
package's ``agent/graph.py``; host code over the generators).

decide_retrieval -> (conditional) -> retrieve_data -> generate_response ->
END. Two ways through it:

- ``query()`` walks the graph: batch, not streaming.
- ``stream_with_status()`` calls the nodes directly so it can interleave
  status events and stream the final generation. Its event dicts and status
  strings are wire contract, byte for byte the JAX package's.

The two LLM roles (the tool decision and the response) are two
``TextGenerator``s, typically one engine with different prompts and
sampling.

With ``tool_streaming`` the decide node consumes the decision decode as a
chunk stream (agent/streamparse.py): the tool launches at its arguments'
commit points and the response prefix hold is taken at name-commit. With
``retrieval_overlap`` the response prompt's static prefix prefills while
the tool runs, and the retrieved block is grafted onto it.
"""

from __future__ import annotations

import asyncio
import json
from collections import deque
from datetime import date
from typing import Any, AsyncGenerator, Awaitable, Callable

from finchat_tpu_torch.agent.state import AgentState, ToolCall
from finchat_tpu_torch.agent.streamparse import (
    ArgComplete,
    CallComplete,
    ParseAnomaly,
    StreamingToolParser,
    ToolLauncher,
    ToolNameComplete,
    ToolResult,
)
from finchat_tpu_torch.agent.toolcall import parse_tool_decision
from finchat_tpu_torch.engine.generator import TextGenerator
from finchat_tpu_torch.engine.sampler import SamplingParams
from finchat_tpu_torch.engine.session_cache import session_key
from finchat_tpu_torch.io.schemas import ChatMessage
from finchat_tpu_torch.models.tokenizer import render_chat, render_chat_head, render_chat_prefix
from finchat_tpu_torch.tools.plot import PlotConfig, create_financial_plot
from finchat_tpu_torch.utils.faults import inject
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS
from finchat_tpu_torch.utils.tracing import TRACER

logger = get_logger(__name__)

END = "__end__"

# async retriever: validated tool args (with the server-side user_id) -> texts
Retriever = Callable[[dict[str, Any]], Awaitable[list[str]]]


class StateGraph:
    """A minimal typed state machine: named nodes, static edges and
    conditional routing."""

    def __init__(self) -> None:
        self._nodes: dict[str, Callable[[AgentState], Awaitable[AgentState]]] = {}
        self._edges: dict[str, str] = {}
        self._conditional: dict[str, tuple[Callable[[AgentState], str], dict[str, str]]] = {}
        self._entry: str | None = None

    def add_node(self, name: str, fn: Callable[[AgentState], Awaitable[AgentState]]) -> None:
        self._nodes[name] = fn

    def set_entry_point(self, name: str) -> None:
        self._entry = name

    def add_edge(self, src: str, dst: str) -> None:
        self._edges[src] = dst

    def add_conditional_edges(
        self, src: str, router: Callable[[AgentState], str], mapping: dict[str, str]
    ) -> None:
        self._conditional[src] = (router, mapping)

    async def ainvoke(self, state: AgentState) -> AgentState:
        assert self._entry is not None, "entry point not set"
        node = self._entry
        while node != END:
            state = await self._nodes[node](state)
            if node in self._conditional:
                router, mapping = self._conditional[node]
                node = mapping[router(state)]
            else:
                node = self._edges[node]
        return state


class LLMAgent:
    def __init__(
        self,
        tool_generator: TextGenerator,
        response_generator: TextGenerator,
        retriever: Retriever,
        system_prompt: str,
        tool_prompt: str,
        *,
        tool_sampling: SamplingParams | None = None,
        response_sampling: SamplingParams | None = None,
        today: Callable[[], str] = lambda: date.today().isoformat(),
        retrieval_overlap: bool = True,
        tool_streaming: bool = True,
        metrics=None,
    ):
        self.tool_generator = tool_generator
        self.response_generator = response_generator
        self.retriever = retriever
        self.system_prompt = system_prompt
        self.tool_prompt = tool_prompt
        # temperature 0.5 for both roles; the decision is grammar-constrained
        # (agent/constrained.py) when its generator is an EngineGenerator
        self.tool_sampling = tool_sampling or SamplingParams(
            temperature=0.5, max_new_tokens=96, grammar="tool_call"
        )
        self.response_sampling = response_sampling or SamplingParams(temperature=0.5)
        self.today = today
        # retrieval overlap (EngineConfig.retrieval_overlap): prefill the
        # response prompt's static prefix (system + context + history) while
        # the tool runs and graft the retrieved block in when it arrives.
        # Needs a generator with the partial-prefill seam (EngineGenerator);
        # any other takes the serial path.
        self.retrieval_overlap = retrieval_overlap
        # tool streaming (EngineConfig.tool_streaming): consume the decision
        # decode as a chunk stream, launch the tool at its commit points and
        # take the response prefix hold at name-commit. Any parser anomaly
        # falls back to decode-then-parse.
        self.tool_streaming = tool_streaming
        # the registry of the finchat_tool_* family: an explicit ``metrics``,
        # else the tool generator's scheduler's, else the global one
        self.metrics = metrics if metrics is not None else getattr(
            getattr(tool_generator, "scheduler", None), "metrics", None
        ) or METRICS
        self.graph = self._build_graph()
        logger.info("Agent initialized with state graph")

    def _build_graph(self) -> StateGraph:
        graph = StateGraph()
        graph.add_node("decide_retrieval", self._decide_retrieval_node)
        graph.add_node("retrieve_data", self._retrieve_data_node)
        graph.add_node("generate_response", self._generate_response_node)
        graph.set_entry_point("decide_retrieval")
        graph.add_conditional_edges(
            "decide_retrieval",
            self._should_retrieve,
            {"retrieve": "retrieve_data", "respond": "generate_response"},
        )
        graph.add_edge("retrieve_data", "generate_response")
        graph.add_edge("generate_response", END)
        return graph

    # --- prompt assembly -------------------------------------------------
    def _tool_system(self) -> str:
        return f"The current date is {self.today()}.\n{self.tool_prompt}"

    def _response_system(self) -> str:
        return f"The current date is {self.today()}.\n\n{self.system_prompt}"

    def prompt_heads(self) -> list[str]:
        """The constant leading string of every rendered prompt, one per LLM
        role: ``render_chat_head`` over the same system builders the prompt
        assembly uses, so each is a byte prefix of its role's prompts. A
        server registers them with the scheduler's prefix cache (and again
        when the embedded date rolls over)."""
        return [
            render_chat_head(self._tool_system()),
            render_chat_head(self._response_system()),
        ]

    def _tool_prompt_text(self, state: AgentState) -> str:
        def build(s: AgentState) -> str:
            return render_chat(
                self._tool_system(), s.user_context, s.chat_history, s.user_query
            )

        return self._fit_prompt(build, state, self.tool_generator, self.tool_sampling)

    def _response_prompt_text(self, state: AgentState) -> str:
        def build(s: AgentState) -> str:
            # the retrieved block rides the final user turn, so everything
            # before it (system + context + history) is known before the
            # retrieval returns: ``_response_prefix_text`` is its byte prefix
            user_input = s.user_query
            if s.retrieved_transactions:
                user_input = (
                    "Retrieved Transaction Data:\n"
                    + "\n".join(s.retrieved_transactions)
                    + f"\n\n{s.user_query}"
                )
            return render_chat(
                self._response_system(), f"{s.user_context}\n", s.chat_history, user_input
            )

        return self._fit_prompt(build, state, self.response_generator, self.response_sampling)

    def _response_prefix_text(self, state: AgentState) -> str:
        """The static prefix of ``_response_prompt_text``, a byte prefix by
        construction. If ``_fit_prompt`` later windows history away, the
        prefix stops leading the prompt and the graft falls back serially."""
        return render_chat_prefix(
            self._response_system(), f"{state.user_context}\n", state.chat_history
        )

    def _fit_prompt(
        self,
        build: Callable[[AgentState], str],
        state: AgentState,
        generator: TextGenerator,
        sampling: SamplingParams,
    ) -> str:
        """Window the conversation so the rendered prompt fits the engine's
        token budget: drop the oldest history turns first, then halve the
        retrieved rows. ``state`` is changed so the later response prompt
        sees the same windowed conversation. Generators without a budget
        (``StubGenerator``) skip windowing; what is still over budget is the
        generator's token-level head + tail splice.
        """
        budget_fn = getattr(generator, "prompt_budget", None)
        count_fn = getattr(generator, "count_tokens", None)
        text = build(state)
        if budget_fn is None or count_fn is None:
            return text
        budget = budget_fn(sampling)
        if count_fn(text) <= budget:
            return text
        # binary search for the longest suffix of history that fits
        history = list(state.chat_history)
        dropped_turns = 0
        if history:
            lo, hi = 0, len(history)  # turns kept from the end
            while lo < hi:
                mid = (lo + hi + 1) // 2
                state.chat_history = history[len(history) - mid:]
                if count_fn(build(state)) <= budget:
                    lo = mid
                else:
                    hi = mid - 1
            state.chat_history = history[len(history) - lo:] if lo else []
            dropped_turns = len(history) - lo
            text = build(state)
        dropped_rows = 0
        while state.retrieved_transactions and count_fn(text) > budget:
            keep = len(state.retrieved_transactions) // 2
            dropped_rows += len(state.retrieved_transactions) - keep
            state.retrieved_transactions = state.retrieved_transactions[:keep]
            text = build(state)
        if dropped_turns or dropped_rows:
            logger.warning(
                "windowed prompt to fit %d-token budget: dropped %d history "
                "turns, %d retrieved rows", budget, dropped_turns, dropped_rows,
            )
        return text

    @staticmethod
    def _session_key(state: AgentState, role: str) -> str | None:
        """The session-cache key of one LLM role. The roles render different
        prompts for one conversation, so they must not share a key (each
        would see the other's prompt as a divergent history)."""
        if not state.conversation_id:
            return None
        return session_key(state.conversation_id, role)

    @staticmethod
    def _trace(state: AgentState, name: str, **args) -> None:
        """An agent event on the request's trace timeline (decide_start,
        name_commit, response_prefill_hold); a no-op for an untraced
        request, so tracing never changes the streamed output."""
        if state.trace_id is not None and TRACER.enabled:
            TRACER.event(name, state.trace_id, track="agent",
                         args=args or None)

    def _gen_kwargs(self, state: AgentState, role: str) -> dict[str, Any]:
        """A role's generator kwargs: session key, deadline and, only for a
        traced request, the trace id."""
        kwargs: dict[str, Any] = {
            "conversation_id": self._session_key(state, role),
            "deadline": state.deadline,
        }
        if state.trace_id is not None:
            kwargs["trace_id"] = state.trace_id
        return kwargs

    # --- nodes -----------------------------------------------------------
    async def _decide_retrieval_node(self, state: AgentState) -> AgentState:
        """Node 1: decide whether transaction retrieval is needed.

        With ``tool_streaming`` the decision decode is consumed as a chunk
        stream: the parser's commit events let the launcher run the call
        while the rest decodes, and the response prefix starts prefilling
        at name-commit. The decision is always the serial parser over the
        whole text (``StreamingToolParser.finish``): streaming moves when
        the tool and the prefix start, never what is done.
        """
        logger.info("Deciding if transaction retrieval is needed")
        self._trace(state, "decide_start")
        if not self.tool_streaming:
            decision_text = await self.tool_generator.generate(
                self._tool_prompt_text(state), self.tool_sampling,
                **self._gen_kwargs(state, "tool"),
            )
            tool_call = parse_tool_decision(decision_text)
            if tool_call is not None:
                state.tool_calls.append(tool_call)
                logger.info("LLM requested retrieval with args: %s", tool_call.args)
            else:
                logger.info("LLM decided no retrieval needed")
            return state

        parser = StreamingToolParser()
        launcher = ToolLauncher(
            lambda call: self._execute_streamed(state, call),
            refine=self._refine_tool_result, metrics=self.metrics,
            trace_id=state.trace_id,
        )
        prefix_task: Any = None
        try:
            async for chunk in self.tool_generator.stream(
                self._tool_prompt_text(state), self.tool_sampling,
                **self._gen_kwargs(state, "tool"),
            ):
                for event in parser.feed(chunk):
                    if isinstance(event, ParseAnomaly):
                        # off the grammar: the eager plane disengages and the
                        # serial parse below decides (the fallback is counted
                        # once, after finish)
                        launcher.abandon()
                    elif isinstance(event, ToolNameComplete):
                        self._trace(state, "name_commit", tool=event.name)
                        if prefix_task is None and self._overlap_ready(state):
                            prefix_task = asyncio.create_task(self._begin_prefix(state))
                    elif isinstance(event, CallComplete):
                        launcher.update(event.call)
                    elif isinstance(event, ArgComplete):
                        launcher.update(parser.launchable_call())
        except BaseException:
            # a failed or cancelled stream: nothing will be adopted, and an
            # early prefix hold must not pin its slot and pages
            launcher.abandon()
            await self._settle_prefix(state, prefix_task, keep=False)
            raise
        launcher.mark_decode_done()
        tool_call = parser.finish()
        if parser.anomaly is not None:
            launcher.abandon()  # a no-op unless finish() flagged a mismatch
            self.metrics.inc("finchat_tool_fallbacks_total")
        if tool_call is not None:
            state.tool_calls.append(tool_call)
            state.tool_stream = launcher
            if prefix_task is None and self._overlap_ready(state):
                # an anomaly can reach a call with no name-commit event (the
                # parser's named-without-arguments rescue): take the hold now
                prefix_task = asyncio.create_task(self._begin_prefix(state))
            await self._settle_prefix(state, prefix_task, keep=True)
            logger.info("LLM requested retrieval with args: %s", tool_call.args)
        else:
            launcher.abandon()
            await self._settle_prefix(state, prefix_task, keep=False)
            logger.info("LLM decided no retrieval needed")
        return state

    def _overlap_ready(self, state: AgentState) -> bool:
        return (
            self.retrieval_overlap
            and state.partial_prefill is None
            and hasattr(self.response_generator, "begin_partial")
        )

    async def _begin_prefix(self, state: AgentState):
        try:
            handle = await self.response_generator.begin_partial(
                self._response_prefix_text(state), self.response_sampling,
                **self._gen_kwargs(state, "resp"),
            )
        except Exception as e:  # the overlap is an optimization, never fatal
            logger.warning("partial prefill unavailable, serial path: %s", e)
            return None
        if handle is not None:
            self._trace(state, "response_prefill_hold")
        return handle

    async def _settle_prefix(self, state: AgentState, prefix_task, *, keep: bool) -> None:
        """Resolve an early prefix task into ``state.partial_prefill``
        (``keep``), or give back the hold it may have taken (not ``keep``:
        a no-tool turn, an upstream error)."""
        if prefix_task is None:
            return
        if not keep:
            prefix_task.cancel()
        try:
            handle = await prefix_task
        except asyncio.CancelledError:
            # with ``keep`` the task was not cancelled here, so this is the
            # caller being cancelled: propagate (a hold whose submit still
            # lands is the scheduler's TTL reap's). Without ``keep`` the
            # cancellation is ours to swallow.
            if keep:
                raise
            return
        except Exception:
            return  # _begin_prefix logged it; the overlap is optional
        state.partial_prefill = handle
        if not keep:
            self._release_partial(state)

    async def _retrieve_data_node(self, state: AgentState) -> AgentState:
        """Node 2: run the tool. Only the first queued call is honoured; a
        failure leaves an Error marker and the answer is still generated.

        ``create_financial_plot`` runs a server-side structured retrieval
        for its data (the model never supplies rows), charts the rows that
        carry an amount, and still fills ``retrieved_transactions`` so the
        response discusses the data the chart shows.
        """
        logger.info("Retrieving transaction data")
        if not state.tool_calls:
            return state
        tool_call = state.tool_calls.popleft()
        tool_args = dict(tool_call.args)
        tool_args["user_id"] = state.user_id  # server-side, never model-chosen
        launcher, state.tool_stream = state.tool_stream, None
        if launcher is not None:
            # tool streaming: the call is usually in flight since its
            # arguments committed, and the prefix hold was taken at
            # name-commit; adopt the result. A failure (structured and
            # retryable) falls to the serial path below.
            try:
                self._apply_tool_result(
                    state, await launcher.result_for(tool_call)
                )
                return state
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.warning(
                    "streamed tool execution failed (code=%s); serial retry: %s",
                    getattr(e, "code", None), e,
                )
                self.metrics.inc("finchat_tool_fallbacks_total")
        if self._overlap_ready(state):
            # the overlap: the tool runs as a task while the response prompt's
            # static prefix is submitted for prefill, so only the retrieved
            # block and the user turn are left when the tool returns
            retrieval = asyncio.create_task(self._run_tool(state, tool_call, tool_args))
            try:
                state.partial_prefill = await self._begin_prefix(state)
                await retrieval
            except BaseException:
                # a cancellation must not orphan the tool task
                retrieval.cancel()
                try:
                    await retrieval
                except (asyncio.CancelledError, Exception):
                    pass
                raise
        else:
            await self._run_tool(state, tool_call, tool_args)
        return state

    async def _run_tool(self, state: AgentState, tool_call: ToolCall,
                        tool_args: dict[str, Any]) -> None:
        try:
            self._apply_tool_result(
                state, await self._execute_tool(state, tool_call, tool_args)
            )
        except Exception as e:
            logger.error("Error running tool: %s", e)
            state.retrieved_transactions = [f"Error: {e}"]

    async def _execute_streamed(self, state: AgentState, call: ToolCall) -> ToolResult:
        """The launcher's execute seam, with the serial path's server-side
        ``user_id``."""
        args = dict(call.args)
        args["user_id"] = state.user_id  # server-side, never model-chosen
        return await self._execute_tool(state, call, args)

    async def _execute_tool(self, state: AgentState, tool_call: ToolCall,
                            tool_args: dict[str, Any]) -> ToolResult:
        """One tool execution. It changes no state: a speculative run is a
        cancellable task, and only an adopted result touches the agent's
        state (``_apply_tool_result``). ``tool.execute`` is the fault site
        of both planes."""
        inject("tool.execute", tool=tool_call.name, user_id=state.user_id)
        if tool_call.name == "create_financial_plot" and hasattr(self.retriever, "structured"):
            rows = await self.retriever.structured(tool_args)
            texts = [r["page_content"] for r in rows]
            chartable = [r for r in rows if "amount" in r]
            plot_data_uri = None
            if chartable:
                # synchronous on purpose: the render is cheap (Agg, at most
                # 10k rows), and matplotlib off the main thread is unsafe
                plot_data_uri = create_financial_plot(
                    json.dumps(chartable),
                    # the validator guarantees chart_type and title
                    PlotConfig(chart_type=tool_args["chart_type"], title=tool_args["title"]),
                )
            else:
                logger.warning("plot requested but no rows carry an 'amount' field")
            return ToolResult(texts, plot_data_uri)
        return ToolResult(await self.retriever(tool_args))

    @staticmethod
    def _refine_tool_result(result: ToolResult, call: ToolCall) -> ToolResult:
        """The host-side cut for a late-committed ``num_transactions``: the
        retriever returns score-ordered rows, so the first n of the
        speculative superset are a limit-n query's rows."""
        n = call.args.get("num_transactions")
        if isinstance(n, int) and len(result.texts) > n:
            return ToolResult(result.texts[:n], result.plot_data_uri)
        return result

    def _apply_tool_result(self, state: AgentState, result: ToolResult) -> None:
        state.retrieved_transactions = result.texts
        if result.plot_data_uri is not None:
            state.plot_data_uri = result.plot_data_uri
        logger.info("Retrieved %d transactions", len(state.retrieved_transactions))

    def _response_kwargs(self, state: AgentState) -> dict[str, Any]:
        """The response role's kwargs. ``partial`` is passed only when a hold
        was taken, so generators without the seam never see it."""
        kwargs: dict[str, Any] = {"conversation_id": self._session_key(state, "resp")}
        if state.deadline is not None:
            kwargs["deadline"] = state.deadline
        if state.partial_prefill is not None:
            kwargs["partial"] = state.partial_prefill
        if state.trace_id is not None:
            kwargs["trace_id"] = state.trace_id
        return kwargs

    def _release_partial(self, state: AgentState) -> None:
        """Leak guard: a hold the generator never claimed (an upstream
        failure, an abandoned stream) gives back its slot and pages; a
        claimed one is its stream's to manage."""
        if state.partial_prefill is not None and hasattr(
            self.response_generator, "release_partial"
        ):
            self.response_generator.release_partial(state.partial_prefill)
        state.partial_prefill = None

    def _cancel_tool_stream(self, state: AgentState) -> None:
        """Leak guard: a speculative launch nobody adopted stops."""
        if state.tool_stream is not None:
            state.tool_stream.abandon()
            state.tool_stream = None

    async def _generate_response_node(self, state: AgentState) -> AgentState:
        """Node 3: generate the final response (the graph's batch path)."""
        logger.info("Generating final response")
        state.final_response = await self.response_generator.generate(
            self._response_prompt_text(state), self.response_sampling,
            **self._response_kwargs(state),
        )
        logger.info("Final response generated")
        return state

    def _should_retrieve(self, state: AgentState) -> str:
        if state.tool_calls:
            logger.info("Routing to retrieve_data")
            return "retrieve"
        logger.info("Routing to generate_response")
        return "respond"

    # --- public API ------------------------------------------------------
    async def query(
        self,
        user_query: str,
        user_id: str,
        user_context: str = "",
        chat_history: list[ChatMessage] | None = None,
        conversation_id: str | None = None,
        deadline: float | None = None,
        trace_id: str | None = None,
    ) -> dict[str, Any]:
        """The batch path through the graph."""
        logger.info("Processing query for user %s: %s", user_id, user_query)
        state = AgentState(
            user_query=user_query,
            user_id=user_id,
            conversation_id=conversation_id,
            user_context=user_context,
            chat_history=list(chat_history or []),
            tool_calls=deque(),
            deadline=deadline,
            trace_id=trace_id,
        )
        try:
            final_state = await self.graph.ainvoke(state)
        finally:
            self._cancel_tool_stream(state)
            self._release_partial(state)
        return {
            "response": final_state.final_response,
            "retrieved_transactions_count": len(final_state.retrieved_transactions),
            "plot_data_uri": final_state.plot_data_uri,
            "state": final_state,
        }

    async def stream_with_status(
        self,
        user_query: str,
        user_id: str,
        user_context: str = "",
        chat_history: list[ChatMessage] | None = None,
        conversation_id: str | None = None,
        deadline: float | None = None,
        trace_id: str | None = None,
    ) -> AsyncGenerator[dict[str, Any], None]:
        """The streaming path with status events; the event shapes and
        messages are wire contract."""
        logger.info("Processing query with status streaming for user %s: %s", user_id, user_query)
        yield {"type": "status", "message": "Starting query processing..."}

        state = AgentState(
            user_query=user_query,
            user_id=user_id,
            conversation_id=conversation_id,
            user_context=user_context,
            chat_history=list(chat_history or []),
            tool_calls=deque(),
            deadline=deadline,
            trace_id=trace_id,
        )

        try:
            yield {"type": "status", "message": "Analyzing query to determine if transaction data is needed..."}
            state = await self._decide_retrieval_node(state)

            if self._should_retrieve(state) == "retrieve":
                yield {"type": "status", "message": "Retrieving relevant transaction data..."}
                state = await self._retrieve_data_node(state)
                yield {
                    "type": "retrieval_complete",
                    "count": len(state.retrieved_transactions),
                    "message": f"Retrieved {len(state.retrieved_transactions)} transactions",
                }
                if state.plot_data_uri:
                    yield {"type": "plot", "data_uri": state.plot_data_uri}
            else:
                yield {"type": "status", "message": "No transaction data retrieval needed"}

            yield {"type": "status", "message": "Generating response..."}

            async for chunk in self.response_generator.stream(
                self._response_prompt_text(state), self.response_sampling,
                **self._response_kwargs(state),
            ):
                if chunk:
                    yield {"type": "response_chunk", "content": chunk}
        finally:
            # a hold the stream never claimed (the consumer abandoned the
            # generator, an upstream error) must not pin its slot and pages,
            # and an unadopted speculative launch must not keep running
            self._cancel_tool_stream(state)
            self._release_partial(state)

        yield {"type": "complete", "message": "Query processing completed"}
        logger.info("Status streaming completed")
