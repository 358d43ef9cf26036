"""Typed agent state (own copy of the JAX package's ``agent/state.py``).

The same fields and the same deque semantics for pending tool calls: only
the first call is honoured a turn. ``ChatMessage`` comes from the port's
``io/schemas.py``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any

from finchat_tpu_torch.io.schemas import ChatMessage


@dataclass
class ToolCall:
    name: str
    args: dict[str, Any]


@dataclass
class AgentState:
    user_query: str
    user_id: str
    # session KV cache key (engine/session_cache.py): turns of the same
    # conversation resume each other's prefilled KV; None = no reuse
    conversation_id: str | None = None
    user_context: str = ""
    chat_history: list[ChatMessage] = field(default_factory=list)
    tool_calls: deque[ToolCall] = field(default_factory=deque)
    retrieved_transactions: list[str] = field(default_factory=list)
    plot_data_uri: str | None = None  # create_financial_plot output
    final_response: str | None = None
    # retrieval/prefill overlap: the engine's partial prefill of the
    # response prompt's static prefix (generator.begin_partial handle),
    # taken while retrieval runs and grafted at generation time
    partial_prefill: Any = None
    # the tool-streaming plane's launcher, adopted (or cancelled) by the
    # retrieval step; None outside a streamed tool turn
    tool_stream: Any = None
    # completion deadline on time.perf_counter's clock (None = none), for
    # the scheduler's shedding and earliest-deadline-first admission
    deadline: float | None = None
    # end-to-end trace id (utils/tracing.py), threaded through every
    # generator call so the request's events correlate on one timeline;
    # None = untraced
    trace_id: str | None = None
