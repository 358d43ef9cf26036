"""Tool-decision output parsing (own copy of the JAX package's
``agent/toolcall.py``).

The decision model emits text, parsed strictly against the prompt
contract (``prompts/tool_prompt.txt``):

- the literal ``No tool call``: no retrieval;
- ``retrieve_transactions({...json...})``: a validated ToolCall;
- ``create_financial_plot({...json...})``: a validated ToolCall.

Validation: ``num_transactions`` bounded 1..10000, ``time_period_days`` a
positive int, ``search_query`` a string defaulting to "recent
transactions"; plot arguments add ``chart_type`` (whitelisted) and
``title``. ``user_id`` is never taken from the model: the executor sets it
server-side.
"""

from __future__ import annotations

import json
import re

from finchat_tpu_torch.agent.state import ToolCall
from finchat_tpu_torch.tools.plot import CHART_TYPES  # the one source of the enum
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TOOL_NAME = "retrieve_transactions"
PLOT_TOOL_NAME = "create_financial_plot"
NO_TOOL_LITERAL = "No tool call"

_CALL_RE = re.compile(
    r"(retrieve_transactions|create_financial_plot)\s*\(\s*(\{.*?\})\s*\)", re.DOTALL
)


def _validate_retrieval_args(raw: dict) -> dict:
    args: dict = {}
    sq = raw.get("search_query")
    args["search_query"] = sq if isinstance(sq, str) and sq.strip() else "recent transactions"

    n = raw.get("num_transactions")
    if isinstance(n, bool):
        n = None
    if isinstance(n, (int, float)):
        args["num_transactions"] = max(1, min(10_000, int(n)))

    days = raw.get("time_period_days")
    if isinstance(days, bool):
        days = None
    if isinstance(days, (int, float)) and int(days) > 0:
        args["time_period_days"] = int(days)

    # a user_id from the model is dropped by construction
    return args


def _validate_plot_args(raw: dict) -> dict:
    args = _validate_retrieval_args(raw)
    chart = raw.get("chart_type")
    args["chart_type"] = chart if chart in CHART_TYPES else "bar"
    title = raw.get("title")
    args["title"] = title if isinstance(title, str) and title.strip() else "Financial Plot"
    return args


# public: a streaming parser validates its per-argument commits through the
# same validators, so eager launches and the serial parse agree
VALIDATORS = {
    TOOL_NAME: _validate_retrieval_args,
    PLOT_TOOL_NAME: _validate_plot_args,
}


def parse_tool_decision(text: str) -> ToolCall | None:
    """Parse the tool-decision model output into a ToolCall, or None."""
    stripped = text.strip()
    if not stripped or NO_TOOL_LITERAL.lower() in stripped.lower()[:80]:
        return None

    match = _CALL_RE.search(stripped)
    if match is None:
        for name in (TOOL_NAME, PLOT_TOOL_NAME):
            if name in stripped:
                # a tool named without parsable arguments: call it with defaults
                logger.warning("tool call named without parsable args: %r", stripped[:120])
                return ToolCall(name=name, args=VALIDATORS[name]({}))
        return None

    name = match.group(1)
    validator = VALIDATORS[name]
    try:
        raw = json.loads(match.group(2))
    except json.JSONDecodeError:
        logger.warning("unparsable tool-call JSON: %r", match.group(2)[:120])
        return ToolCall(name=name, args=validator({}))

    if not isinstance(raw, dict):
        return ToolCall(name=name, args=validator({}))
    return ToolCall(name=name, args=validator(raw))
