"""The agent's host-side planes: its typed state, the tool-decision parser
and the grammar that constrains the decision decode. The agent graph and
the streaming tool parser come with a later slice."""

from finchat_tpu_torch.agent.constrained import GrammarVocab, TokenConstraint, build_tool_grammar
from finchat_tpu_torch.agent.state import AgentState, ToolCall
from finchat_tpu_torch.agent.toolcall import parse_tool_decision

__all__ = [
    "AgentState", "ToolCall", "parse_tool_decision",
    "GrammarVocab", "TokenConstraint", "build_tool_grammar",
]
