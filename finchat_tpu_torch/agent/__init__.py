"""The agent: the three-node graph (``LLMAgent``, ``StateGraph``), the
streaming tool parser and launcher, its typed state, the tool-decision
parser and the grammar that constrains the decision decode."""

from finchat_tpu_torch.agent.constrained import GrammarVocab, TokenConstraint, build_tool_grammar
from finchat_tpu_torch.agent.graph import END, LLMAgent, StateGraph
from finchat_tpu_torch.agent.state import AgentState, ToolCall
from finchat_tpu_torch.agent.streamparse import StreamingToolParser, ToolLauncher
from finchat_tpu_torch.agent.toolcall import parse_tool_decision

__all__ = [
    "AgentState", "ToolCall", "LLMAgent", "StateGraph", "END",
    "parse_tool_decision", "StreamingToolParser", "ToolLauncher",
    "GrammarVocab", "TokenConstraint", "build_tool_grammar",
]
