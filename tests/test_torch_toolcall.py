"""The port's tool-decision parser against the JAX package's, over the cases
of tests/test_toolcall.py (the prompt contract's few-shots) and the plot
calls of tests/test_constrained.py: equal ``ToolCall``s (or None) from both
packages, and the same error type where one raises."""

import dataclasses

import pytest

from finchat_tpu.agent.toolcall import VALIDATORS as JAX_VALIDATORS
from finchat_tpu.agent.toolcall import parse_tool_decision as jax_parse
from finchat_tpu_torch.agent.toolcall import VALIDATORS, parse_tool_decision

CASES = [
    "No tool call",
    "  no tool call  ",
    "",
    'Call tool: retrieve_transactions({"search_query": "grocery store purchases", '
    '"num_transactions": 20})',
    'retrieve_transactions({"search_query": "all purchases", "time_period_days": 2})',
    'retrieve_transactions({"search_query": "x", "user_id": "attacker"})',
    'retrieve_transactions({"num_transactions": 999999})',
    'retrieve_transactions({"num_transactions": -3})',
    "retrieve_transactions({search_query: broken",
    "I think we should check the weather.",
    'retrieve_transactions({\n  "search_query": "rent",\n  "time_period_days": 90\n})',
    'create_financial_plot({"chart_type": "pie", "title": "Food", "num_transactions": 50})',
    'create_financial_plot({"chart_type": "donut"})',
    'retrieve_transactions(["not", "a", "dict"])',
    'retrieve_transactions({"num_transactions": true, "time_period_days": 0})',
    "create_financial_plot",
]


def _outcome(parse, text):
    try:
        call = parse(text)
    except Exception as e:  # the error type is part of the contract
        return ("raises", type(e).__name__)
    return None if call is None else (call.name, call.args)


@pytest.mark.parametrize("text", CASES)
def test_parse_tool_decision_matches_jax(text):
    assert _outcome(parse_tool_decision, text) == _outcome(jax_parse, text)


@pytest.mark.parametrize("text", [None, 5, b"retrieve_transactions({})"])
def test_non_text_input_raises_the_same_error_type(text):
    got = _outcome(parse_tool_decision, text)
    assert got[0] == "raises" and got == _outcome(jax_parse, text)


def test_validators_and_tool_call_shape_match_jax():
    assert set(VALIDATORS) == set(JAX_VALIDATORS)
    raw = {"search_query": " ", "num_transactions": 3.7, "chart_type": "line", "title": ""}
    for name in VALIDATORS:
        assert VALIDATORS[name](raw) == JAX_VALIDATORS[name](raw)
    call = parse_tool_decision('retrieve_transactions({"time_period_days": 30})')
    assert [f.name for f in dataclasses.fields(call)] == ["name", "args"]
