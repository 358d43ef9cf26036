"""The port's chunk functions (``io/schemas.py``) against the JAX package's:
the same JSON bytes over generated inbound ``message_value``s, passthrough
fields included (after tests/test_schemas.py)."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

import finchat_tpu.io.schemas as jschemas  # noqa: E402
import finchat_tpu_torch.io.schemas as tschemas  # noqa: E402

INBOUND = {
    "message": "What did I spend on groceries?",
    "conversation_id": "conv-1",
    "user_id": "user-9",
    "extra_passthrough": 42,
}


def _values(seed: int, n: int = 24) -> list[dict]:
    """Inbound payloads with passthrough fields of every JSON type,
    including ones that shadow the chunk's own keys."""
    rng = np.random.default_rng(seed)
    words = ["groceries", "rent", "ünïcode ✓", "", "a\"quote", "new\nline", "💸"]
    out = []
    for i in range(n):
        v = {"message": str(rng.choice(words)) * int(rng.integers(1, 3)),
             "conversation_id": f"conv-{i}", "user_id": f"u{int(rng.integers(100))}"}
        for k in range(int(rng.integers(0, 4))):
            kind = int(rng.integers(0, 6))
            v[f"extra_{k}"] = [int(rng.integers(-5, 5)), float(rng.random()), None,
                               bool(rng.integers(2)), str(rng.choice(words)),
                               {"nested": [1, "x"]}][kind]
        if rng.random() < 0.3:
            v["message_id"] = f"mid-{i}"
        if rng.random() < 0.2:  # a passthrough that the chunk overrides
            v[str(rng.choice(["type", "error", "last_message", "sender"]))] = "client"
        out.append(v)
    return out


def _chunk_fns(mod):
    return {
        "response": lambda v: mod.response_chunk(v, "chunk ✓ text"),
        "complete": mod.complete_chunk,
        "plot": lambda v: mod.plot_chunk(v, "data:image/png;base64,AAAA"),
        "error": mod.error_chunk,
        "error_coded": lambda v: mod.error_chunk(v, code="deadline_exceeded", retryable=True),
        "error_code_only": lambda v: mod.error_chunk(v, code="overloaded"),
        "timeout": mod.timeout_chunk,
    }


@pytest.mark.parametrize("kind", list(_chunk_fns(jschemas)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_bytes_equal(kind, seed):
    want_fn, got_fn = _chunk_fns(jschemas)[kind], _chunk_fns(tschemas)[kind]
    for v in _values(seed):
        want, got = want_fn(dict(v)), got_fn(dict(v))
        assert json.dumps(got).encode() == json.dumps(want).encode()
        assert list(got) == list(want)  # key order is part of the bytes


def test_contract_shapes():
    assert tschemas.TIMEOUT_TEXT == jschemas.TIMEOUT_TEXT == "Request timed out. Please try again."
    assert (tschemas.USER_SENDER, tschemas.AI_SENDER) == (jschemas.USER_SENDER,
                                                          jschemas.AI_SENDER)
    assert tschemas.complete_chunk(INBOUND)["message"] == INBOUND["message"]
    assert "type" not in tschemas.error_chunk(INBOUND)
    assert "type" not in tschemas.timeout_chunk(INBOUND)
    assert tschemas.response_chunk(INBOUND, "Hello") == {
        **INBOUND, "message": "Hello", "last_message": False, "error": False,
        "sender": "AIMessage", "type": "response_chunk"}


def test_chat_message_fields_equal():
    a = tschemas.ChatMessage("UserMessage", "hi", "u", "c", 5)
    b = jschemas.ChatMessage("UserMessage", "hi", "u", "c", 5)
    assert vars(a) == vars(b) and a.is_user and b.is_user
