"""Wire schemas: the chat-history record and the outbound chunks.

These shapes are the product contract and match the reference byte for
byte:

- inbound ``user_message`` payload: ``{"message": ..., "conversation_id":
  ..., **passthrough}``; every inbound field is spread back into every
  outbound chunk.
- outbound ``ai_response`` chunk, completion marker (no ``message``
  override: it carries the original user text), error marker (no ``type``
  field) and timeout marker.
- chat-history records: ``sender`` is ``"UserMessage"`` or
  ``"AIMessage"``; the chat template (models/tokenizer.py ``render_chat``)
  reads ``is_user`` and ``message``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

USER_SENDER = "UserMessage"
AI_SENDER = "AIMessage"

TIMEOUT_TEXT = "Request timed out. Please try again."


@dataclass
class ChatMessage:
    """One turn of conversation history."""

    sender: str  # USER_SENDER | AI_SENDER
    message: str
    user_id: str = ""
    conversation_id: str = ""
    timestamp: int = field(default_factory=lambda: int(time.time()))

    @property
    def is_user(self) -> bool:
        return self.sender == USER_SENDER


def response_chunk(message_value: dict[str, Any], chunk_text: str) -> dict[str, Any]:
    """Outbound streaming chunk."""
    return {
        **message_value,
        "message": chunk_text,
        "last_message": False,
        "error": False,
        "sender": AI_SENDER,
        "type": "response_chunk",
    }


def complete_chunk(message_value: dict[str, Any]) -> dict[str, Any]:
    """Completion marker. ``message`` is not overridden: it still carries
    the original inbound user text."""
    return {
        **message_value,
        "last_message": True,
        "error": False,
        "sender": AI_SENDER,
        "type": "complete",
    }


def plot_chunk(message_value: dict[str, Any], data_uri: str) -> dict[str, Any]:
    """Chart chunk: the response chunk's envelope with ``type: "plot"`` and
    the PNG data URI as the message body, so consumers that know only
    ``response_chunk``/``complete`` ignore it."""
    return {
        **message_value,
        "message": data_uri,
        "last_message": False,
        "error": False,
        "sender": AI_SENDER,
        "type": "plot",
    }


def error_chunk(message_value: dict[str, Any], *, code: str | None = None,
                retryable: bool | None = None) -> dict[str, Any]:
    """Error marker: no ``type`` field and an empty ``message``.
    ``code``/``retryable`` are added only when given (a deadline shed, an
    overload, a shutdown), so the default shape stays the reference's."""
    chunk = {
        **message_value,
        "message": "",
        "last_message": True,
        "error": True,
        "sender": AI_SENDER,
    }
    if code is not None:
        chunk["code"] = code
    if retryable is not None:
        chunk["retryable"] = retryable
    return chunk


def timeout_chunk(message_value: dict[str, Any]) -> dict[str, Any]:
    """Watchdog-timeout marker: the error marker with the fixed
    user-visible text."""
    return {
        **message_value,
        "message": TIMEOUT_TEXT,
        "last_message": True,
        "error": True,
        "sender": AI_SENDER,
    }
