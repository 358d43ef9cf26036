"""Chat-history record shape shared with the reference package.

``sender`` is ``"UserMessage"`` or ``"AIMessage"``; the chat template
(models/tokenizer.py ``render_chat``) reads ``is_user`` and ``message``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

USER_SENDER = "UserMessage"
AI_SENDER = "AIMessage"


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
