"""Conversation store (Mongo semantics; own copy of the JAX package's
``io/store.py``).

- db ``conversations``, collections ``contexts`` / ``messages``.
- ``get_context`` renders the context doc into the first-person
  natural-language block the prompts carry and returns ``(context,
  user_id)``; a missing doc or a missing user id raises ``LookupError``.
- ``get_history`` returns the turns sorted by ascending timestamp and
  raises ``LookupError`` when there are none (the app writes the user
  message before publishing it to Kafka).
- ``save_ai_message`` inserts ``{conversation_id, sender: "AIMessage",
  user_id, message, timestamp:int}``.

Backends: ``InMemoryStore`` (in-process) and ``MongoStore`` (``pymongo`` run
in the default thread executor, so the event loop never blocks on
pymongo). ``pymongo`` and ``certifi`` are imported when a ``MongoStore`` is
built, not before.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Protocol

from finchat_tpu_torch.io.schemas import AI_SENDER, USER_SENDER, ChatMessage
from finchat_tpu_torch.utils.config import (
    CONTEXT_COLLECTION_NAME,
    MESSAGE_COLLECTION_NAME,
    StoreConfig,
)
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def render_context(context_doc: dict[str, Any]) -> str:
    """Render a context document to the user-context block, accounts
    normalized with the reference's defaults."""
    accounts = []
    for a in context_doc.get("accounts") or []:
        balance = a.get("balances", {}) or {}
        accounts.append(
            {
                "official_name": a.get("official_name", "Unnamed Account"),
                "current": balance.get("current", 0.0),
                "iso_currency_code": balance.get("iso_currency_code", ""),
            }
        )

    context = (
        f"My name is {context_doc['name']}.\n"
        f"I make {context_doc['income']} dollars a month.\n"
        f"I want to save {context_doc['savings_goal']} a month.\n\n"
    )

    context += "Here is a list of my current account balances:\n"
    for account in accounts:
        context += f"{account['official_name']} : {account['current']} {account['iso_currency_code']}\n"

    context += "Here is a list of my recurring monthly expenses:\n"
    for expense in context_doc.get("additional_monthly_expenses") or []:
        context += f"Name: {expense['name']} | Amount: {expense['amount']}"
        if expense["description"] != "":
            context += f" | Description: {expense['description']}"
        context += "\n"

    return context


def _history(rows, conversation_id: str) -> list[ChatMessage]:
    if not rows:
        raise LookupError(f"No chat history found for conversation_id: {conversation_id}")
    return [
        ChatMessage(
            sender=m["sender"],
            message=m["message"],
            user_id=m.get("user_id", ""),
            conversation_id=conversation_id,
            timestamp=m["timestamp"],
        )
        for m in rows
    ]


def _context(context_doc, conversation_id: str) -> tuple[str, str]:
    if not context_doc:
        raise LookupError(f"No context found for conversation_id: {conversation_id}")
    user_id = context_doc.get("user_id", "")
    if not user_id:
        raise LookupError(f"No user_id found in context for conversation_id: {conversation_id}")
    return render_context(context_doc), user_id


def _ai_doc(conversation_id: str, message: str, user_id: str) -> dict[str, Any]:
    return {
        "conversation_id": conversation_id,
        "sender": AI_SENDER,
        "user_id": user_id,
        "message": message,
        "timestamp": int(time.time()),
    }


class ConversationStore(Protocol):
    async def check_connection(self) -> None: ...

    async def get_context(self, conversation_id: str) -> tuple[str, str]: ...

    async def get_history(self, conversation_id: str) -> list[ChatMessage]: ...

    async def save_ai_message(self, conversation_id: str, message: str, user_id: str) -> None: ...


class InMemoryStore:
    """In-process store with the behavior above; ``upsert_context`` and
    ``add_user_message`` seed it (tests, development)."""

    def __init__(self, config: StoreConfig | None = None):
        self.config = config or StoreConfig()
        # touched only from the event loop, with no await inside a mutation
        self._contexts: dict[str, dict[str, Any]] = {}
        self._messages: list[dict[str, Any]] = []

    async def check_connection(self) -> None:
        logger.info("In-memory store ready")

    async def get_context(self, conversation_id: str) -> tuple[str, str]:
        return _context(self._contexts.get(conversation_id), conversation_id)

    async def get_history(self, conversation_id: str) -> list[ChatMessage]:
        rows = sorted(
            (m for m in self._messages if m["conversation_id"] == conversation_id),
            key=lambda m: m["timestamp"],
        )
        return _history(rows, conversation_id)

    async def save_ai_message(self, conversation_id: str, message: str, user_id: str) -> None:
        self._messages.append(_ai_doc(conversation_id, message, user_id))

    # --- seeding ----------------------------------------------------------
    def upsert_context(self, conversation_id: str, context_doc: dict[str, Any]) -> None:
        self._contexts[conversation_id] = {"conversation_id": conversation_id, **context_doc}

    def add_user_message(self, conversation_id: str, message: str, user_id: str,
                         timestamp: int | None = None) -> None:
        self._messages.append(
            {
                "conversation_id": conversation_id,
                "sender": USER_SENDER,
                "user_id": user_id,
                "message": message,
                "timestamp": int(time.time()) if timestamp is None else timestamp,
            }
        )


class MongoStore:
    """pymongo-backed store; every blocking pymongo call runs in the default
    thread executor."""

    def __init__(self, config: StoreConfig):
        try:
            import certifi  # type: ignore
            import pymongo  # type: ignore
        except ImportError:
            raise RuntimeError("store.backend=mongo but pymongo is not installed") from None
        self.config = config
        self._client = pymongo.MongoClient(config.mongodb_uri, tls=True, tlsCAFile=certifi.where())
        db = self._client[config.database_name]
        self._contexts = db[CONTEXT_COLLECTION_NAME]
        self._messages = db[MESSAGE_COLLECTION_NAME]

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    async def check_connection(self) -> None:
        try:
            await self._run(self._client.admin.command, "ping")
            logger.info("MongoDB connection successful!")
        except Exception as e:
            logger.error("MongoDB connection failed: %s", e)
            raise RuntimeError(f"MongoDB connection failed: {e}") from e

    async def get_context(self, conversation_id: str) -> tuple[str, str]:
        doc = await self._run(self._contexts.find_one, {"conversation_id": conversation_id})
        return _context(doc, conversation_id)

    async def get_history(self, conversation_id: str) -> list[ChatMessage]:
        def _fetch():
            return list(self._messages.find({"conversation_id": conversation_id}).sort("timestamp", 1))

        return _history(await self._run(_fetch), conversation_id)

    async def save_ai_message(self, conversation_id: str, message: str, user_id: str) -> None:
        await self._run(self._messages.insert_one, _ai_doc(conversation_id, message, user_id))


def make_store(config: StoreConfig) -> ConversationStore:
    if config.backend == "mongo":
        return MongoStore(config)
    return InMemoryStore(config)
