"""Byte tokenizer, streaming detokenizer and chat template.

- ``ByteTokenizer``: UTF-8 byte-level vocab (256 bytes + specials), so the
  whole stack runs with zero downloaded assets. ``get_tokenizer("")``
  returns it; a HuggingFace tokenizer directory is a later slice.
- ``IncrementalDecoder``: UTF-8-safe streaming detokenization (a multibyte
  codepoint split across two decode steps must not emit mojibake).
- ``render_chat``: system(system_prompt + "\\n" + context) / history / user,
  with the assistant tag left open — byte-identical to the JAX package's
  template, so both packages tokenize the same prompt to the same ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence

from finchat_tpu_torch.io.schemas import ChatMessage


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


@dataclass
class ByteTokenizer:
    """UTF-8 bytes 0..255, then PAD/BOS/EOS/EOT specials."""

    vocab_size: int = 260
    pad_id: int = 256
    bos_id: int = 257
    eos_id: int = 258
    eot_id: int = 259  # end-of-turn marker used by the chat template

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def get_tokenizer(tokenizer_path: str = "") -> Tokenizer:
    if tokenizer_path:
        raise NotImplementedError(
            "HuggingFace tokenizers are not ported yet; use tokenizer_path=''"
        )
    return ByteTokenizer()


class IncrementalDecoder:
    """Streaming detokenizer that never emits a torn UTF-8 sequence."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._pending: list[int] = []

    def push(self, token_id: int) -> str:
        """Feed one token id; return newly-safe text (possibly '')."""
        if token_id >= 256:
            return ""  # specials (and ids past the byte range) carry no text
        self._pending.append(token_id)
        raw = bytes(self._pending)
        try:
            text = raw.decode("utf-8")
            self._pending.clear()
            return text
        except UnicodeDecodeError as e:
            if len(raw) - e.start > 3:
                # a valid incomplete UTF-8 tail is <= 3 bytes; this is
                # garbage: emit with replacement instead of buffering forever
                self._pending.clear()
                return raw.decode("utf-8", errors="replace")
            valid = raw[: e.start].decode("utf-8")
            self._pending = list(raw[e.start:])
            return valid

    def flush(self) -> str:
        text = self._tok.decode(self._pending) if self._pending else ""
        self._pending.clear()
        return text


_ROLE_TAGS = {"system": "<|system|>", "user": "<|user|>", "assistant": "<|assistant|>"}


def render_chat_head(system_prompt: str) -> str:
    """The constant leading string of a rendered prompt for a system text."""
    return f"{_ROLE_TAGS['system']}\n{system_prompt}\n"


def render_chat_prefix(
    system_prompt: str,
    context: str,
    history: Sequence[ChatMessage],
) -> str:
    """Everything of a rendered prompt before the final user turn's content."""
    parts = [f"{render_chat_head(system_prompt)}{context}\n"]
    for turn in history:
        role = "user" if turn.is_user else "assistant"
        parts.append(f"{_ROLE_TAGS[role]}\n{turn.message}\n")
    parts.append(f"{_ROLE_TAGS['user']}\n")
    return "".join(parts)


def render_chat(
    system_prompt: str,
    context: str,
    history: Sequence[ChatMessage],
    user_input: str,
) -> str:
    """Render the prompt string fed to the decoder: one system turn holding
    ``{system_prompt}\\n{context}``, the history in order, the new user turn,
    then the assistant tag left open for generation."""
    return (
        f"{render_chat_prefix(system_prompt, context, history)}"
        f"{user_input}\n{_ROLE_TAGS['assistant']}\n"
    )
