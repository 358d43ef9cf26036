"""Tokenizers, streaming detokenizer and chat template.

- ``ByteTokenizer``: UTF-8 byte-level vocab (256 bytes + specials), so the
  whole stack runs with zero downloaded assets. ``get_tokenizer("")``
  returns it.
- ``HFTokenizer``: a local HuggingFace tokenizer directory
  (``tokenizer.json`` and its ``tokenizer_config.json``) over the
  ``tokenizers`` package, giving what the JAX package's ``HFTokenizer``
  (``transformers.AutoTokenizer``, a fast tokenizer) gives: the same ids,
  texts, special ids and framing. ``get_tokenizer(path)`` returns it.
- ``IncrementalDecoder``: UTF-8-safe streaming detokenization (a multibyte
  codepoint split across two decode steps must not emit mojibake).
- ``render_chat``: system(system_prompt + "\\n" + context) / history / user,
  with the assistant tag left open — byte-identical to the JAX package's
  template, so both packages tokenize the same prompt to the same ids.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Protocol, Sequence

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

    def encode_with_specials(self, text: str) -> list[int]:
        """Encoder-style framing (the embedding path's [CLS]...[SEP])."""
        return [self.bos_id] + self.encode(text) + [self.eos_id]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


# the special-token attributes of a transformers tokenizer, in its order
_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                  "cls_token", "mask_token", "additional_special_tokens")


def _content(token: str | dict) -> str:
    """A special token's text: configs give a string or an ``AddedToken``
    dict."""
    return token["content"] if isinstance(token, dict) else token


def _clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``: spaces before punctuation
    and English contractions dropped."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!").replace(" ,", ",")
            .replace(" ' ", "'").replace(" n't", "n't").replace(" 'm", "'m")
            .replace(" 's", "'s").replace(" 've", "'ve").replace(" 're", "'re"))


class _Backend:
    """The loaded ``tokenizers.Tokenizer`` with the two views of it that
    ``agent/constrained.token_texts`` reads, as a transformers fast
    tokenizer gives them: ``convert_ids_to_tokens`` and ``all_special_ids``
    (the ids of the special-token attributes only, not of every added
    special token)."""

    def __init__(self, tok: Any, special_tokens: list[str]):
        self.tok = tok
        self.all_special_ids = [tok.token_to_id(t) for t in special_tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> list[str | None]:
        return [self.tok.id_to_token(int(i)) for i in ids]


class HFTokenizer:
    """A local HuggingFace tokenizer directory (no network), read as
    ``transformers.AutoTokenizer`` reads a fast tokenizer:

    - ``tokenizer.json`` through ``tokenizers.Tokenizer.from_file``;
    - the special tokens from ``tokenizer_config.json`` (plain strings or
      ``{"content": ...}`` dicts); where the config has no
      ``added_tokens_decoder`` (a legacy one), ``special_tokens_map.json``'s
      values win; the config's ``added_tokens_decoder`` entries and the
      special tokens the vocabulary lacks are added as transformers adds
      them;
    - ``add_prefix_space`` forced onto the pre-tokenizer where its state
      disagrees, ``split_special_tokens``, and padding and truncation off;
    - ``decode`` skips special tokens and applies
      ``clean_up_tokenization_spaces`` where the config sets it (off where
      it leaves it out).

    The JAX package's quirks are kept: ``bos_id``/``eos_id`` fall back to 0,
    ``pad_id`` to ``eos_id``, and ``eot_id`` is ``eos_id``. The tokenizer
    class a config names is not emulated beyond this: its published
    ``tokenizer.json`` already carries its framing and normalizer."""

    def __init__(self, path: str | Path):
        try:
            from tokenizers import AddedToken, Tokenizer, pre_tokenizers
        except ImportError:
            raise ImportError(
                "a tokenizer path is set but the tokenizers package is not installed") from None
        root = Path(path)
        file = root / "tokenizer.json"
        if not file.is_file():
            raise FileNotFoundError(f"{root}: no tokenizer.json (the port reads only a fast "
                                    "tokenizer's tokenizer.json)")
        tok = Tokenizer.from_file(str(file))
        config = _read_json(root / "tokenizer_config.json")
        specials: dict[str, Any] = {k: config[k] for k in _SPECIAL_ATTRS if k in config}
        if "added_tokens_decoder" not in config:
            # a config without it is a legacy one: the map's values win
            for key, value in _read_json(root / "special_tokens_map.json").items():
                if key == "additional_special_tokens" and isinstance(value, list):
                    merged = list(specials.get(key) or [])
                    value = merged + [t for t in value if t not in merged]
                specials[key] = value

        def added(value: Any, special: bool):
            if isinstance(value, dict):
                kwargs = {k: value[k] for k in ("single_word", "lstrip", "rstrip", "normalized")
                          if k in value}
                return AddedToken(value["content"], special=special or value.get("special",
                                                                                 False), **kwargs)
            return AddedToken(value, special=special)

        # every special token, in the attributes' order, each once
        extended: list = []
        seen: set = set()
        for key in _SPECIAL_ATTRS:
            values = specials.get(key)
            for value in (values if isinstance(values, list) else [values] if values else []):
                if _content(value) not in seen:
                    seen.add(_content(value))
                    extended.append(value)
        special_texts = [_content(v) for v in extended]
        present = {t.content for t in tok.get_added_tokens_decoder().values()}
        to_add = []
        for _idx, value in sorted(((int(i), v) for i, v in
                                   config.get("added_tokens_decoder", {}).items())):
            if value["content"] not in present:
                to_add.append(added(value, value["content"] in special_texts))
                present.add(value["content"])
        to_add += [added(v, True) for v, text in zip(extended, special_texts)
                   if text not in present]
        if to_add:
            tok.add_tokens(to_add)
        tok.encode_special_tokens = bool(config.get("split_special_tokens", False))
        add_prefix_space = config.get("add_prefix_space", False)
        try:
            state = json.loads(tok.pre_tokenizer.__getstate__())
            if state.get("add_prefix_space", add_prefix_space) != add_prefix_space:
                cls = getattr(pre_tokenizers, state.pop("type"))
                state["add_prefix_space"] = add_prefix_space
                tok.pre_tokenizer = cls(**state)
        except (AttributeError, TypeError, ValueError):
            pass  # no pre-tokenizer, or one that cannot be rebuilt from its state
        tok.no_padding()
        tok.no_truncation()
        self._tok = _Backend(tok, special_texts)
        self._clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        self.vocab_size = tok.get_vocab_size(with_added_tokens=True)

        def token_id(attr: str) -> int | None:
            value = specials.get(attr)
            return tok.token_to_id(_content(value)) if value else None

        self.bos_id = token_id("bos_token") or 0
        self.eos_id = token_id("eos_token") or 0
        pad = token_id("pad_token")
        self.pad_id = pad if pad is not None else self.eos_id
        self.eot_id = self.eos_id

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tok.tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] if add_bos else []) + ids

    def encode_with_specials(self, text: str) -> list[int]:
        """The tokenizer's own special framing — [CLS]...[SEP] for BERT
        vocabularies (what bge embeddings expect), <s>... for Llama ones."""
        return self._tok.tok.encode(text, add_special_tokens=True).ids

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.tok.decode([int(i) for i in ids], skip_special_tokens=True)
        return _clean_up_tokenization(text) if self._clean_up else text


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf-8")) if path.is_file() else {}


def get_tokenizer(tokenizer_path: str = "") -> Tokenizer:
    if tokenizer_path:
        return HFTokenizer(tokenizer_path)
    return ByteTokenizer()


class IncrementalDecoder:
    """Streaming detokenizer that never emits a torn UTF-8 sequence. For a
    byte vocab a multibyte codepoint spans several ids, buffered until
    whole; for an HF tokenizer the same applies to byte-fallback pieces,
    handled by decoding the pending tail."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._pending: list[int] = []

    def push(self, token_id: int) -> str:
        """Feed one token id; return newly-safe text (possibly '')."""
        if isinstance(self._tok, ByteTokenizer):
            return self._push_byte(token_id)
        # decode the whole pending tail; emit only when the text does not
        # end in the replacement char (a torn byte-fallback sequence)
        self._pending.append(token_id)
        text = self._tok.decode(self._pending)
        if text and not text.endswith("\ufffd"):
            self._pending.clear()
            return text
        return ""

    def _push_byte(self, token_id: int) -> str:
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
