"""Grammar-constrained decoding for the tool-decision step (own copy of the
JAX package's ``agent/constrained.py``; the host-side arithmetic is the
same numpy).

The decision model emits free text, so the output grammar (the
``prompts/tool_prompt.txt`` contract) is compiled to a character-level DFA:

    output := "No tool call"
            | "retrieve_transactions(" json_args ")"
            | "create_financial_plot(" json_args ")"
    json_args := "{" (pair ("," pair)*)? "}"
    pair := '"'key'"' ":" value          key in {search_query,
            num_transactions, time_period_days} (plot: also chart_type,
            title); string, enum or positive-int values

At each step the DFA state induces a vocab bitmask (which token strings keep
the output inside the grammar); masks are cached per DFA state, so steady
states (inside a string value, inside an integer) cost one vocab scan. The
scheduler picks on the host from the masked logits row of the slot and
writes the pick back as the slot's next decode input: one [vocab] fp32 row
crosses to the host per constrained step, only while a constrained sequence
is in the step.

``user_id`` is not in the grammar: the model cannot spell an argument the
executor would have to distrust.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEAD = -1

_WS = " \n\t"


class CharDFA:
    """Explicit-state character DFA with char classes and EOS-accepting
    states. States are ints; DEAD (-1) is the reject sink."""

    def __init__(self) -> None:
        self.edges: list[dict[str, int]] = []
        self.classes: list[list[tuple[Callable[[str], bool], int]]] = []
        self.eos_ok: list[bool] = []
        self.start = self.new_state()

    def new_state(self, eos_ok: bool = False) -> int:
        self.edges.append({})
        self.classes.append([])
        self.eos_ok.append(eos_ok)
        return len(self.edges) - 1

    def edge(self, src: int, chars: str, dst: int) -> None:
        for ch in chars:
            self.edges[src][ch] = dst

    def edge_class(self, src: int, pred: Callable[[str], bool], dst: int) -> None:
        self.classes[src].append((pred, dst))

    def literal(self, src: int, text: str, dst: int | None = None, eos_ok: bool = False) -> int:
        """Chain states spelling ``text`` from ``src``; returns the end state."""
        cur = src
        for i, ch in enumerate(text):
            last = i == len(text) - 1
            nxt = (dst if dst is not None and last else None)
            if nxt is None:
                nxt = self.edges[cur].get(ch)
                if nxt is None:
                    nxt = self.new_state(eos_ok=eos_ok and last)
            self.edge(cur, ch, nxt)
            cur = nxt
        return cur

    def step(self, state: int, ch: str) -> int:
        if state == DEAD:
            return DEAD
        nxt = self.edges[state].get(ch)
        if nxt is not None:
            return nxt
        for pred, dst in self.classes[state]:
            if pred(ch):
                return dst
        return DEAD

    def step_string(self, state: int, text: str) -> int:
        for ch in text:
            state = self.step(state, ch)
            if state == DEAD:
                return DEAD
        return state


def _string_char(ch: str) -> bool:
    # JSON string body without escapes: printable, no quote/backslash.
    # '}' and ')' are also excluded so every grammatical output stays inside
    # what toolcall.py's non-greedy extraction regex can parse (grammar ⊆
    # parser invariant — tested by test_every_accepted_output_parses).
    return ch not in '"\\})' and (ch >= " ") and ch != "\x7f"


# single source of truth for tool names / literals / chart enum: the parser
# module — grammar and validator must not drift apart (grammar ⊆ parser)
from finchat_tpu_torch.agent.toolcall import (  # noqa: E402
    CHART_TYPES,
    NO_TOOL_LITERAL,
    PLOT_TOOL_NAME,
    TOOL_NAME,
)

# key -> value kind; kind is "string", "int", or a tuple of enum literals
_RETRIEVAL_KEYS: dict[str, Any] = {
    "search_query": "string",
    "num_transactions": "int",
    "time_period_days": "int",
}
_PLOT_KEYS: dict[str, Any] = {
    "chart_type": CHART_TYPES,
    "title": "string",
    **_RETRIEVAL_KEYS,  # plot data comes from a server-side retrieval
}
TOOL_GRAMMARS: dict[str, dict[str, Any]] = {
    TOOL_NAME: _RETRIEVAL_KEYS,
    PLOT_TOOL_NAME: _PLOT_KEYS,
}


def _bound_whitespace(d: CharDFA, max_ws: int = 2) -> None:
    """Unroll every whitespace self-loop into a ≤max_ws chain.

    Unbounded ws loops let a weak/adversarial model spend its whole token
    budget emitting tabs while staying "in grammar"; bounding them makes
    whitespace progress-neutral at most ``max_ws`` chars per position."""
    for s in range(len(d.edges)):
        if not any(d.edges[s].get(ch) == s for ch in _WS):
            continue
        base_edges = {ch: t for ch, t in d.edges[s].items() if not (ch in _WS and t == s)}
        base_classes = list(d.classes[s])
        prev = s
        for _ in range(max_ws):
            nxt = d.new_state(eos_ok=d.eos_ok[s])
            d.edges[nxt] = dict(base_edges)
            d.classes[nxt] = list(base_classes)
            for ch in _WS:
                d.edges[prev][ch] = nxt
            prev = nxt
        for ch in _WS:
            d.edges[prev].pop(ch, None)


def _add_tool_call(d: CharDFA, name: str, keys: dict[str, Any]) -> None:
    """Add one ``name({...})`` alternative with its own key/value machine."""
    pre_obj = d.literal(d.start, name + "(")
    d.edge(pre_obj, _WS, pre_obj)
    key_or_close = d.new_state()
    d.edge(pre_obj, "{", key_or_close)
    d.edge(key_or_close, _WS, key_or_close)

    obj_done = d.new_state()
    d.edge(obj_done, _WS, obj_done)
    done_call = d.new_state(eos_ok=True)
    d.edge(obj_done, ")", done_call)
    d.edge(key_or_close, "}", obj_done)

    after_val = d.new_state()
    d.edge(after_val, _WS, after_val)
    pre_key = d.new_state()
    d.edge(after_val, ",", pre_key)
    d.edge(after_val, "}", obj_done)
    d.edge(pre_key, _WS, pre_key)

    key_start = d.new_state()
    d.edge(key_or_close, '"', key_start)
    d.edge(pre_key, '"', key_start)

    for key, kind in keys.items():
        key_end = d.literal(key_start, key)
        pre_colon = d.new_state()
        d.edge(key_end, '"', pre_colon)
        d.edge(pre_colon, _WS, pre_colon)
        pre_val = d.new_state()
        d.edge(pre_colon, ":", pre_val)
        d.edge(pre_val, _WS, pre_val)
        if kind == "string":
            in_str = d.new_state()
            d.edge(pre_val, '"', in_str)
            d.edge_class(in_str, _string_char, in_str)
            d.edge(in_str, '"', after_val)
        elif isinstance(kind, tuple):  # enum of string literals
            for value in kind:
                d.literal(pre_val, f'"{value}"', dst=after_val)
        else:  # positive int, JSON-valid (no leading zeros: 0 | [1-9][0-9]*)
            in_int = d.new_state()
            int_zero = d.new_state()
            d.edge(pre_val, "0", int_zero)
            d.edge(pre_val, "123456789", in_int)
            d.edge(in_int, "0123456789", in_int)
            # ints have no closing char: terminator edges double as after_val
            for int_state in (in_int, int_zero):
                d.edge(int_state, ",", pre_key)
                d.edge(int_state, "}", obj_done)
                d.edge(int_state, _WS, after_val)


def build_tool_grammar() -> CharDFA:
    """DFA for the tool-decision output contract (module docstring)."""
    d = CharDFA()
    d.edge(d.start, _WS, d.start)  # tolerate leading whitespace

    # alternative 1: the no-tool literal, then EOS
    d.literal(d.start, NO_TOOL_LITERAL, eos_ok=True)

    # one alternative per tool: retrieve_transactions({...}) and
    # create_financial_plot({...})
    for name, keys in TOOL_GRAMMARS.items():
        _add_tool_call(d, name, keys)
    _bound_whitespace(d)
    return d


def _distance_to_accept(dfa: CharDFA) -> list[int]:
    """Min chars from each state to an EOS-accepting state (Bellman fixed
    point over explicit + class edges; unreachable = a large sentinel)."""
    INF = 1 << 30
    n = len(dfa.edges)
    dist = [0 if dfa.eos_ok[s] else INF for s in range(n)]
    changed = True
    while changed:
        changed = False
        for s in range(n):
            best = 0 if dfa.eos_ok[s] else INF
            for t in dfa.edges[s].values():
                if dist[t] + 1 < best:
                    best = dist[t] + 1
            for _, t in dfa.classes[s]:
                if dist[t] + 1 < best:
                    best = dist[t] + 1
            if best < dist[s]:
                dist[s] = best
                changed = True
    return dist


def token_texts(tokenizer) -> list[str]:
    """Exact per-token emitted text for every vocab id.

    ``decode([i])`` is NOT it for SentencePiece-style tokenizers: single-
    token decode strips the leading-space marker ('▁foo' → 'foo'), so a
    DFA fed those strings diverges from the real stream ('Notoolcall' vs
    'No tool call'). When the tokenizer exposes ``convert_ids_to_tokens``,
    map pieces directly: '▁' → space, '<0xNN>' byte-fallback → that byte;
    otherwise (byte-level vocabs, tiktoken-style BPE where decode is exact)
    fall back to decode([i]).
    """
    inner = getattr(tokenizer, "_tok", None)
    convert = getattr(inner, "convert_ids_to_tokens", None)
    if convert is None:
        return [tokenizer.decode([i]) for i in range(tokenizer.vocab_size)]

    pieces = convert(list(range(tokenizer.vocab_size)))
    special_ids = set(getattr(inner, "all_special_ids", []) or [])
    texts: list[str] = []
    for i, piece in enumerate(pieces):
        if piece is None or i in special_ids:
            texts.append("")
        elif len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
            try:
                texts.append(bytes([int(piece[3:5], 16)]).decode("utf-8", errors="replace"))
            except ValueError:
                texts.append("")
        elif "▁" in piece:  # SentencePiece space marker
            texts.append(piece.replace("▁", " "))
        elif "Ġ" in piece or "Ċ" in piece:  # GPT-2 byte-level markers
            texts.append(tokenizer.decode([i]))
        else:
            texts.append(tokenizer.decode([i]))
    return texts


_DEAD_ROW_CHAR_REP = "é"  # representative non-ASCII printable char


class GrammarVocab:
    """A grammar bound to a tokenizer's vocab: per-DFA-state token masks.

    The DFA is compiled to a dense byte-level transition table so one
    state's vocab mask is a handful of numpy gathers (max-token-len steps
    over [vocab] arrays), never a Python scan — cheap enough to run on the
    scheduler loop. Bytes ≥ 0x80 (any non-ASCII UTF-8 byte) transition like
    a representative printable non-ASCII char: legal inside string values,
    DEAD elsewhere — exactly the grammar's intent, since every structural
    char is ASCII. Masks are cached per state and shared by every request
    using this (grammar, tokenizer) pair.
    """

    def __init__(self, dfa: CharDFA, token_strs: Sequence[str], eos_id: int):
        self.dfa = dfa
        self.token_strs = list(token_strs)
        self.eos_id = eos_id
        self._mask_cache: dict[int, tuple[np.ndarray, bool, np.ndarray]] = {}
        # token -> end-state transition cache, keyed by (state, token_id)
        self._step_cache: dict[tuple[int, int], int] = {}
        self.distance = _distance_to_accept(dfa)
        # distance indexed by end-state row (DEAD row = unreachable sentinel)
        self._distance_np = np.asarray(self.distance + [1 << 30], np.int64)

        # dense transitions: row per state + absorbing DEAD row (last)
        n = len(dfa.edges)
        self._dead_row = n
        table = np.full((n + 1, 256), self._dead_row, np.int32)
        for s in range(n):
            for b in range(128):
                nxt = dfa.step(s, chr(b))
                table[s, b] = self._dead_row if nxt == DEAD else nxt
            nxt = dfa.step(s, _DEAD_ROW_CHAR_REP)
            table[s, 128:] = self._dead_row if nxt == DEAD else nxt
        self._table = table

        # token byte matrix [V, Lmax] + lengths; empty tokens never allowed
        encoded = [t.encode("utf-8") for t in self.token_strs]
        self._tok_lens = np.asarray([len(e) for e in encoded], np.int32)
        lmax = max(1, int(self._tok_lens.max()))
        mat = np.zeros((len(encoded), lmax), np.uint8)
        for i, e in enumerate(encoded):
            mat[i, : len(e)] = np.frombuffer(e, np.uint8)
        self._tok_bytes = mat

    @classmethod
    def for_tokenizer(cls, tokenizer) -> "GrammarVocab":
        return cls(build_tool_grammar(), token_texts(tokenizer), tokenizer.eos_id)

    def mask(self, state: int) -> tuple[np.ndarray, bool, np.ndarray]:
        """(allowed[vocab] bool, eos_allowed, end_state[vocab]) for a state.

        ``end_state[t]`` is the DFA row after emitting token t (the DEAD row
        when t is not allowed) — pick() uses it with ``distance`` to keep
        generation inside the remaining token budget.
        """
        cached = self._mask_cache.get(state)
        if cached is not None:
            return cached
        V, L = self._tok_bytes.shape
        states = np.full((V,), self._dead_row if state == DEAD else state, np.int32)
        for j in range(L):
            live = j < self._tok_lens
            states = np.where(live, self._table[states, self._tok_bytes[:, j]], states)
        allowed = (states != self._dead_row) & (self._tok_lens > 0)
        eos_ok = state != DEAD and self.dfa.eos_ok[state]
        self._mask_cache[state] = (allowed, eos_ok, states)
        return allowed, eos_ok, states

    def advance(self, state: int, token_id: int) -> int:
        key = (state, token_id)
        nxt = self._step_cache.get(key)
        if nxt is None:
            nxt = self.dfa.step_string(state, self.token_strs[token_id])
            self._step_cache[key] = nxt
        return nxt


class TokenConstraint:
    """Per-request DFA cursor over a shared GrammarVocab."""

    def __init__(self, vocab: GrammarVocab):
        self.vocab = vocab
        self.state = vocab.dfa.start

    def pick(
        self,
        logits: np.ndarray,
        temperature: float,
        rng: np.random.Generator,
        remaining: int | None = None,
        top_p: float = 1.0,
        top_k: int = 0,
    ) -> int:
        """Sample one token from the grammar-masked logits and advance.

        ``remaining`` (tokens left in the budget, this one included) arms the
        feasibility invariant: a token is only allowed if its successor state
        can still reach an accepting state within the budget left AFTER it
        (chars-to-accept ≤ tokens-left - 1, since every token emits ≥1 char).
        Maintained every step, this guarantees the grammar closes in time —
        a one-shot "closing mode" is not enough, because distance-to-accept
        can jump above the budget in a single step (e.g. opening a long key).

        Returns ``eos_id`` when the grammar is complete (or unsatisfiable —
        which degrades to the no-tool path downstream, never a crash).
        """
        allowed, eos_ok, ends = self.vocab.mask(self.state)
        if remaining is not None:
            feasible = allowed & (self.vocab._distance_np[ends] <= remaining - 2)
            if feasible.any() or eos_ok:
                allowed = feasible
            else:
                logger.warning(
                    "no budget-feasible token at state %d (remaining=%d); forcing EOS",
                    self.state, remaining,
                )
                return self.vocab.eos_id
        if eos_ok:
            allowed = allowed.copy()
            allowed[self.vocab.eos_id] = True
        if not allowed.any():
            if eos_ok:
                return self.vocab.eos_id
            logger.warning("constraint unsatisfiable at state %d; forcing EOS", self.state)
            return self.vocab.eos_id

        masked = np.where(allowed, logits.astype(np.float64), -np.inf)
        if temperature <= 0.0:
            token = int(masked.argmax())
        else:
            # same top-k/top-p semantics as the device sampler
            # (engine/sampler.py), applied to the grammar-masked logits
            z = masked / temperature
            if top_k and top_k > 0:
                kth = np.partition(z, -top_k)[-top_k]
                z = np.where(z < kth, -np.inf, z)
            if top_p < 1.0:
                order = np.argsort(-z)
                zs = z[order]
                probs = np.exp(zs - zs.max())
                probs /= probs.sum()
                cum = np.cumsum(probs)
                keep_sorted = (cum - probs) < top_p
                keep_sorted[0] = True
                drop = order[~keep_sorted]
                z[drop] = -np.inf
            z -= z.max()
            p = np.exp(z)
            p /= p.sum()
            token = int(rng.choice(len(p), p=p))
        if token != self.vocab.eos_id:
            self.state = self.vocab.advance(self.state, token)
        return token
