"""Prompt-lookup draft proposal for speculative decoding (the JAX
package's ``engine/spec.py``, kept as the port's own copy).

A Penny answer quotes the retrieved transaction rows and the chat history
that the rendered prompt holds, so generated text overlaps the prompt.
Prompt-lookup decoding drafts those continuations on the host from the
sequence's own token history (n-gram matching): no draft model and no
extra device memory, and the verify step (``engine.verify_step``) scores
every draft in one weights-read. On a miss a sequence decodes one token, as
the plain path does, greedy-identical. The scheduler's spec mode runs at
depth 1, so on sustained all-miss traffic it gives up the depth-2
device/host overlap; it drops back to the pipelined path after
``SPEC_MISS_DEMOTE`` consecutive empty or all-rejected proposals.

``NgramIndex`` is incremental — O(n-gram widths) a pushed token, O(1) a
proposal — because the scheduler proposes on the event loop every verify
step for every greedy slot.
"""

from __future__ import annotations


class NgramIndex:
    """Incremental most-recent-occurrence index over a token history.

    For each n in ``[min_ngram, ngram]`` tracks where the latest and
    second-latest occurrence of every n-gram CONTINUES (the position right
    after it). ``propose`` matches the history's suffix n-gram (longest n
    first) against its second-latest occurrence — the latest is always the
    suffix itself — and drafts the tokens that followed it.
    """

    def __init__(self, history: list[int] | None = None, *,
                 ngram: int = 3, min_ngram: int = 2, max_history: int = 4096):
        assert 1 <= min_ngram <= ngram
        self._ns = tuple(range(ngram, min_ngram - 1, -1))  # longest first
        self._h: list[int] = []
        self._latest: dict[tuple, int] = {}
        self._prev: dict[tuple, int] = {}
        # the initial build is bounded: the scheduler builds lazily on the
        # event loop at a slot's first spec step
        for tok in (history or [])[-max_history:]:
            self.push(tok)

    def push(self, token: int) -> None:
        """Append one token and index the n-grams it completes."""
        h = self._h
        h.append(token)
        L = len(h)
        for n in self._ns:
            if L >= n:
                key = (n, *h[L - n:])
                old = self._latest.get(key)
                if old is not None:
                    self._prev[key] = old
                self._latest[key] = L  # continuation starts here

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the current history, or
        ``[]`` when no suffix n-gram recurred earlier."""
        h = self._h
        L = len(h)
        if k <= 0:
            return []
        for n in self._ns:
            if L < n + 1:
                continue
            key = (n, *h[L - n:])
            start = self._latest.get(key)
            if start == L:  # the suffix's own entry; use the one before
                start = self._prev.get(key)
            if start is not None and start < L:
                return h[start:start + k]
        return []


def propose_ngram_drafts(history: list[int], k: int, *, ngram: int = 3, min_ngram: int = 2,
                         max_history: int = 4096) -> list[int]:
    """One-shot wrapper over ``NgramIndex`` (a live sequence keeps a
    persistent index instead — see the scheduler)."""
    if k <= 0:
        return []
    return NgramIndex(history, ngram=ngram, min_ngram=min_ngram,
                      max_history=max_history).propose(k)
