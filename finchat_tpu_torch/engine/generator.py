"""Text generation over the engine: prompt in, text chunks out.

``TextGenerator`` is the seam the agent layer consumes. Implementations:

- ``EngineGenerator``: the continuous-batching engine. It tokenizes the
  prompt, builds a grammar constraint for ``sampling.grammar``, submits to
  the scheduler and streams the detokenized tokens; ``begin_partial`` /
  ``release_partial`` and ``stream(..., partial=)`` carry the
  retrieval/prefill overlap.
- ``StubGenerator``: canned responses for tests and development without a
  card.
"""

from __future__ import annotations

import asyncio
import itertools
from typing import AsyncIterator, Callable, Protocol

from finchat_tpu_torch.engine.sampler import SamplingParams
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from finchat_tpu_torch.models.tokenizer import IncrementalDecoder, Tokenizer
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS, Timer

logger = get_logger(__name__)


class GenerationError(RuntimeError):
    """Generation failed (the scheduler emitted an error event). ``code`` and
    ``retryable`` carry the scheduler's structured fields when it gave them
    (a deadline shed, a shutdown), so the serving layer can answer with a
    retryable error instead of an opaque one."""

    def __init__(self, message: str, *, code: str | None = None, retryable: bool = False):
        super().__init__(message)
        self.code = code
        self.retryable = retryable


class TextGenerator(Protocol):
    # ``conversation_id`` keys the engine's session KV cache (None = no
    # cross-turn reuse); ``deadline`` (time.perf_counter's clock) feeds the
    # scheduler's shedding and EDF admission (None = none); ``trace_id``
    # puts the request on a trace timeline (utils/tracing.py; None =
    # untraced). Other implementations may ignore all three.
    async def stream(
        self, prompt: str, sampling: SamplingParams,
        conversation_id: str | None = None,
        deadline: float | None = None,
        trace_id: str | None = None,
    ) -> AsyncIterator[str]: ...

    async def generate(
        self, prompt: str, sampling: SamplingParams,
        conversation_id: str | None = None,
        deadline: float | None = None,
        trace_id: str | None = None,
    ) -> str: ...


class EngineGenerator:
    def __init__(self, scheduler: ContinuousBatchingScheduler, tokenizer: Tokenizer):
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self._ids = itertools.count()
        # grammar name -> the task building its GrammarVocab
        self._grammar_vocabs: dict[str, asyncio.Future] = {}

    def count_tokens(self, text: str) -> int:
        return len(self.tokenizer.encode(text, add_bos=True))

    def prompt_budget(self, sampling: SamplingParams) -> int:
        """Max prompt tokens a sequence may carry and still have room for
        ``max_new_tokens`` in its KV allocation."""
        eng = self.scheduler.engine
        max_len = eng.max_pages_per_seq * eng.page_size
        return max(1, max_len - sampling.max_new_tokens)

    async def _make_constraint(self, grammar: str):
        from finchat_tpu_torch.agent.constrained import GrammarVocab, TokenConstraint

        if grammar != "tool_call":
            raise ValueError(f"unknown grammar {grammar!r}")
        # single flight: the build task is cached, not its result, so
        # concurrent first requests share one O(vocab) build, run in a worker
        # thread so in-flight decodes are not stalled
        task = self._grammar_vocabs.get(grammar)
        if task is None:
            task = asyncio.ensure_future(
                asyncio.to_thread(GrammarVocab.for_tokenizer, self.tokenizer))
            self._grammar_vocabs[grammar] = task
        try:
            vocab = await task
        except Exception:
            # a failed build is evicted, so the next request retries it
            if self._grammar_vocabs.get(grammar) is task:
                del self._grammar_vocabs[grammar]
            raise
        return TokenConstraint(vocab)

    # --- retrieval/prefill overlap ----------------------------------------
    async def begin_partial(self, prefix_text: str, sampling: SamplingParams,
                            conversation_id: str | None = None,
                            deadline: float | None = None,
                            trace_id: str | None = None):
        """Start prefilling a prompt's static prefix while its tail (the
        retrieval graft) is still being computed. Returns a handle to pass
        to ``stream(..., partial=...)``, or None when the prefix cannot ride
        the overlap (over budget, or a grammar request: a constrained decode
        needs the host's control of every token). The last encoded token is
        dropped: a subword tokenizer can merge across the graft boundary, so
        it is the only prefix token whose identity depends on what
        follows."""
        if sampling.grammar:
            return None
        prefix_ids = self.tokenizer.encode(prefix_text, add_bos=True)[:-1]
        if not prefix_ids or len(prefix_ids) > self.prompt_budget(sampling):
            return None
        return await self.scheduler.submit_partial(
            f"seq-{next(self._ids)}", prefix_ids, sampling,
            conversation_id=conversation_id, deadline=deadline, trace_id=trace_id)

    def release_partial(self, partial) -> None:
        """Drop an unconsumed hold (retrieval failed before generation, or
        the caller gave up): frees its slot and pages. A hold that ``stream``
        already claimed is left alone."""
        if partial is not None and not getattr(partial, "_partial_claimed", False):
            self.scheduler.cancel(partial)

    async def stream(self, prompt: str, sampling: SamplingParams,
                     conversation_id: str | None = None,
                     partial=None,
                     deadline: float | None = None,
                     trace_id: str | None = None) -> AsyncIterator[str]:
        """Stream the detokenized response to ``prompt``. With ``partial``
        (a ``begin_partial`` hold) the full prompt is grafted onto the hold;
        when the graft is refused the hold is cancelled and the prompt
        submitted on its own."""
        prompt_ids = self.tokenizer.encode(prompt, add_bos=True)
        budget = self.prompt_budget(sampling)
        if len(prompt_ids) > budget:
            # keep the head (system rules) and the tail (latest turns + open
            # assistant tag) and drop the middle, so a too-long prompt still
            # answers instead of raising at submit
            head = budget // 4
            tail = budget - head
            logger.warning("prompt of %d tokens exceeds budget %d; splicing head %d + tail %d",
                           len(prompt_ids), budget, head, tail)
            prompt_ids = prompt_ids[:head] + prompt_ids[-tail:]
        handle = None
        if partial is not None:
            # claimed before the graft: whatever happens next, the hold is
            # this stream's to consume or cancel
            partial._partial_claimed = True
            with Timer(METRICS, "finchat_retrieval_graft_seconds"):
                grafted = self.scheduler.extend_prompt(partial, prompt_ids)
            if grafted:
                handle = partial
            else:
                # the graft point is gone (the prefix changed, a budget
                # splice, no pages): a clean serial fallback
                self.scheduler.cancel(partial)
        if handle is None:
            constraint = (await self._make_constraint(sampling.grammar)
                          if sampling.grammar else None)
            handle = await self.scheduler.submit(
                f"seq-{next(self._ids)}", prompt_ids, sampling, constraint=constraint,
                conversation_id=conversation_id, deadline=deadline, trace_id=trace_id)
        decoder = IncrementalDecoder(self.tokenizer)
        try:
            while True:
                event = await handle.events.get()
                if event["type"] == "token":
                    text = decoder.push(event["token_id"])
                    if text:
                        yield text
                elif event["type"] == "done":
                    tail = decoder.flush()
                    if tail:
                        yield tail
                    return
                else:
                    raise GenerationError(event["message"], code=event.get("code"),
                                          retryable=bool(event.get("retryable", False)))
        finally:
            if not handle.finished:
                self.scheduler.cancel(handle)

    async def generate(self, prompt: str, sampling: SamplingParams,
                       conversation_id: str | None = None,
                       partial=None,
                       deadline: float | None = None,
                       trace_id: str | None = None) -> str:
        return "".join([piece async for piece in self.stream(
            prompt, sampling, conversation_id=conversation_id, partial=partial,
            deadline=deadline, trace_id=trace_id)])


class StubGenerator:
    """Deterministic canned generator.

    ``rules`` maps a predicate over the prompt to a response; the first
    match wins, else ``default``. Streams word by word with an optional
    delay, to exercise real async interleaving in tests."""

    def __init__(self, default: str = "This is a canned response.",
                 rules: list[tuple[Callable[[str], bool], str]] | None = None,
                 chunk_delay: float = 0.0,
                 fail_with: str | None = None):
        self.default = default
        self.rules = rules or []
        self.chunk_delay = chunk_delay
        self.fail_with = fail_with
        self.calls: list[str] = []  # prompts seen, for test assertions

    def _respond(self, prompt: str) -> str:
        for predicate, response in self.rules:
            if predicate(prompt):
                return response
        return self.default

    async def stream(self, prompt: str, sampling: SamplingParams,
                     conversation_id: str | None = None,
                     deadline: float | None = None,
                     trace_id: str | None = None) -> AsyncIterator[str]:
        self.calls.append(prompt)
        if self.fail_with is not None:
            raise GenerationError(self.fail_with)
        pieces = self._respond(prompt).split(" ")
        for i, piece in enumerate(pieces):
            if self.chunk_delay:
                await asyncio.sleep(self.chunk_delay)
            yield piece + (" " if i < len(pieces) - 1 else "")

    async def generate(self, prompt: str, sampling: SamplingParams,
                       conversation_id: str | None = None,
                       deadline: float | None = None,
                       trace_id: str | None = None) -> str:
        return "".join([piece async for piece in self.stream(prompt, sampling)])
