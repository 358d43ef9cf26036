"""Text generation over the engine: prompt in, text chunks out.

``EngineGenerator`` is the seam the agent layer (a later slice) and
``serve/simple.py`` consume: it tokenizes the prompt, submits it to the
continuous-batching scheduler and streams the detokenized tokens.
"""

from __future__ import annotations

import itertools
from typing import AsyncIterator

from finchat_tpu_torch.engine.sampler import SamplingParams
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from finchat_tpu_torch.models.tokenizer import IncrementalDecoder, Tokenizer
from finchat_tpu_torch.utils.logging import get_logger

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


class EngineGenerator:
    def __init__(self, scheduler: ContinuousBatchingScheduler, tokenizer: Tokenizer):
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self._ids = itertools.count()

    def prompt_budget(self, sampling: SamplingParams) -> int:
        """Max prompt tokens a sequence may carry and still have room for
        ``max_new_tokens`` in its KV allocation."""
        eng = self.scheduler.engine
        max_len = eng.max_pages_per_seq * eng.page_size
        return max(1, max_len - sampling.max_new_tokens)

    async def stream(self, prompt: str, sampling: SamplingParams,
                     conversation_id: str | None = None,
                     deadline: float | None = None) -> AsyncIterator[str]:
        """Stream the detokenized response to ``prompt``. ``conversation_id``
        keys the scheduler's session KV cache (a later turn of the same
        conversation resumes this one's KV); None = no cross-turn reuse.
        ``deadline`` (``time.perf_counter``'s clock) feeds the scheduler's
        shedding and earliest-deadline-first admission; None = none."""
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
        handle = await self.scheduler.submit(f"seq-{next(self._ids)}", prompt_ids, sampling,
                                             conversation_id=conversation_id, deadline=deadline)
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
                       deadline: float | None = None) -> str:
        return "".join([piece async for piece in self.stream(
            prompt, sampling, conversation_id=conversation_id, deadline=deadline)])
