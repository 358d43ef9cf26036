"""Agent-less streaming chain: the minimum end-to-end serving path.

``LLMService`` renders the same prompt structure the agent renders (system
+ context / history / user) and streams it straight through a text
generator — no graph, no retrieval, no status events.
"""

from __future__ import annotations

from typing import AsyncIterator, Sequence

from finchat_tpu_torch.engine.sampler import SamplingParams
from finchat_tpu_torch.io.schemas import ChatMessage
from finchat_tpu_torch.models.tokenizer import render_chat


class LLMService:
    """``prompt | llm`` with streaming, nothing else. The generator is any
    object with ``stream(prompt, sampling)`` — the engine-backed
    ``EngineGenerator`` in serving."""

    def __init__(self, generator, system_prompt: str,
                 sampling: SamplingParams | None = None):
        self.generator = generator
        self.system_prompt = system_prompt
        self.sampling = sampling or SamplingParams()

    async def process_message(
        self,
        message: str,
        context: str = "",
        chat_history: Sequence[ChatMessage] = (),
        system_prompt: str | None = None,
    ) -> AsyncIterator[str]:
        """Stream the response to one user message."""
        prompt = render_chat(
            system_prompt if system_prompt is not None else self.system_prompt,
            context, list(chat_history), message,
        )
        async for chunk in self.generator.stream(prompt, self.sampling):
            yield chunk
