"""Token sampling on the device (no host round-trip per token).

Per-sequence sampling params are device tensors, so one decode step samples
a heterogeneous batch. Greedy is temperature <= 0 and is an exact argmax.
Noise comes from an explicit ``torch.Generator`` on the logits' device.

The truncation contract of the JAX package's sampler is kept:

- NO truncating slot in the batch (every ``top_k == 0`` and ``top_p >= 1``
  — the engine default): exact full-vocab categorical via Gumbel-argmax.
- otherwise, non-greedy sampling runs over the top ``CANDIDATES`` logits:
  top-k exact for ``top_k <= CANDIDATES`` (clamped above), top-p computed
  over the candidates with probabilities normalized by the FULL-vocab
  logsumexp.

The choice between the two is made on the device (both are computed and
selected with ``torch.where``), so sampling never syncs the host. The JAX
package draws its noise from ``jax.random``; the two packages agree on
greedy tokens exactly and on stochastic ones only in distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CANDIDATES = 64


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (see the module docstring for the
    truncation contract). Greedy (temperature 0) is always exact."""

    temperature: float = 0.5
    top_p: float = 1.0
    top_k: int = 0  # 0 = uncapped within CANDIDATES; clamped to CANDIDATES
    max_new_tokens: int = 1024
    seed: int = 0
    grammar: str | None = None  # constrained decoding: not ported yet


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    # -log(E) with E ~ Exp(1) is a standard Gumbel draw
    e = torch.empty(shape, dtype=torch.float32, device=device).exponential_(
        generator=generator)
    return -torch.log(e)


def sample(
    logits: torch.Tensor,  # [B, vocab] fp32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int, 0 = disabled
    *,
    candidates: int = CANDIDATES,
) -> torch.Tensor:
    """Sample next token ids [B] (int32) with per-sequence temperature /
    top-p / top-k."""
    B, V = logits.shape
    C = min(candidates, V)
    dev = logits.device
    logits = logits.float()
    greedy = temperature <= 0.0
    safe_temp = torch.where(greedy, torch.ones_like(temperature), temperature).float()
    scaled = logits / safe_temp[:, None]
    argmax = torch.argmax(logits, dim=-1)

    # exact full-vocab categorical (greedy rows get zero noise)
    noise = torch.where(greedy[:, None], torch.zeros((), device=dev),
                        _gumbel((B, V), generator, dev))
    full = torch.argmax(scaled + noise, dim=-1)

    # candidate-set sampling
    top_vals, top_idx = torch.topk(scaled, C, dim=-1)  # descending
    ranks = torch.arange(C, device=dev)[None, :]
    k_eff = torch.where(top_k > 0, top_k.clamp(max=C), torch.full_like(top_k, C))[:, None]
    keep = ranks < k_eff
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(top_vals - lse)
    cumprobs = torch.cumsum(probs, dim=-1)
    keep = keep & ((cumprobs - probs) < top_p[:, None])
    keep = keep | (ranks == 0)
    masked = torch.where(keep, top_vals, torch.full_like(top_vals, float("-inf")))
    choice = torch.argmax(masked + _gumbel((B, C), generator, dev), dim=-1)
    truncated = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    truncated = torch.where(greedy, argmax, truncated)

    no_truncation = torch.all((top_k <= 0) & (top_p >= 1.0))
    return torch.where(no_truncation, full, truncated).to(torch.int32)
