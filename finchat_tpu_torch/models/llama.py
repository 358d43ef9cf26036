"""Llama-family decoder in PyTorch (dense MLP), the JAX package's layout.

- Params are a plain dict with all layers STACKED on a leading axis:
  ``embed [vocab, dim]``, ``layers/attn_{q,k,v} [L, dim, heads*hd]``,
  ``layers/attn_o [L, heads*hd, dim]``, ``layers/mlp_{gate,up} [L, dim,
  hidden]``, ``layers/mlp_down [L, hidden, dim]``, ``layers/ln_{attn,mlp}
  [L, dim]``, ``norm [dim]``, ``lm_head [dim, vocab]`` — so a JAX tree
  converts leaf by leaf (models/convert.py). ``forward`` loops over layers
  in Python, indexing each stacked leaf; ``remat`` checkpoints each layer
  for training (train/train_step.py).
- Dtype policy of the reference: bf16 weights and activations; RMSNorm and
  RoPE math in fp32 (the normalized activations cast to the model dtype
  BEFORE the weight multiply); SiLU in fp32 then cast; fp32 logits.
- The attention inner op is a callback (``AttentionFn``), so the same
  forward serves chunked prefill, paged decode and the packed ragged round.
  The cache it receives is updated in place.
- Every matmul goes through ``models/quant.dense``: a plain weight is
  ``x @ w``, an int8/int4 leaf (``QTensor``/``Q4Tensor``, quantized serving)
  the fused dequant matmul; a quantized ``lm_head`` produces fp32 logits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, dense

# attention callback signature:
#   fn(q[B,S,H,D], k[B,S,Hkv,D], v[B,S,Hkv,D], cache, layer_idx) ->
#   (out[B,S,H,D], cache)
AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Any, int],
                       tuple[torch.Tensor, Any]]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 260
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    hidden_dim: int = 256
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    n_experts: int = 0  # MoE is not ported yet: must be 0
    top_k_experts: int = 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# Model shapes follow the public architecture cards; "tiny"/"mini" are
# random-weight debug configs.
PRESETS: dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(),
    "mini": LlamaConfig(vocab_size=260, dim=512, n_layers=8, n_heads=8, n_kv_heads=4,
                        hidden_dim=1536, max_seq_len=4096),
    "tinyllama-1.1b": LlamaConfig(
        vocab_size=32_000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
        hidden_dim=5632, rope_theta=10_000.0, max_seq_len=2048,
    ),
    "llama3-8b": LlamaConfig(
        vocab_size=128_256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14_336, rope_theta=500_000.0, max_seq_len=8192,
    ),
    "llama3-70b": LlamaConfig(
        vocab_size=128_256, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        hidden_dim=28_672, rope_theta=500_000.0, max_seq_len=8192,
    ),
}


def n_params(config: LlamaConfig) -> int:
    """Analytic parameter count (no materialization)."""
    c = config
    d, hd = c.dim, c.head_dim
    attn = d * (c.n_heads * hd) + 2 * d * (c.n_kv_heads * hd) + (c.n_heads * hd) * d
    mlp = 3 * d * c.hidden_dim
    if c.n_experts:
        mlp = mlp * c.n_experts + d * c.n_experts  # experts + router
    per_layer = attn + mlp + 2 * d
    total = c.vocab_size * d + c.n_layers * per_layer + d
    if not c.tie_embeddings:
        total += d * c.vocab_size
    return total


def _check_dense(config: LlamaConfig) -> None:
    if config.n_experts:
        raise NotImplementedError("MoE layers are not ported yet (n_experts must be 0)")


def init_params(config: LlamaConfig, generator: torch.Generator,
                device: torch.device | str,
                leaf_transform: Callable[[str, torch.Tensor], Any] | None = None,
                ) -> dict[str, Any]:
    """Random weights made directly in the model dtype on ``device`` (no fp32
    intermediate: the 8B tree is 16 GB in bf16), each matmul weight scaled
    by ``fan_in ** -0.5`` as the JAX package's ``init_params`` does; norms
    are ones. ``generator`` must live on ``device``. The values differ from
    the JAX package's (another generator); tests convert a JAX tree with
    ``models/convert.py`` instead. ``leaf_transform(name, leaf)`` is applied
    to each random leaf as soon as it is made, before the next one exists
    (``models/quant.init_quantized_params`` quantizes there)."""
    _check_dense(config)
    c = config
    L, D, H, Hkv, hd, F = c.n_layers, c.dim, c.n_heads, c.n_kv_heads, c.head_dim, c.hidden_dim

    def rand(name: str, shape: tuple[int, ...], fan_in: int) -> Any:
        w = torch.randn(shape, generator=generator, device=device, dtype=c.dtype)
        w.mul_(fan_in ** -0.5)
        return leaf_transform(name, w) if leaf_transform is not None else w

    params: dict[str, Any] = {
        "embed": rand("embed", (c.vocab_size, D), D),
        "layers": {
            "attn_q": rand("attn_q", (L, D, H * hd), D),
            "attn_k": rand("attn_k", (L, D, Hkv * hd), D),
            "attn_v": rand("attn_v", (L, D, Hkv * hd), D),
            "attn_o": rand("attn_o", (L, H * hd, D), H * hd),
            "ln_attn": torch.ones((L, D), dtype=c.dtype, device=device),
            "ln_mlp": torch.ones((L, D), dtype=c.dtype, device=device),
            "mlp_gate": rand("mlp_gate", (L, D, F), D),
            "mlp_up": rand("mlp_up", (L, D, F), D),
            "mlp_down": rand("mlp_down", (L, F, D), F),
        },
        "norm": torch.ones((D,), dtype=c.dtype, device=device),
    }
    if not c.tie_embeddings:
        params["lm_head"] = rand("lm_head", (D, c.vocab_size), D)
    return params


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding, fp32 math. x: [B,S,H,D], positions: [B,S]."""
    D = x.shape[-1]
    half = D // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _layer(
    x: torch.Tensor,
    lp: dict[str, torch.Tensor],
    cache: Any,
    layer_idx: int,
    *,
    positions: torch.Tensor,
    config: LlamaConfig,
    attention: AttentionFn,
) -> tuple[torch.Tensor, Any]:
    """One decoder layer; ``lp`` holds this layer's slice of every leaf."""
    c = config
    B, S, _ = x.shape
    h = rms_norm(x, lp["ln_attn"], c.norm_eps)
    q = dense(h, lp["attn_q"]).view(B, S, c.n_heads, c.head_dim)
    k = dense(h, lp["attn_k"]).view(B, S, c.n_kv_heads, c.head_dim)
    v = dense(h, lp["attn_v"]).view(B, S, c.n_kv_heads, c.head_dim)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)

    attn_out, cache = attention(q, k, v, cache, layer_idx)
    x = x + dense(attn_out.reshape(B, S, -1), lp["attn_o"])

    h = rms_norm(x, lp["ln_mlp"], c.norm_eps)
    gate = dense(h, lp["mlp_gate"])
    up = dense(h, lp["mlp_up"])
    act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return x + dense(act, lp["mlp_down"]), cache


def forward(
    params: dict[str, Any],
    tokens: torch.Tensor,  # [B, S] int
    positions: torch.Tensor,  # [B, S] int absolute positions
    *,
    config: LlamaConfig,
    attention: AttentionFn,
    cache: Any = None,
    remat: bool = False,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, Any]:
    """Run the decoder; returns (logits [B,S,vocab] fp32, cache) — or the
    post-norm hidden states [B,S,D] with ``return_hidden``, for callers that
    project only a few positions (a full-chunk fp32 logits tensor costs GBs
    at the 8B vocabulary). ``remat`` recomputes each layer in the backward
    (non-reentrant ``torch.utils.checkpoint`` around the layer, the
    counterpart of the JAX package's ``jax.checkpoint`` on its scan body):
    live activations stay one layer's instead of every layer's. A stacked
    leaf may also be a list of per-layer tensors (the train step's views)."""
    _check_dense(config)
    c = config
    x = params["embed"][tokens.long()]
    layers = params["layers"]
    for i in range(c.n_layers):
        lp = {name: leaf[i] for name, leaf in layers.items()}
        kw = dict(positions=positions, config=c, attention=attention)
        if remat:
            x, cache = torch.utils.checkpoint.checkpoint(_layer, x, lp, cache, i,
                                                         use_reentrant=False, **kw)
        else:
            x, cache = _layer(x, lp, cache, i, **kw)
    x = rms_norm(x, params["norm"], c.norm_eps)
    if return_hidden:
        return x, cache
    return lm_head(params, x, config=c), cache


class _HeadMatmul(torch.autograd.Function):
    """bf16 ``x @ head`` with an fp32 result on the card (``torch.mm``'s
    ``out_dtype``), and its gradient without an fp32 copy of the head: the
    fp32 logit gradient is rounded to bf16 and both products run in bf16
    with fp32 accumulation."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        g16 = g.to(head.dtype)
        return torch.mm(g16, head.t()), torch.mm(x2.t(), g16)


def lm_head(params: dict[str, Any], x: torch.Tensor, *, config: LlamaConfig) -> torch.Tensor:
    """Project hidden states [..., D] to fp32 logits [..., vocab]. A bf16
    head multiplies in bf16 with an fp32 result (``out_dtype`` on the card),
    never through an fp32 copy of the [D, vocab] weight; a quantized head
    goes through the fused dequant matmul with fp32 output, as the JAX
    package's ``preferred_element_type=float32``."""
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    if isinstance(head, (QTensor, Q4Tensor)):
        from finchat_tpu_torch.ops.dispatch import quant_matmul

        return quant_matmul(x, head, out_dtype=torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if head.dtype == torch.float32:
        out = x2.float() @ head
    elif x2.is_cuda:
        out = _HeadMatmul.apply(x2, head)
    else:
        out = x2.float() @ head.float()
    return out.reshape(*lead, head.shape[-1])


def dense_causal_attention(q, k, v, cache, layer_idx):
    """Cache-less causal attention over the whole sequence by the plain
    reference on any device (the JAX package's ``ref`` backend): the oracle
    the kernel paths are checked against."""
    from finchat_tpu_torch.ops.refs import mha_reference

    return mha_reference(q, k, v, causal=True), cache


def make_causal_attention() -> AttentionFn:
    """Cache-less causal attention over the whole sequence (training, the
    one-shot forward) through ``ops/dispatch.causal_attention``: K7 on the
    card, its plain version on the CPU."""
    from finchat_tpu_torch.ops.dispatch import causal_attention

    def attention(q, k, v, cache, layer_idx):
        return causal_attention(q, k, v), cache

    return attention


def forward_full(params: dict[str, Any], tokens: torch.Tensor, positions: torch.Tensor,
                 *, config: LlamaConfig) -> torch.Tensor:
    """Forward with full causal attention (``make_causal_attention``) and no
    cache; fp32 logits."""
    logits, _ = forward(params, tokens, positions, config=config,
                        attention=make_causal_attention())
    return logits
