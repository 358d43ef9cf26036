"""Llama-family decoder in PyTorch (dense MLP or Mixtral-style MoE), the
JAX package's layout.

- Params are a plain dict with all layers STACKED on a leading axis:
  ``embed [vocab, dim]``, ``layers/attn_{q,k,v} [L, dim, heads*hd]``,
  ``layers/attn_o [L, heads*hd, dim]``, ``layers/mlp_{gate,up} [L, dim,
  hidden]``, ``layers/mlp_down [L, hidden, dim]``, ``layers/ln_{attn,mlp}
  [L, dim]``, ``norm [dim]``, ``lm_head [dim, vocab]`` — so a JAX tree
  converts leaf by leaf (models/convert.py). With ``n_experts`` E > 0 the
  ``mlp_*`` leaves give way to ``layers/router [L, dim, E]`` (fp32),
  ``layers/moe_{gate,up} [L, E, dim, hidden]`` and ``layers/moe_down [L, E,
  hidden, dim]`` (``moe_mlp``). ``forward`` loops over layers in Python,
  indexing each stacked leaf; ``remat`` checkpoints each layer for training
  (train/train_step.py).
- Dtype policy of the reference: bf16 weights and activations; RMSNorm and
  RoPE math in fp32 (the normalized activations cast to the model dtype
  BEFORE the weight multiply); SiLU in fp32 then cast; fp32 logits.
- The attention inner op is a callback (``AttentionFn``), so the same
  forward serves chunked prefill, paged decode and the packed ragged round.
  The cache it receives is updated in place.
- Every matmul goes through ``models/quant.dense``: a plain weight is
  ``x @ w``, an int8/int4 leaf (``QTensor``/``Q4Tensor``, quantized serving)
  the fused dequant matmul; a quantized ``lm_head`` produces fp32 logits.
  The stacked expert einsums are the exception: no kernel tiles their
  leading E axis, so a quantized expert leaf is dequantized inline, one
  layer's ``[E, K, N]`` slice at a time, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from finchat_tpu_torch.models.quant import (
    Q4Tensor,
    QTensor,
    dense,
    dense_fp32,
    dequantize,
    write_slice,
)
from finchat_tpu_torch.ops.tp_overlap import COLLECTIVES, row_parallel_dense
from finchat_tpu_torch.parallel.collectives import (
    copy_to_group,
    group_size,
    reduce_from_group,
    sum_in_place,
)
from finchat_tpu_torch.utils.precision import ieee_fp32

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
    # MoE (Mixtral family): 0 = dense MLP; > 0 = that many SwiGLU experts a
    # layer, each token routed to ``top_k_experts`` of them (``moe_mlp``)
    n_experts: int = 0
    top_k_experts: int = 2
    # tensor parallelism: this rank's shard of the model
    # (``ops/tp_overlap.TPShard``), None for the whole model on one device.
    # Set by the TP engine; the widths above stay the whole model's
    tp: Any = field(default=None, compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def tp_size(self) -> int:
        return self.tp.size if self.tp is not None else 1

    @property
    def local_heads(self) -> int:
        """Query heads on this rank."""
        return self.n_heads // self.tp_size

    @property
    def local_kv_heads(self) -> int:
        """KV heads on this rank (its slice of the KV pool)."""
        return self.n_kv_heads // self.tp_size


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
    # random-weight MoE debug config (Mixtral-shaped routing, tiny widths)
    "moe-tiny": LlamaConfig(
        vocab_size=260, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=256, n_experts=4, top_k_experts=2,
    ),
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32_000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14_336, rope_theta=1_000_000.0, max_seq_len=8192,
        n_experts=8, top_k_experts=2,
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


def check_experts(config: LlamaConfig) -> None:
    """An MoE config must route each token to between 1 and ``n_experts``
    experts (``torch.topk`` would otherwise fail mid-step)."""
    if config.n_experts and not 0 < config.top_k_experts <= config.n_experts:
        raise ValueError(f"top_k_experts={config.top_k_experts} must be in 1..n_experts="
                         f"{config.n_experts}")


def init_params(config: LlamaConfig, generator: torch.Generator,
                device: torch.device | str,
                leaf_transform: Callable[[str, torch.Tensor], Any] | None = None,
                ) -> dict[str, Any]:
    """Random weights made directly in the model dtype on ``device`` (no fp32
    intermediate: the 8B tree is 16 GB in bf16), each matmul weight scaled
    by ``fan_in ** -0.5`` as the JAX package's ``init_params`` does; norms
    are ones, the MoE router fp32. ``generator`` must live on ``device``.
    The values differ from the JAX package's (another generator); tests
    convert a JAX tree with ``models/convert.py`` instead.
    ``leaf_transform(name, leaf)`` is applied to each random leaf as soon as
    it is made, before the next one exists
    (``models/quant.init_quantized_params`` quantizes there). An expert
    leaf is drawn, transformed and stored one layer's ``[E, ...]`` slice at
    a time: a whole bf16 expert leaf of mixtral-8x7b is 28 GiB."""
    check_experts(config)
    c = config
    L, D, H, Hkv, hd, F = c.n_layers, c.dim, c.n_heads, c.n_kv_heads, c.head_dim, c.hidden_dim
    E = c.n_experts

    def rand(name: str, shape: tuple[int, ...], fan_in: int) -> Any:
        w = torch.randn(shape, generator=generator, device=device, dtype=c.dtype)
        w.mul_(fan_in ** -0.5)
        return leaf_transform(name, w) if leaf_transform is not None else w

    def rand_layers(name: str, shape: tuple[int, ...], fan_in: int) -> Any:
        leaf = None
        for i in range(L):
            leaf = write_slice(leaf, i, (L,), rand(name, shape, fan_in))
        return leaf

    embed = rand("embed", (c.vocab_size, D), D)
    layers: dict[str, Any] = {
        "attn_q": rand("attn_q", (L, D, H * hd), D),
        "attn_k": rand("attn_k", (L, D, Hkv * hd), D),
        "attn_v": rand("attn_v", (L, D, Hkv * hd), D),
        "attn_o": rand("attn_o", (L, H * hd, D), H * hd),
        "ln_attn": torch.ones((L, D), dtype=c.dtype, device=device),
        "ln_mlp": torch.ones((L, D), dtype=c.dtype, device=device),
    }
    if E:
        router = torch.randn((L, D, E), generator=generator, device=device, dtype=torch.float32)
        layers["router"] = router.mul_(D ** -0.5)
        layers["moe_gate"] = rand_layers("moe_gate", (E, D, F), D)
        layers["moe_up"] = rand_layers("moe_up", (E, D, F), D)
        layers["moe_down"] = rand_layers("moe_down", (E, F, D), F)
    else:
        layers["mlp_gate"] = rand("mlp_gate", (L, D, F), D)
        layers["mlp_up"] = rand("mlp_up", (L, D, F), D)
        layers["mlp_down"] = rand("mlp_down", (L, F, D), F)
    params: dict[str, Any] = {
        "embed": embed,
        "layers": layers,
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
    # the base made on the device (a fill, no host copy: the decode loop
    # runs this under CUDA graph capture)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exps)
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


# tokens a block of the expert einsums (moe_mlp): a block's [T, E, F]
# activations at mixtral-8x7b's widths are ~1 GB in bf16 and ~2 GB at the
# fp32 SiLU
MOE_BLOCK_TOKENS = 4096


def moe_gates(h: torch.Tensor, router: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Each token's expert weights ``[B, S, E]`` in ``h.dtype``, zero for
    an expert it was not routed to:

    - the router product in fp32 (``h`` upcast, the ``router`` leaf fp32)
      with TF32 off in its own scope (``utils/precision.ieee_fp32``): a
      flipped near tie changes the expert, and with it the token;
    - exactly ``top_k_experts`` experts a token, the lower index first among
      equal logits (``jax.lax.top_k``'s order, by a stable descending sort:
      ``torch.topk`` promises no order);
    - a softmax over the k selected logits (Mixtral's renormalization),
      scattered back to their E positions."""
    with ieee_fp32():
        r = torch.matmul(h.float(), router)  # [B, S, E]
    top_vals, top_idx = torch.sort(r, dim=-1, descending=True, stable=True)
    k = config.top_k_experts
    w = torch.softmax(top_vals[..., :k], dim=-1)
    return torch.zeros_like(r).scatter_(-1, top_idx[..., :k], w).to(h.dtype)


def moe_mlp(h: torch.Tensor, lp: dict[str, Any], config: LlamaConfig) -> torch.Tensor:
    """Mixtral-style top-k routed SwiGLU experts, the JAX package's
    ``moe_mlp``: dense dispatch, every expert over every token with the gate
    of an expert the token was not routed to at zero (no capacity, no
    dropped token), in the reference's order of types:

    - the gates of ``moe_gates`` (the router in fp32, exactly k experts a
      token, the softmax over the k selected logits), cast to ``h.dtype``;
    - ``silu(gate)`` in fp32 cast to ``up.dtype``, times ``up``, times the
      gates, before the down projection; the sum over experts inside the
      down product.

    The expert products are plain batched matmuls (the JAX package's
    einsums, computed outside any Pallas kernel): gate and up one ``[T, D]
    @ [D, F]`` product an expert (``[E, T, F]``, the weights read in place:
    an einsum would copy each ``[E, D, F]`` weight to put D first), down one
    ``[T, E * F] @ [E * F, D]`` product (the sum over experts inside it, as
    the reference's einsum contracts ``e`` and ``f`` together). They run over
    ``MOE_BLOCK_TOKENS`` tokens at a time (each token's output is its own:
    the blocks change no value's arithmetic, only how many activations are
    live). A quantized expert leaf (``QTensor`` / ``Q4Tensor``) is
    dequantized inline, this layer's ``[E, K, N]`` slice only, as the
    reference does.

    Under a shard (``config.tp`` with its ``expert_group``, training over
    a mesh) ``lp`` holds this rank's ``E / ep`` experts over its ``F / tp``
    columns: the rank runs them over every token and its partial output is
    summed over the ``("expert", "model")`` group in one all-reduce (not
    over ``expert`` and then ``model``, whose two roundings differ), a bf16
    rank's part in fp32, rounded once (parts rounded to bf16 and summed
    would differ from the one-device product by more than its rounding). The
    router and the gates stay replicated; the gates and the experts' input
    enter through ``copy_to_group`` on that group, so the router's gradient
    is the whole one on every rank. On the card the engine books those products on
    ``finchat_quantmatmul_fallbacks_total``: three (gate, up, down) once per
    engine and step kind, the first time it dispatches the kind
    (``InferenceEngine``); the JAX package counts them once per trace of a
    compiled step."""
    gates = moe_gates(h, lp["router"], config)
    w_gate, w_up, w_down = (dequantize(w, h.dtype) if isinstance(w, (QTensor, Q4Tensor)) else w
                            for w in (lp["moe_gate"], lp["moe_up"], lp["moe_down"]))
    E, F, D = w_down.shape
    tp = config.tp
    group = tp.expert_group if tp is not None else None
    sharded = group_size(group) > 1
    if sharded:
        h = copy_to_group(h, group)
        gates = copy_to_group(gates, group)
        if E != gates.shape[-1]:  # this rank's experts
            gates = gates[..., tp.ep_rank * E:(tp.ep_rank + 1) * E]

    def experts(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:  # [T, D], [T, E]
        gate = torch.matmul(x, w_gate)  # [E, T, F]
        up = torch.matmul(x, w_up)
        act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
        act = act * g.t()[..., None]  # the experts a token was not routed to: zero
        act = act.transpose(0, 1).reshape(x.shape[0], E * F)
        if sharded:  # a part of the sum: fp32, rounded once the parts are summed
            return dense_fp32(act, w_down.reshape(E * F, D))
        return act @ w_down.reshape(E * F, D)

    lead = h.shape[:-1]
    x, g = h.reshape(-1, D), gates.reshape(-1, E)
    R = MOE_BLOCK_TOKENS
    if x.shape[0] <= R:
        out = experts(x, g)
    else:
        # a block of tokens at a time: every token's [E, F] activations (in
        # fp32 at the SiLU) would otherwise be live at once, ~40 GB for a
        # 32k-token round of mixtral-8x7b
        out = torch.cat([experts(x[i:i + R], g[i:i + R]) for i in range(0, x.shape[0], R)])
    if sharded:
        out = reduce_from_group(out, group).to(h.dtype)
    return out.reshape(*lead, D)


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
    """One decoder layer; ``lp`` holds this layer's slice of every leaf.

    Under tensor parallelism (``config.tp``, the JAX package's manual-TP
    layer with its ``tp_axis``, ``tp_overlap`` and ``tp_chunks``) ``lp`` is
    this rank's shard: q/k/v run over the rank's heads (``n_heads / tp`` and
    ``n_kv_heads / tp``: the same GQA group, so every attention route is
    the one-device one), and ``attn_o`` and ``mlp_down`` end in the
    row-parallel all-reduce (``ops/tp_overlap.row_parallel_dense``, chunked
    with ``tp.overlap``). The norms and the residual stream are replicated.
    For training, the input of each column-parallel product (q/k/v,
    gate/up) enters through ``copy_to_group``: its gradient is summed over
    the ranks, so the norms' and the embedding's gradients are whole on
    every rank. An MoE layer's experts run under ``moe_mlp``'s own shard
    rule."""
    c = config
    tp = c.tp
    B, S, _ = x.shape

    def out_proj(a: torch.Tensor, w: Any) -> torch.Tensor:
        if tp is None:
            return dense(a, w)
        return row_parallel_dense(a, w, tp.group, overlap=tp.overlap, n_chunks=tp.n_chunks)

    def column_input(a: torch.Tensor) -> torch.Tensor:
        return a if tp is None else copy_to_group(a, tp.group)

    h = column_input(rms_norm(x, lp["ln_attn"], c.norm_eps))
    q = dense(h, lp["attn_q"]).view(B, S, c.local_heads, c.head_dim)
    k = dense(h, lp["attn_k"]).view(B, S, c.local_kv_heads, c.head_dim)
    v = dense(h, lp["attn_v"]).view(B, S, c.local_kv_heads, c.head_dim)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)

    attn_out, cache = attention(q, k, v, cache, layer_idx)
    x = x + out_proj(attn_out.reshape(B, S, -1), lp["attn_o"])

    h = rms_norm(x, lp["ln_mlp"], c.norm_eps)
    if c.n_experts:
        return x + moe_mlp(h, lp, c), cache
    h = column_input(h)
    gate = dense(h, lp["mlp_gate"])
    up = dense(h, lp["mlp_up"])
    act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return x + out_proj(act, lp["mlp_down"]), cache


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


def lm_head(params: dict[str, Any], x: torch.Tensor, *, config: LlamaConfig) -> torch.Tensor:
    """Project hidden states [..., D] to fp32 logits [..., vocab]. A bf16
    head multiplies in bf16 with an fp32 result (``out_dtype`` on the card),
    never through an fp32 copy of the [D, vocab] weight; a quantized head
    goes through the fused dequant matmul with fp32 output, as the JAX
    package's ``preferred_element_type=float32``.

    Under tensor parallelism the head is this rank's vocab slice: its fp32
    logits are placed in a zero row of the full vocab and all-reduced, so
    every rank holds the same full row bit for bit (x + 0 = x) and samples
    the same token from the same generator state. A head that replicated
    (a vocab the mesh does not divide) needs no gather. For training the
    sliced head's input enters through ``copy_to_group`` and the gather is
    differentiable (each rank's slice of the logits' gradient)."""
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    tp = config.tp
    n = head.shape[-1]
    if tp is None or n == config.vocab_size:
        return _head_logits(x, head)
    out = _head_logits(copy_to_group(x, tp.group), head)
    full = out.new_zeros(tuple(out.shape[:-1]) + (config.vocab_size,))
    full[..., tp.rank * n:(tp.rank + 1) * n] = out
    COLLECTIVES["logits_gather"] += 1
    return sum_in_place(full, tp.group)


def _head_logits(x: torch.Tensor, head: Any) -> torch.Tensor:
    if isinstance(head, (QTensor, Q4Tensor)):
        from finchat_tpu_torch.ops.dispatch import quant_matmul

        return quant_matmul(x, head, out_dtype=torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if head.dtype == torch.float32:
        out = x2.float() @ head
    elif x2.is_cuda:
        out = dense_fp32(x2, head)
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
