"""Int8 / int4 weight-only quantization for serving (the JAX package's
``models/quant.py``, in PyTorch).

- ``QTensor``: int8 ``q [..., K, N]`` with per-output-column fp32 ``scale
  [..., N]``; the represented weight is ``q * scale[..., None, :]``.
- ``Q4Tensor``: int4 nibbles packed two per int8 byte along the contraction
  axis, ``q [..., K//2, N]`` (byte ``i`` holds row ``2i`` in its low nibble
  and row ``2i+1`` in its high nibble, signed [-8, 7]), with per-group,
  per-column fp32 ``scale [..., G, N]`` (``G = K / group_size``; G = 1 is
  per-channel).
- Both index like the stacked leaves they replace: ``leaf[i]`` is layer
  ``i``'s ``[K, N]`` weight (an MoE expert leaf ``[L, E, K, N]``: layer
  ``i``'s ``[E, K, N]`` experts with scales ``[E, N]``, or ``[E, G, N]``
  for int4), which is how ``models/llama.forward`` slices a layer.
- Quantization is symmetric: ``scale = amax / 127`` (int8) or ``amax / 7``
  (int4), 1/127 or 1/7 for an all-zero column, ``q = clip(round(w /
  scale))`` — a true division and round-half-even, bit for bit the JAX
  package's eager arithmetic (a reciprocal multiply flips ``round()``
  boundary cases).
- Every matmul site goes through ``dense``: a quantized leaf routes to
  ``ops/dispatch.quant_matmul`` (the fused dequant-matmul kernel on the
  card, ``x @ dequantize(w, x.dtype)`` on the CPU), a plain tensor to
  ``x @ w``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

# layer-stack leaves that are matmul weights [., K, N] (contract over -2);
# norms and the (precision-sensitive, small) MoE router stay full precision
QUANT_LAYER_LEAVES = frozenset({
    "attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down",
    "moe_gate", "moe_up", "moe_down",
})


@dataclass(frozen=True)
class QTensor:
    """Int8 weight ``q [..., K, N]`` + per-output-column fp32 ``scale [..., N]``."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> "QTensor":
        return QTensor(q=self.q[i], scale=self.scale[i])

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)


@dataclass(frozen=True)
class Q4Tensor:
    """Int4 weight (two nibbles per int8 byte along K) ``q [..., K//2, N]`` +
    per-group, per-column fp32 ``scale [..., G, N]``."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> "Q4Tensor":
        return Q4Tensor(q=self.q[i], scale=self.scale[i])

    @property
    def shape(self) -> tuple[int, ...]:
        """The LOGICAL weight shape (unpacked K)."""
        return tuple(self.q.shape[:-2]) + (self.q.shape[-2] * 2, self.q.shape[-1])


def symmetric_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``(amax if amax > 0 else 1) / qmax`` as a true division. The divisor
    is a tensor on purpose: PyTorch's CUDA ``tensor / python_float``
    multiplies by the reciprocal, which rounds some scales one ulp away
    from the division (and so from the JAX package and the kernels)."""
    num = torch.where(amax > 0, amax, torch.ones_like(amax))
    return num / torch.full_like(num, qmax)


def _amax(w32: torch.Tensor, dim: int) -> torch.Tensor:
    """``|w|.amax(dim)`` as ``max(w.amax(dim), -w.amin(dim))``: the same
    values, without a full-size ``abs`` temporary."""
    return torch.maximum(w32.amax(dim=dim), w32.amin(dim=dim).neg_())


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric int8 per-output-column quantization of ``w[..., K, N]``.
    One fp32 copy of ``w`` is the only full-size temporary (the division,
    rounding and clamp run in place on it)."""
    w32 = w.to(torch.float32, copy=True)
    scale = symmetric_scale(_amax(w32, -2), 127.0)  # [..., N]
    q = w32.div_(scale[..., None, :]).round_().clamp_(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def quantize_int4(w: torch.Tensor, group_size: int = 0) -> Q4Tensor:
    """Symmetric int4 quantization of ``w[..., K, N]`` with per-group
    (``group_size`` rows of K per scale; 0 = whole column) scales."""
    K, N = w.shape[-2:]
    if K % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {K}")
    g = group_size or K
    if K % g or g % 2:
        raise ValueError(f"group size {g} must be even and divide K={K}")
    G = K // g
    lead = w.shape[:-2]
    wg = w.to(torch.float32, copy=True).reshape(*lead, G, g, N)
    scale = symmetric_scale(_amax(wg, -2), 7.0)  # [..., G, N]
    q = wg.div_(scale[..., None, :]).round_().clamp_(-8, 7).to(torch.int8)
    q = q.reshape(*lead, K, N)
    packed = (q[..., 0::2, :] & 0x0F) | (q[..., 1::2, :] << 4)
    return Q4Tensor(q=packed, scale=scale)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., K//2, N] packed bytes -> [..., K, N] signed nibble values
    (int8). The low nibble sign-extends as ``((b & 0xF) ^ 8) - 8``, the
    high one as an arithmetic ``b >> 4``, in int32 (no int8 overflow)."""
    b = packed.to(torch.int32)
    lo = ((b & 0x0F) ^ 8) - 8  # rows 0, 2, 4, ...
    hi = b >> 4  # rows 1, 3, 5, ...
    half, N = packed.shape[-2:]
    lead = packed.shape[:-2]
    return torch.stack([lo, hi], dim=-2).reshape(*lead, half * 2, N).to(torch.int8)


def dequantize(qt: QTensor | Q4Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Materialize the represented weight: ``float(q) * scale`` in fp32,
    then cast to ``dtype`` (the JAX package's cast point). The int8 product
    is one elementwise op written straight into ``dtype`` (it computes in
    fp32, the promoted type, and rounds once on the store): on the card no
    fp32 copy of the weight is written and read back."""
    if isinstance(qt, Q4Tensor):
        K, N = qt.shape[-2:]
        G = qt.scale.shape[-2]
        lead = qt.q.shape[:-2]
        w = _unpack_int4(qt.q).float()
        wg = w.reshape(*lead, G, K // G, N) * qt.scale[..., None, :]
        return wg.reshape(*lead, K, N).to(dtype)
    out = torch.empty(qt.q.shape, dtype=dtype, device=qt.q.device)
    return torch.mul(qt.q, qt.scale[..., None, :], out=out)


def write_slice(leaf: Any, index: int | tuple[int, ...], lead: tuple[int, ...],
                part: Any) -> Any:
    """Store ``part`` (a tensor, ``QTensor`` or ``Q4Tensor``) at ``index``
    of the stacked ``leaf`` of leading shape ``lead``, which the first call
    (``leaf`` None) allocates like ``part``; returns the leaf. How a stacked
    leaf is built one layer slice (or one expert of one layer) at a time."""
    quantized = isinstance(part, (QTensor, Q4Tensor))
    if leaf is None:
        def empty(t: torch.Tensor) -> torch.Tensor:
            return t.new_empty(tuple(lead) + tuple(t.shape))

        leaf = type(part)(q=empty(part.q), scale=empty(part.scale)) if quantized else empty(part)
    if quantized:
        leaf.q[index] = part.q
        leaf.scale[index] = part.scale
    else:
        leaf[index] = part
    return leaf


def quantize_stacked(w: torch.Tensor, mode: str = "int8",
                     group_size: int = 0) -> QTensor | Q4Tensor:
    """``quantize`` (or ``quantize_int4``) of a layer-stacked leaf
    ``[L, ..., K, N]`` one leading slice at a time, so the fp32 transient
    stays at 1/L of the leaf (an expert leaf ``[L, E, K, N]`` goes one
    ``[E, K, N]`` slice at a time, scales ``[L, E, N]``); bit for bit the
    whole-leaf result (the amax runs over the contraction axis only). 2-D
    weights quantize whole."""
    qfn = (lambda x: quantize_int4(x, group_size)) if mode == "int4" else quantize
    if w.dim() < 3:
        return qfn(w)
    L = w.shape[0]
    leaf = None
    for i in range(L):
        leaf = write_slice(leaf, i, (L,), qfn(w[i]))
    return leaf


def dense(x: torch.Tensor, w: torch.Tensor | QTensor | Q4Tensor) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight: a quantized leaf goes
    through ``ops/dispatch.quant_matmul`` (kernel on the card, plain
    dequantize-then-matmul on the CPU)."""
    if isinstance(w, (QTensor, Q4Tensor)):
        from finchat_tpu_torch.ops.dispatch import quant_matmul

        return quant_matmul(x, w)
    return x @ w


class _WideMatmul(torch.autograd.Function):
    """``x2 @ w`` (2-D, one dtype) with an fp32 result: bf16 operands with
    fp32 accumulation rounded never (``torch.mm``'s ``out_dtype`` on the
    card), and its gradient without an fp32 copy of either operand: the
    fp32 output gradient is rounded to the operands' dtype and both products
    run in it, as autograd runs the plain product's."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.dtype == torch.float32:
            return x2 @ w
        if x2.is_cuda:
            return torch.mm(x2, w, out_dtype=torch.float32)
        return x2.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(w.dtype)
        return g.mm(w.t()), x2.t().mm(g)


def dense_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a plain weight ``[K, N]`` with an fp32 result (a
    partial sum that is summed on before it is rounded: the head's logits,
    a sharded product's part), differentiable."""
    lead = x.shape[:-1]
    return _WideMatmul.apply(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[-1])


def should_quantize(name: str) -> bool:
    """Which param leaves quantize: the layer-stack matmul weights plus the
    (untied) ``lm_head``."""
    return name in QUANT_LAYER_LEAVES or name == "lm_head"


def validate_quant_mode(quant: str) -> None:
    if quant and quant not in ("int8", "int4"):
        raise ValueError(f"unknown quant mode {quant!r} (supported: 'int8', 'int4')")


def _quantize_leaf(leaf: Any, mode: str, group_size: int) -> Any:
    if isinstance(leaf, (QTensor, Q4Tensor)):
        return leaf  # idempotent on an already-quantized tree
    return quantize_stacked(leaf, mode=mode, group_size=group_size)


def quantize_llama_params(params: dict[str, Any], mode: str = "int8",
                          group_size: int = 0) -> dict[str, Any]:
    """Quantize a Llama param tree's matmul weights (``should_quantize``) in
    place of the float leaves; embedding and norms stay as they are, a tied
    head keeps the dense path. Idempotent on already-quantized leaves."""
    validate_quant_mode(mode or "int8")
    mode = mode or "int8"
    layers = {name: _quantize_leaf(leaf, mode, group_size) if should_quantize(name) else leaf
              for name, leaf in params["layers"].items()}
    out = {**params, "layers": layers}
    if "lm_head" in params:
        out["lm_head"] = _quantize_leaf(params["lm_head"], mode, group_size)
    return out


def init_quantized_params(config: Any, generator: torch.Generator, device: torch.device | str,
                          mode: str = "int8", group_size: int = 0,
                          leaf_transform: Any = None) -> dict[str, Any]:
    """Random weights with every matmul leaf ALREADY int8/int4: each leaf is
    made in the model dtype exactly as ``init_params`` makes it (same
    generator calls, same order) and quantized slice by slice before the
    next leaf exists, so the full bf16 tree (16 GB for llama3-8b) never
    does; an expert leaf is made and quantized one layer's ``[E, K, N]``
    slice at a time (a whole bf16 one of mixtral-8x7b is 28 GiB). Equal to
    ``quantize_llama_params(init_params(...))`` on the same generator
    state. ``leaf_transform(name, leaf)`` then takes each quantized leaf
    (``parallel/sharding.leaf_sharder`` cuts a rank's slice there)."""
    from finchat_tpu_torch.models.llama import init_params

    validate_quant_mode(mode or "int8")

    def quantize_leaf(name: str, w: torch.Tensor) -> Any:
        leaf = quantize_stacked(w, mode=mode or "int8", group_size=group_size) \
            if should_quantize(name) else w
        return leaf_transform(name, leaf) if leaf_transform is not None else leaf

    return init_params(config, generator, device, leaf_transform=quantize_leaf)
