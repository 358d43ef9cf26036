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
  ``i``'s ``[K, N]`` weight, which is how ``models/llama.forward`` slices a
  layer.
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
# norms stay full precision. (The MoE leaves of the JAX set are not ported.)
QUANT_LAYER_LEAVES = frozenset({
    "attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down",
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


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric int8 per-output-column quantization of ``w[..., K, N]``."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)  # [..., N]
    scale = symmetric_scale(amax, 127.0)
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def quantize_int4(w: torch.Tensor, group_size: int = 0) -> Q4Tensor:
    """Symmetric int4 quantization of ``w[..., K, N]`` with per-group
    (``group_size`` rows of K per scale; 0 = whole column) scales."""
    w32 = w.float()
    K, N = w32.shape[-2:]
    if K % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {K}")
    g = group_size or K
    if K % g or g % 2:
        raise ValueError(f"group size {g} must be even and divide K={K}")
    G = K // g
    lead = w32.shape[:-2]
    wg = w32.reshape(*lead, G, g, N)
    amax = wg.abs().amax(dim=-2)  # [..., G, N]
    scale = symmetric_scale(amax, 7.0)
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -8, 7).to(torch.int8)
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
    then cast to ``dtype`` (the JAX package's cast point)."""
    if isinstance(qt, Q4Tensor):
        K, N = qt.shape[-2:]
        G = qt.scale.shape[-2]
        lead = qt.q.shape[:-2]
        w = _unpack_int4(qt.q).float()
        wg = w.reshape(*lead, G, K // G, N) * qt.scale[..., None, :]
        return wg.reshape(*lead, K, N).to(dtype)
    return (qt.q.float() * qt.scale[..., None, :]).to(dtype)


def quantize_stacked(w: torch.Tensor, mode: str = "int8",
                     group_size: int = 0) -> QTensor | Q4Tensor:
    """``quantize`` (or ``quantize_int4``) of a layer-stacked leaf
    ``[L, K, N]`` one layer slice at a time, so the fp32 transient stays at
    1/L of the leaf; bit for bit the whole-leaf result (the amax runs over
    the contraction axis only). 2-D weights quantize whole."""
    qfn = (lambda x: quantize_int4(x, group_size)) if mode == "int4" else quantize
    cls = Q4Tensor if mode == "int4" else QTensor
    if w.dim() < 3:
        return qfn(w)
    L = w.shape[0]
    q = scale = None
    for i in range(L):
        part = qfn(w[i])
        if q is None:
            q = torch.empty((L,) + tuple(part.q.shape), dtype=part.q.dtype, device=w.device)
            scale = torch.empty((L,) + tuple(part.scale.shape), dtype=part.scale.dtype,
                                device=w.device)
        q[i] = part.q
        scale[i] = part.scale
        del part
    return cls(q=q, scale=scale)


def dense(x: torch.Tensor, w: torch.Tensor | QTensor | Q4Tensor) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight: a quantized leaf goes
    through ``ops/dispatch.quant_matmul`` (kernel on the card, plain
    dequantize-then-matmul on the CPU)."""
    if isinstance(w, (QTensor, Q4Tensor)):
        from finchat_tpu_torch.ops.dispatch import quant_matmul

        return quant_matmul(x, w)
    return x @ w


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
                          mode: str = "int8", group_size: int = 0) -> dict[str, Any]:
    """Random weights with every matmul leaf ALREADY int8/int4: each leaf is
    made in the model dtype exactly as ``init_params`` makes it (same
    generator calls, same order) and quantized slice by slice before the
    next leaf exists, so the full bf16 tree (16 GB for llama3-8b) never
    does. Equal to ``quantize_llama_params(init_params(...))`` on the same
    generator state."""
    from finchat_tpu_torch.models.llama import init_params

    validate_quant_mode(mode or "int8")

    def leaf_transform(name: str, w: torch.Tensor) -> Any:
        return quantize_stacked(w, mode=mode or "int8", group_size=group_size) \
            if should_quantize(name) else w

    return init_params(config, generator, device, leaf_transform=leaf_transform)
