"""Fused dequant matmul: ``x @ dequant(w)`` with the weight read as stored.

``quant_matmul_int8(x, q, scale)`` takes an int8 weight ``[K, N]`` with
per-column fp32 scales ``[N]``; ``quant_matmul_int4(x, q, scale)`` a
nibble-packed int4 weight ``[K//2, N]`` (low nibble = row 2i, high nibble =
row 2i+1) with per-group scales ``[G, N]``. Both launch the hand-written
kernel (``csrc/quant_matmul.cu``, replacing the TPU kernel ``_qmm_kernel``
of ``_quant_matmul_2d``) on bf16 CUDA tensors: the weight streams 1 or 0.5
byte per element from device memory and is dequantized tile by tile as
``bf16(float(q) * scale)``, fp32 accumulation, bf16 output — or fp32 with
``out_dtype=torch.float32``, the lm_head's logits.

``quant_matmul_ref`` is the plain version: ``x @ dequantize(w, x.dtype)``,
or a product with fp32 output for the head — the JAX package's
``quant_matmul_ref`` up to the frameworks' accumulation order. The tests
and ``chip_smoke.py`` hold the kernels against it; ``ops/dispatch.py``
picks one by the tensor's device.
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, dequantize
from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.kernels import check


def quant_matmul_ref(x: torch.Tensor, w: QTensor | Q4Tensor,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: dequantize the whole weight to ``x.dtype``, then one
    matmul; with ``out_dtype`` the product has that dtype (bf16 operands,
    fp32 result for the head)."""
    w_deq = dequantize(w, x.dtype)
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w_deq
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        out = torch.mm(x2, w_deq, out_dtype=out_dtype)
    else:
        out = x2.to(out_dtype) @ w_deq.to(out_dtype)
    return out.reshape(*lead, w_deq.shape[-1])


def _check_cuda(name: str, x: torch.Tensor, q: torch.Tensor) -> None:
    check(x.is_cuda, f"the {name} kernel runs on CUDA tensors (quant_matmul_ref is the "
          "plain version)")
    check(q.dtype == torch.int8 and q.dim() == 2, f"{name} takes a 2-D int8 weight")


def _launch(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, K: int,
            groups: tuple[int, ...], out_dtype: torch.dtype | None) -> torch.Tensor:
    check(x.dtype == torch.bfloat16, f"{name} takes bf16 activations, got {x.dtype}")
    check(scale.dtype == torch.float32, f"{name} takes fp32 scales")
    check(x.shape[-1] == K, f"{name}: x has K={x.shape[-1]}, the weight K={K}")
    out_dtype = out_dtype or x.dtype
    check(out_dtype in (torch.bfloat16, torch.float32), f"{name}: bf16 or fp32 output only")
    for t in (x, q, scale):
        check(t.is_cuda and t.device == x.device and t.is_contiguous(),
              f"{name} tensors must be contiguous on one CUDA device")
    N = q.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M:
        # 16-byte vector loads where rows and the base are aligned; the
        # kernel loads element by element elsewhere
        x_vec = int(K % 8 == 0 and x2.data_ptr() % 16 == 0)
        q_vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0)
        kernels.launch(name, x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                       M, K, N, *groups, int(out_dtype == torch.float32), x_vec, q_vec)
    return out.reshape(*lead, N)


def quant_matmul_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [..., K] @ (q [K, N] * scale [N])`` by the CUDA kernel. Raises on
    a tensor it does not take, a CPU one included."""
    _check_cuda("quant_matmul_int8", x, q)
    K, N = q.shape
    check(scale.numel() == N, f"quant_matmul_int8: scale has {scale.numel()} values, N={N}")
    return _launch("quant_matmul_int8", x, q, scale, K, (), out_dtype)


def quant_matmul_int4(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [..., K] @ dequant(q [K//2, N], scale [G, N])`` by the CUDA
    kernel, per-group scales along K (group K / G, even). Raises on a
    tensor it does not take, a CPU one included."""
    _check_cuda("quant_matmul_int4", x, q)
    check(scale.dim() == 2 and scale.shape[1] == q.shape[1],
          f"quant_matmul_int4: q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    K, G = 2 * q.shape[0], scale.shape[0]
    check(K % G == 0 and (K // G) % 2 == 0, f"quant_matmul_int4: K={K} in {G} even groups")
    return _launch("quant_matmul_int4", x, q, scale, K, (G,), out_dtype)
