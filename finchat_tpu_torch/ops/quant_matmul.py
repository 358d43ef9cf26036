"""Fused dequant matmul: ``x @ dequant(w)`` with the weight read as stored.

``quant_matmul_int8(x, q, scale)`` takes an int8 weight ``[K, N]`` with
per-column fp32 scales ``[N]``; ``quant_matmul_int4(x, q, scale)`` a
nibble-packed int4 weight ``[K//2, N]`` (low nibble = row 2i, high nibble =
row 2i+1) with per-group scales ``[G, N]``. Both launch a hand-written
kernel, replacing the TPU kernel ``_qmm_kernel`` of ``_quant_matmul_2d``, on
bf16 CUDA tensors: the weight streams 1 or 0.5 byte per element from device
memory and is dequantized tile by tile as ``bf16(float(q) * scale)``, fp32
accumulation, bf16 output — or fp32 with ``out_dtype=torch.float32``, the
lm_head's logits.

Two kernels serve the calls, picked by ``kernel_for``, a pure function of
the call's shapes, output dtype and pointer alignment:

- ``quant_matmul_{int8,int4}_sm90`` (``csrc/quant_matmul_sm90.cu``): more
  than 64 rows (prefill chunks, ragged rounds), bf16 output, and operands
  TMA can read — K % 8 == 0, N % 16 == 0, x, q and scale 16-byte aligned,
  an int4 group of a multiple of 8 rows. Warp-specialized: TMA loads, a
  dequantizing producer warpgroup, ``wgmma`` consumers.
- ``quant_matmul_{int8,int4}`` ("v2", ``csrc/quant_matmul.cu``): every other
  call — decode at M <= 64, the fp32-out head, shapes TMA cannot take.

Nothing gives way to anything else: a CUDA tensor reaches one of the two
kernels or raises. ``run_kernel`` launches a named kernel with no routing
(``chip_smoke.py`` times both on the same inputs with it).

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


def _hopper_takes(K: int, N: int, group: int, out_f32: bool, aligned: bool) -> bool:
    """The Hopper kernel's requirements other than the row count."""
    return not out_f32 and aligned and K % 8 == 0 and N > 0 and N % 16 == 0 and group % 8 == 0


def kernel_for(mode: str, M: int, K: int, N: int, group: int, out_f32: bool,
               aligned: bool = True) -> str:
    """The kernel that serves a ``mode`` ("int8" or "int4") call of ``M``
    rows on a ``[K, N]`` weight whose scales span ``group`` rows of K each
    (K for int8 and for per-column int4), with fp32 output if ``out_f32``
    and ``aligned`` if x, q and scale start on 16-byte boundaries."""
    if M > 64 and _hopper_takes(K, N, group, out_f32, aligned):
        return f"quant_matmul_{mode}_sm90"
    return f"quant_matmul_{mode}"


def _check_cuda(name: str, x: torch.Tensor, q: torch.Tensor) -> None:
    check(x.is_cuda, f"the {name} kernel runs on CUDA tensors (quant_matmul_ref is the "
          "plain version)")
    check(q.dtype == torch.int8 and q.dim() == 2, f"{name} takes a 2-D int8 weight")


def _validate(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              out_dtype: torch.dtype | None) -> tuple[int, int, int, torch.dtype]:
    """(K, N, G, output dtype) of a call both kernels of ``name``'s mode
    take, checked: 2-D weight, its scales, dtypes, one device, contiguity."""
    _check_cuda(name, x, q)
    N = q.shape[1]
    if "int4" in name:
        check(scale.dim() == 2 and scale.shape[1] == N,
              f"{name}: q {tuple(q.shape)}, scale {tuple(scale.shape)}")
        K, G = 2 * q.shape[0], scale.shape[0]
        check(K % G == 0 and (K // G) % 2 == 0, f"{name}: K={K} in {G} even groups")
    else:
        K, G = q.shape[0], 1
        check(scale.numel() == N, f"{name}: scale has {scale.numel()} values, N={N}")
    check(x.dtype == torch.bfloat16, f"{name} takes bf16 activations, got {x.dtype}")
    check(scale.dtype == torch.float32, f"{name} takes fp32 scales")
    check(x.shape[-1] == K, f"{name}: x has K={x.shape[-1]}, the weight K={K}")
    out_dtype = out_dtype or x.dtype
    check(out_dtype in (torch.bfloat16, torch.float32), f"{name}: bf16 or fp32 output only")
    for t in (x, q, scale):
        check(t.is_cuda and t.device == x.device and t.is_contiguous(),
              f"{name} tensors must be contiguous on one CUDA device")
    return K, N, G, out_dtype


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, K: int, N: int,
            G: int, out_dtype: torch.dtype) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    groups = (G,) if "int4" in name else ()
    if name.endswith("_sm90"):
        args = (M, K, N, *groups)
    else:
        # 16-byte vector loads where rows and the base are aligned; v2 loads
        # element by element elsewhere
        x_vec = int(K % 8 == 0 and x2.data_ptr() % 16 == 0)
        q_vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0)
        args = (M, K, N, *groups, int(out_dtype == torch.float32), x_vec, q_vec)
    if M:
        kernels.launch(name, x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                       *args)
    return out.reshape(*lead, N)


def run_kernel(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch kernel ``name`` (v2 or the Hopper kernel, for int8 or int4)
    on this call, with no routing. Raises on a tensor or shape it does not
    take."""
    K, N, G, out_dtype = _validate(name, x, q, scale, out_dtype)
    if name.endswith("_sm90"):
        check(_hopper_takes(K, N, K // G, out_dtype == torch.float32, _aligned(x, q, scale)),
              f"{name} takes bf16 output, K % 8 == 0, N % 16 == 0, int4 groups of a "
              "multiple of 8 rows and 16-byte aligned operands")
    return _launch(name, x, q, scale, K, N, G, out_dtype)


def _route(mode: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
           out_dtype: torch.dtype | None) -> torch.Tensor:
    K, N, G, out_dtype = _validate(f"quant_matmul_{mode}", x, q, scale, out_dtype)
    picked = kernel_for(mode, x.numel() // max(K, 1), K, N, K // G, out_dtype == torch.float32,
                        _aligned(x, q, scale))
    return _launch(picked, x, q, scale, K, N, G, out_dtype)


def quant_matmul_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [..., K] @ (q [K, N] * scale [N])`` by the kernel ``kernel_for``
    picks. Raises on a tensor it does not take, a CPU one included."""
    return _route("int8", x, q, scale, out_dtype)


def quant_matmul_int4(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [..., K] @ dequant(q [K//2, N], scale [G, N])`` by the kernel
    ``kernel_for`` picks, per-group scales along K (group K / G, even).
    Raises on a tensor it does not take, a CPU one included."""
    return _route("int4", x, q, scale, out_dtype)
