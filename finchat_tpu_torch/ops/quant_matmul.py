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

Three kernels serve the calls, picked by ``kernel_for``, a pure function of
the call's shapes, output dtype and pointer alignment. Two of them need
operands TMA can read — K % 8 == 0, N % 16 == 0, x, q and scale 16-byte
aligned, an int4 group of a multiple of 8 rows:

- ``quant_matmul_{int8,int4}_decode_sm90`` (``csrc/quant_matmul_decode_sm90.cu``):
  at most 64 rows (every decode step, the head), bf16 or fp32 output. Split
  K over a TMA ring of the stored weight, ``wgmma`` with the operands
  swapped and the weight dequantized into register fragments; the split
  comes from ``decode_split``.
- ``quant_matmul_{int8,int4}_sm90`` (``csrc/quant_matmul_sm90.cu``): more
  than 64 rows (prefill chunks, ragged rounds), bf16 output.
  Warp-specialized: TMA loads, a dequantizing producer warpgroup, ``wgmma``
  consumers.
- ``quant_matmul_{int8,int4}`` ("v2", ``csrc/quant_matmul.cu``): every other
  call — shapes TMA cannot take, and more than 64 rows with fp32 output.

Nothing gives way to anything else: a CUDA tensor reaches the kernel
``kernel_for`` names or raises. ``run_kernel`` launches a named kernel with
no routing, ``prepare`` builds one launch to run again (``chip_smoke.py``
times the kernels on the same inputs with them).

``quant_matmul_ref`` is the plain version: ``x @ dequantize(w, x.dtype)``,
or a product with fp32 output for the head — the JAX package's
``quant_matmul_ref`` up to the frameworks' accumulation order. The tests
and ``chip_smoke.py`` hold the kernels against it; ``ops/dispatch.py``
picks one by the tensor's device.
"""

from __future__ import annotations

import functools
import math

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


# the decode body's block: 128 output columns over K tiles of 64 rows, at
# most 64 rows of x (csrc/quant_matmul_decode_sm90.cu)
DECODE_MAX_ROWS = 64
DECODE_BLOCK_N = 128
DECODE_TILE_K = 64


def _tma_takes(K: int, N: int, group: int, aligned: bool) -> bool:
    """Operands TMA can read: x rows and weight rows of 16-byte multiples,
    16-byte aligned bases, int4 scale groups of whole 8-row chunks."""
    return aligned and K % 8 == 0 and N > 0 and N % 16 == 0 and group % 8 == 0


def kernel_for(mode: str, M: int, K: int, N: int, group: int, out_f32: bool,
               aligned: bool = True) -> str:
    """The kernel that serves a ``mode`` ("int8" or "int4") call of ``M``
    rows on a ``[K, N]`` weight whose scales span ``group`` rows of K each
    (K for int8 and for per-column int4), with fp32 output if ``out_f32``
    and ``aligned`` if x, q and scale start on 16-byte boundaries."""
    if _tma_takes(K, N, group, aligned):
        if M <= DECODE_MAX_ROWS:
            return f"quant_matmul_{mode}_decode_sm90"
        if not out_f32:
            return f"quant_matmul_{mode}_sm90"
    return f"quant_matmul_{mode}"


@functools.cache  # called for every decode-step matmul: the plan is a pure function of its ints
def decode_split(K: int, N: int, group: int, n_sm: int) -> tuple[int, int]:
    """(splits, k_split) of a call to the decode body on a ``[K, N]`` weight
    with scale groups of ``group`` rows: split s covers k in [s * k_split,
    min(K, (s + 1) * k_split)), each split a whole number of 64-row K tiles
    and, where the scales have more than one group, of groups.

    An SM runs two of the body's blocks at once, and a block's time grows
    with the units it walks. So among the plans whose ``ceil(N / 128)``
    column blocks times splits make one to two waves on ``n_sm`` SMs, it
    takes the one whose busiest SM has the fewest units to walk (waves
    times units a split), the fewest splits on a tie: fewer partials to
    write and sum (``tools/qmm_decode_diag.py`` times the alternatives). A
    weight with more column blocks than that is not split; one whose K has
    too few units splits into all of them."""
    if min(K, N, group, n_sm) < 1:
        raise ValueError("decode_split takes positive K, N, group, n_sm")
    unit = DECODE_TILE_K if group >= K else math.lcm(DECODE_TILE_K, group)
    n_units = -(-K // unit)
    col_blocks = -(-N // DECODE_BLOCK_N)
    lo, hi = -(-n_sm // col_blocks), max(1, 2 * n_sm // col_blocks)
    plans = {-(-n_units // per): per for per in range(n_units, 0, -1)}  # splits -> units a split
    fit = ([s for s in plans if lo <= s <= hi]
           or [min((s for s in plans if s >= lo), default=max(plans))])
    splits = min(fit, key=lambda s: (-(-col_blocks * s // n_sm) * plans[s], s))
    return splits, plans[splits] * unit


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(name: str, x: torch.Tensor, q: torch.Tensor) -> None:
    check(x.is_cuda, f"the {name} kernel runs on CUDA tensors (quant_matmul_ref is the "
          "plain version)")
    check(q.dtype == torch.int8 and q.dim() == 2, f"{name} takes a 2-D int8 weight")


def _validate(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              out_dtype: torch.dtype | None) -> tuple[int, int, int, torch.dtype]:
    """(K, N, G, output dtype) of a call every kernel of ``name``'s mode
    takes, checked: 2-D weight, its scales, dtypes, one device, contiguity."""
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


def _prepare(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, K: int, N: int,
             G: int, out_dtype: torch.dtype) -> kernels.Prepared:
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((*x.shape[:-1], N), dtype=out_dtype, device=x.device)
    groups = (G,) if "int4" in name else ()
    out_f32 = int(out_dtype == torch.float32)
    ws = None
    if name.endswith("_decode_sm90"):
        splits, k_split = decode_split(K, N, K // G, _sm_count(x.device.index or 0))
        if splits > 1:  # the splits' fp32 partials, summed in split order
            ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
        args = (ws.data_ptr() if ws is not None else None, M, K, N, *groups, out_f32, splits,
                k_split)
    elif name.endswith("_sm90"):
        args = (M, K, N, *groups)
    else:
        # 16-byte vector loads where rows and the base are aligned; v2 loads
        # element by element elsewhere
        x_vec = int(K % 8 == 0 and x2.data_ptr() % 16 == 0)
        q_vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0)
        args = (M, K, N, *groups, out_f32, x_vec, q_vec)
    ptrs = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr())
    return kernels.Prepared(name, ptrs + args, out, (x2, q, scale), ws)


def _launch(prepared: kernels.Prepared) -> torch.Tensor:
    if prepared.out.numel():
        prepared.launch()
    return prepared.out


def _check_named(name: str, M: int, K: int, N: int, G: int, out_dtype: torch.dtype,
                 aligned: bool) -> None:
    if name.endswith("_sm90"):
        check(_tma_takes(K, N, K // G, aligned),
              f"{name} takes K % 8 == 0, N % 16 == 0, int4 groups of a multiple of 8 rows "
              "and 16-byte aligned operands")
    if name.endswith("_decode_sm90"):
        check(1 <= M <= DECODE_MAX_ROWS, f"{name} takes 1 to {DECODE_MAX_ROWS} rows, got {M}")
    elif name.endswith("_sm90"):
        check(out_dtype == torch.bfloat16, f"{name} takes bf16 output")


def prepare(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            out_dtype: torch.dtype | None = None) -> kernels.Prepared:
    """One checked launch of kernel ``name`` on this call, with no routing
    (``.launch()`` runs it; ``.scratch`` is the decode body's split
    workspace, if any). Raises on a tensor or shape the kernel does not
    take."""
    K, N, G, out_dtype = _validate(name, x, q, scale, out_dtype)
    _check_named(name, x.numel() // max(K, 1), K, N, G, out_dtype, _aligned(x, q, scale))
    return _prepare(name, x, q, scale, K, N, G, out_dtype)


def run_kernel(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch kernel ``name`` (v2, the Hopper kernel or the decode body,
    for int8 or int4) on this call, with no routing. Raises on a tensor or
    shape it does not take."""
    return _launch(prepare(name, x, q, scale, out_dtype))


def _route(mode: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
           out_dtype: torch.dtype | None) -> torch.Tensor:
    K, N, G, out_dtype = _validate(f"quant_matmul_{mode}", x, q, scale, out_dtype)
    picked = kernel_for(mode, x.numel() // max(K, 1), K, N, K // G, out_dtype == torch.float32,
                        _aligned(x, q, scale))
    return _launch(_prepare(picked, x, q, scale, K, N, G, out_dtype))


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
