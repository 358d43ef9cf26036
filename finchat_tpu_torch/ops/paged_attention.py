"""Paged attention over the KV cache: the read half of prefill and decode.

``paged_flash_attention(q [B, C, H, D], k_pages, v_pages, page_table,
q_offset, kv_len, layer)`` is causal GQA attention with absolute positions:
query row i of sequence b sits at ``q_offset[b] + i`` and keys at or past
``kv_len[b]`` are masked (``kv_len`` counts this chunk's tokens, which must
already be in the pages). ``C = 1`` is decode, ``C = chunk`` is prefill.

``paged_flash_attention`` launches the hand-written kernel
(``csrc/paged_attention.cu``, replacing the TPU kernel ``_paged_kernel``)
and takes CUDA tensors only; ``paged_attention_ref`` is its plain version —
``gather_kv`` + ``mha_reference``, exactly the JAX package's reference
branch. ``ops/dispatch.py`` picks one by the tensors' device. The two
differ on a sequence with ``kv_len == 0``: the kernel writes zeros, the
reference (like JAX's) averages the gathered trash values; nothing reads
such a row.

``paged_flash_attention_q8`` is the same kernel body over an int8 cache
with per-token-per-head scale planes (replacing ``_paged_kernel_q8``): each
staged K/V tile is dequantized as ``bf16(float(q8) * scale)`` on its way
into shared memory. ``paged_attention_q8_ref`` is its plain version
(``gather_kv_q8`` + ``mha_reference``).
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.engine.kv_cache import gather_kv, gather_kv_q8
from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.kernels import check
from finchat_tpu_torch.ops.refs import mha_reference

MAX_ROWS = 64  # query rows per kernel block: group * tile tokens
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may opt into
DECODE_PAGES_PER_SPLIT = 4  # decode: pages per block before splitting a sequence


def paged_attention_ref(
    q: torch.Tensor,  # [B, C, H, D]
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    q_offset: torch.Tensor,  # [B]
    kv_len: torch.Tensor,  # [B]
    layer: int,
    *,
    page_size: int,
    n_kv: int,
) -> torch.Tensor:
    """Plain version: gather every sequence's pages into a dense copy, then
    masked attention with fp32 softmax."""
    k_all, v_all = gather_kv(k_pages, v_pages, page_table, page_size, layer, n_kv)
    return mha_reference(q, k_all.to(q.dtype), v_all.to(q.dtype), causal=True,
                         q_offset=q_offset, kv_len=kv_len)


def paged_attention_q8_ref(
    q: torch.Tensor,  # [B, C, H, D]
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,
    q_offset: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    *,
    page_size: int,
    n_kv: int,
) -> torch.Tensor:
    """Plain version over the int8 cache: gather and dequantize every
    sequence's pages to the query dtype, then masked attention."""
    k_all, v_all = gather_kv_q8(k_pages, v_pages, k_scales, v_scales, page_table, page_size,
                                layer, n_kv, dtype=q.dtype)
    return mha_reference(q, k_all, v_all, causal=True, q_offset=q_offset, kv_len=kv_len)


def key_tile(page_size: int) -> int:
    """Keys a kernel block stages at a time: 64, or the largest power of two
    up to 64 dividing the page (a tile never straddles pages)."""
    for kt in (64, 32, 16, 8):
        if page_size % kt == 0:
            return kt
    raise ValueError(f"page_size {page_size} must be a multiple of 8 for the kernels")


def smem_bytes(D: int, kt: int, rows: int) -> int:
    """Dynamic shared memory of one kernel block (csrc/attention_common.cuh)."""
    return (MAX_ROWS * 4 + kt * (D // 2 + 1) * 4 + kt * D * 2
            + rows * D * 4 + rows * kt * 4 + rows * 3 * 4)


def tile_tokens(group: int, C: int) -> int:
    """Query tokens per kernel block: as many as keep group * tokens <= 64
    (16 for Llama-3's group of 4), never more than the chunk."""
    return max(1, min(C, MAX_ROWS // group))


def check_kernel_shapes(q_heads: int, D: int, k_pages: torch.Tensor, v_pages: torch.Tensor,
                        page_size: int, n_kv: int, rows: int,
                        scales: tuple[torch.Tensor, torch.Tensor] | None = None) -> None:
    """The constraints the attention kernels share: a bf16 cache, or (with
    ``scales``) an int8 cache with its fp32 scale planes."""
    if scales is None:
        check(k_pages.dtype == torch.bfloat16 and v_pages.dtype == torch.bfloat16,
              "this attention kernel takes a bf16 cache (int8 pages go to the _q8 kernel)")
    else:
        k_scales, v_scales = scales
        check(k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8,
              "the _q8 attention kernels take an int8 cache")
        L, P, PS = k_pages.shape[:3]
        check(k_scales.dtype == torch.float32 and v_scales.dtype == torch.float32
              and k_scales.dim() == 4 and k_scales.shape == v_scales.shape
              and k_scales.shape[:2] == (L, P) and k_scales.shape[3] == PS
              and k_scales.shape[2] >= n_kv,
              f"scale planes {tuple(k_scales.shape)} disagree with pages {tuple(k_pages.shape)}")
    check(k_pages.dim() == 4 and v_pages.shape == k_pages.shape,
          f"pages must be [L, P, page_size, Hkv*D], got {tuple(k_pages.shape)}")
    check(k_pages.shape[2] == page_size and k_pages.shape[3] == n_kv * D,
          f"pages {tuple(k_pages.shape)} disagree with page_size {page_size}, "
          f"n_kv {n_kv}, head_dim {D}")
    check(D == 128, f"attention kernels are built for head_dim 128 (Llama-3), got {D}")
    check(q_heads % n_kv == 0 and (q_heads // n_kv) <= MAX_ROWS,
          f"heads {q_heads} / kv heads {n_kv} must be a group of at most {MAX_ROWS}")
    check(page_size % 8 == 0, "page_size must be a multiple of 8")
    check(smem_bytes(D, key_tile(page_size), rows) <= SMEM_LIMIT,
          "a kernel block would need more shared memory than the card has")


def paged_flash_attention(
    q: torch.Tensor,  # [B, C, H, D]
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] — full-depth cache
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32 physical page ids (0 = trash)
    q_offset: torch.Tensor,  # [B] int32 — absolute position of q[:, 0]
    kv_len: torch.Tensor,  # [B] int32 — valid KV length incl. this chunk's tokens
    layer: int,
    *,
    page_size: int,
    n_kv: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention over the paged KV cache by the CUDA kernel (bf16); returns
    [B, C, H, D]. Raises on a tensor it does not take, a CPU one included."""
    B, C, H, D = q.shape
    check(q.is_cuda, "the paged attention kernel runs on CUDA tensors "
          "(paged_attention_ref is the plain version)")
    return _launch_paged("paged_attention", q, k_pages, v_pages, None, page_table, q_offset,
                         kv_len, layer, page_size=page_size, n_kv=n_kv, scale=scale)


def paged_flash_attention_q8(
    q: torch.Tensor,  # [B, C, H, D]
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,
    q_offset: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    *,
    page_size: int,
    n_kv: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention over the int8 paged KV cache by the CUDA kernel; returns
    [B, C, H, D] bf16. Raises on a tensor it does not take, a CPU one
    included."""
    check(q.is_cuda, "the paged attention kernel runs on CUDA tensors "
          "(paged_attention_q8_ref is the plain version)")
    return _launch_paged("paged_attention_q8", q, k_pages, v_pages, (k_scales, v_scales),
                         page_table, q_offset, kv_len, layer, page_size=page_size, n_kv=n_kv,
                         scale=scale)


def _launch_paged(name: str, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                  scales: tuple[torch.Tensor, torch.Tensor] | None, page_table: torch.Tensor,
                  q_offset: torch.Tensor, kv_len: torch.Tensor, layer: int, *, page_size: int,
                  n_kv: int, scale: float | None) -> torch.Tensor:
    B, C, H, D = q.shape
    group = H // n_kv
    bq = tile_tokens(group, C)
    check(q.dtype == torch.bfloat16, "paged attention kernel takes bf16 q only")
    check_kernel_shapes(H, D, k_pages, v_pages, page_size, n_kv, group * bq, scales)
    check(page_table.dtype == torch.int32 and q_offset.dtype == torch.int32
          and kv_len.dtype == torch.int32, "page_table, q_offset, kv_len must be int32")
    check(page_table.shape[0] == B and q_offset.shape == (B,) and kv_len.shape == (B,),
          "per-sequence descriptor shapes disagree with q")
    for t in (q, k_pages, v_pages, page_table, q_offset, kv_len, *(scales or ())):
        check(t.is_cuda and t.device == q.device and t.is_contiguous(),
              "paged attention tensors must be contiguous on one CUDA device")
    check(0 <= layer < k_pages.shape[0], f"layer {layer} out of range")
    out = torch.empty_like(q)
    L, P, PS, _ = k_pages.shape
    MP = page_table.shape[1]
    part_acc = part_ml = None
    splits, pps = 1, MP
    if C == 1 and MP > DECODE_PAGES_PER_SPLIT:
        # decode: split each sequence's pages over several blocks; the fp32
        # partials (scratch, allocated here) merge in a second small kernel
        pps = DECODE_PAGES_PER_SPLIT
        splits = -(-MP // pps)
        part_acc = torch.empty((splits, B * C, H, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((splits, B * C, H, 2), dtype=torch.float32, device=q.device)
    cache = [k_pages.data_ptr(), v_pages.data_ptr()]
    dims = [layer, B, C, H, n_kv, D, P, PS]
    if scales is not None:
        cache += [scales[0].data_ptr(), scales[1].data_ptr()]
        dims.append(scales[0].shape[2])
    kernels.launch(
        name, q.data_ptr(), *cache,
        out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), page_table.data_ptr(),
        q_offset.data_ptr(), kv_len.data_ptr(),
        *dims, key_tile(PS), MP, bq, splits, pps,
        float(scale if scale is not None else D ** -0.5),
    )
    return out
