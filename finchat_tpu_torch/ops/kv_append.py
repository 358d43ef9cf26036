"""In-place decode KV append: the write half of the decode hot path.

``paged_kv_append`` writes one token's K row and V row per sequence into
layer ``layer`` of the paged cache at ``page_table[b, pos // page_size]``,
row ``pos % page_size``; a lane with ``n_valid == 0`` writes the trash page
0 instead. The update is in place (the JAX kernel's
``input_output_aliases`` is what PyTorch gives for free).

``paged_kv_append`` launches the hand-written kernel (``csrc/kv_append.cu``,
replacing the TPU kernel ``_append_kernel``) and takes CUDA tensors only;
``paged_kv_append_ref`` is its plain version, which the tests and
``chip_smoke.py`` hold the kernel against (bit-exact). ``ops/dispatch.py``
picks one by the tensors' device.

``paged_kv_append_q8`` is the int8 cache's append (replacing
``_append_kernel_q8``): each K and V head row is quantized on its own
(``engine/kv_cache.quantize_kv_rows``: amax / 127, a true division,
round half to even), the int8 row written into the page and its scale
into the scale plane at ``[layer, phys, head, pos % page_size]``. Only the
one row is written; ``paged_kv_append_q8_ref`` is its plain version,
held bit-exact, data and scales.

``prepare_append`` / ``prepare_append_q8`` check a call and build its
launch (``kernels.Prepared``, ``out`` the K pages, written in place); the
wrappers launch it once, ``chip_smoke.py`` times the launch alone.
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.engine.kv_cache import quantize_kv_rows
from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.kernels import check

TRASH_PAGE = 0


def paged_kv_append_ref(
    kv_new: torch.Tensor,  # [B, 1, 2*Hkv*hd] — fused k row ++ v row per sequence
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*hd]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32
    pos: torch.Tensor,  # [B] int32 absolute write positions
    n_valid: torch.Tensor,  # [B] int32 (0 redirects the write to the trash page)
    layer: int,
    *,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: one indexed row write per sequence, in place."""
    HD = k_pages.shape[-1]
    phys, off = _append_rows(page_table, pos, n_valid, page_size)
    k_pages[layer].index_put_((phys, off), kv_new[:, 0, :HD].to(k_pages.dtype))
    v_pages[layer].index_put_((phys, off), kv_new[:, 0, HD:].to(v_pages.dtype))
    return k_pages, v_pages


def _append_rows(page_table: torch.Tensor, pos: torch.Tensor, n_valid: torch.Tensor,
                 page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, row in page) per sequence; invalid lanes go to the
    trash page and read no table column past their row."""
    valid = n_valid.long() > 0
    pos_l = pos.long()
    logical = torch.where(valid, pos_l // page_size, torch.zeros_like(pos_l))
    phys = torch.gather(page_table.long(), 1, logical[:, None])[:, 0]
    phys = torch.where(valid, phys, torch.full_like(phys, TRASH_PAGE))
    return phys, pos_l % page_size


def paged_kv_append_q8_ref(
    kv_new: torch.Tensor,  # [B, 1, 2*Hkv*hd] float — fused k row ++ v row
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*hd] int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    n_valid: torch.Tensor,
    layer: int,
    *,
    page_size: int,
    n_kv: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: quantize each head row, one indexed write per
    sequence into the pages and the scale planes, in place."""
    HD = k_pages.shape[-1]
    phys, off = _append_rows(page_table, pos, n_valid, page_size)
    heads = torch.arange(n_kv, device=k_pages.device)[None, :]
    for rows, pages, scales in ((kv_new[:, 0, :HD], k_pages, k_scales),
                                (kv_new[:, 0, HD:], v_pages, v_scales)):
        q8, s = quantize_kv_rows(rows, n_kv)
        pages[layer].index_put_((phys, off), q8)
        scales[layer].index_put_((phys[:, None], heads, off[:, None]), s)
    return k_pages, v_pages, k_scales, v_scales


def paged_kv_append(
    kv_new: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    n_valid: torch.Tensor,
    layer: int,
    *,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Append one token's K/V per sequence into layer ``layer``'s pages, in
    place, by the CUDA kernel (bf16 only); returns the same cache pair.
    Raises on a tensor it does not take, a CPU one included."""
    prepare_append(kv_new, k_pages, v_pages, page_table, pos, n_valid, layer,
                   page_size=page_size).launch()
    return k_pages, v_pages


def prepare_append(kv_new: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                   page_table: torch.Tensor, pos: torch.Tensor, n_valid: torch.Tensor,
                   layer: int, *, page_size: int) -> kernels.Prepared:
    """Check a ``paged_kv_append`` call and build its launch."""
    check(k_pages.is_cuda, "the kv_append kernel runs on CUDA tensors "
          "(paged_kv_append_ref is the plain version)")
    L, P, PS, HD = k_pages.shape
    B = kv_new.shape[0]
    check(k_pages.dtype == torch.bfloat16 and v_pages.dtype == torch.bfloat16
          and kv_new.dtype == torch.bfloat16, "kv_append kernel takes bf16 only")
    check(v_pages.shape == k_pages.shape and kv_new.shape == (B, 1, 2 * HD),
          f"kv_append shapes: kv_new {tuple(kv_new.shape)}, pages {tuple(k_pages.shape)}")
    check(PS == page_size and HD % 8 == 0, "kv_append needs page_size match, Hkv*hd % 8 == 0")
    check(page_table.dtype == torch.int32 and pos.dtype == torch.int32
          and n_valid.dtype == torch.int32, "kv_append index tensors must be int32")
    check(page_table.shape[0] == B and pos.shape == (B,) and n_valid.shape == (B,),
          "kv_append per-sequence shapes disagree")
    for t in (kv_new, k_pages, v_pages, page_table, pos, n_valid):
        check(t.is_cuda and t.device == k_pages.device and t.is_contiguous(),
              "kv_append tensors must be contiguous on one CUDA device")
    check(0 <= layer < L, f"layer {layer} out of range")
    args = (kv_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            pos.data_ptr(), n_valid.data_ptr(), layer, B, P, PS, HD, page_table.shape[1])
    return kernels.Prepared("kv_append", args, k_pages,
                            (kv_new, k_pages, v_pages, page_table, pos, n_valid))


def paged_kv_append_q8(
    kv_new: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    n_valid: torch.Tensor,
    layer: int,
    *,
    page_size: int,
    n_kv: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize and append one token's K/V per sequence into layer
    ``layer``'s int8 pages and scale planes, in place, by the CUDA kernel
    (bf16 rows in); returns the same four tensors. Raises on a tensor it
    does not take, a CPU one included."""
    prepare_append_q8(kv_new, k_pages, v_pages, k_scales, v_scales, page_table, pos, n_valid,
                      layer, page_size=page_size, n_kv=n_kv).launch()
    return k_pages, v_pages, k_scales, v_scales


def prepare_append_q8(kv_new: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                      k_scales: torch.Tensor, v_scales: torch.Tensor, page_table: torch.Tensor,
                      pos: torch.Tensor, n_valid: torch.Tensor, layer: int, *, page_size: int,
                      n_kv: int) -> kernels.Prepared:
    """Check a ``paged_kv_append_q8`` call and build its launch."""
    check(k_pages.is_cuda, "the kv_append_q8 kernel runs on CUDA tensors "
          "(paged_kv_append_q8_ref is the plain version)")
    L, P, PS, HD = k_pages.shape
    B = kv_new.shape[0]
    check(k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8
          and kv_new.dtype == torch.bfloat16, "kv_append_q8 takes bf16 rows into int8 pages")
    check(k_scales.dtype == torch.float32 and v_scales.dtype == torch.float32,
          "kv_append_q8 scale planes must be fp32")
    check(v_pages.shape == k_pages.shape and kv_new.shape == (B, 1, 2 * HD),
          f"kv_append_q8 shapes: kv_new {tuple(kv_new.shape)}, pages {tuple(k_pages.shape)}")
    SPAD = k_scales.shape[2]
    check(k_scales.shape == (L, P, SPAD, PS) and v_scales.shape == k_scales.shape
          and n_kv <= SPAD and HD % n_kv == 0,
          f"kv_append_q8 scale planes {tuple(k_scales.shape)} disagree with the pages")
    check(PS == page_size, "kv_append_q8 needs page_size match")
    check(page_table.dtype == torch.int32 and pos.dtype == torch.int32
          and n_valid.dtype == torch.int32, "kv_append_q8 index tensors must be int32")
    check(page_table.shape[0] == B and pos.shape == (B,) and n_valid.shape == (B,),
          "kv_append_q8 per-sequence shapes disagree")
    for t in (kv_new, k_pages, v_pages, k_scales, v_scales, page_table, pos, n_valid):
        check(t.is_cuda and t.device == k_pages.device and t.is_contiguous(),
              "kv_append_q8 tensors must be contiguous on one CUDA device")
    check(0 <= layer < L, f"layer {layer} out of range")
    args = (kv_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), page_table.data_ptr(), pos.data_ptr(), n_valid.data_ptr(),
            layer, B, P, PS, n_kv, HD // n_kv, SPAD, page_table.shape[1])
    return kernels.Prepared("kv_append_q8", args, k_pages,
                            (kv_new, k_pages, v_pages, k_scales, v_scales, page_table, pos,
                             n_valid))
