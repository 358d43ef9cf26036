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

The engine writes through the KV-row writer instead, for every cache write
of a serve: decode rows, prefill chunks and ragged rounds alike.
``plan_kv_rows`` (a chunk of C tokens per sequence, C = 1 at decode) and
``plan_kv_rows_ragged`` (a packed round) build a step's ``KVRows`` once,
outside the layers: each token's destination row ``phys * page_size +
offset`` by the rule of ``engine/kv_cache._chunk_rows`` (token (b, i) at
``start_pos[b] + i``, a lane with ``i >= n_valid[b]`` in the trash page 0),
every index tensor checked there once. ``paged_kv_write`` then writes one
layer's K and V rows, read where they lie (each with its own row stride),
in one launch of ``csrc/kv_write_sm90.cu``: ``kv_append_sm90`` into a bf16
cache, ``kv_append_q8_sm90`` quantizing in registers into an int8 cache
(``append_kernel_for`` names the one). Its plain version,
``paged_kv_write_ref``, is the chunk scatter ``scatter_kv_chunk`` /
``scatter_kv_chunk_q8`` on the plan's own inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from finchat_tpu_torch.engine.kv_cache import (
    quantize_kv_rows,
    scatter_kv_chunk,
    scatter_kv_chunk_q8,
)
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


# --- the KV-row writer: one planned launch a layer for every cache write ------


@dataclass(frozen=True)
class KVRows:
    """A step's KV-row plan, shared by every layer's write: ``rows`` [N]
    int32 on the cache's device, token t's destination row ``phys *
    page_size + offset`` in a layer's pages (a padding lane's in the trash
    page 0), and the inputs it was built from, which the plain version
    takes: ``page_table`` [B, max_pages] (for a ragged round the per-row
    page lists, ``token_row`` [N] naming each token's row), ``start_pos`` and
    ``n_valid`` [B], and ``chunk`` tokens a sequence (N = B * chunk)."""

    rows: torch.Tensor
    page_table: torch.Tensor
    start_pos: torch.Tensor
    n_valid: torch.Tensor
    chunk: int
    page_size: int
    token_row: torch.Tensor | None = None


def _check_index(name: str, t: torch.Tensor, ndim: int, device: torch.device) -> None:
    check(t.dtype == torch.int32 and t.dim() == ndim and t.device == device,
          f"the KV-row plan: {name} must be an int32 tensor of {ndim} dims on {device} "
          f"(got {t.dtype}, {t.dim()} dims on {t.device})")


def plan_kv_rows(page_table: torch.Tensor, start_pos: torch.Tensor, n_valid: torch.Tensor,
                 C: int, page_size: int) -> KVRows:
    """The rows of a step that writes C tokens per sequence (C = 1 at
    decode): token (b, i) at position ``start_pos[b] + i``, through
    ``page_table[b]``; a lane with ``i >= n_valid[b]`` goes to the trash
    page 0 at ``pos % page_size`` and reads no table column past its row
    (the rule of ``engine/kv_cache._chunk_rows``, whose clamp of the column
    is kept). Built once, with torch ops on the table's device, no host
    sync."""
    dev = page_table.device
    _check_index("page_table", page_table, 2, dev)
    _check_index("start_pos", start_pos, 1, dev)
    _check_index("n_valid", n_valid, 1, dev)
    B, max_pages = page_table.shape
    check(start_pos.shape[0] == B and n_valid.shape[0] == B,
          f"plan_kv_rows: start_pos {tuple(start_pos.shape)} and n_valid "
          f"{tuple(n_valid.shape)} must have the table's {B} sequences")
    check(C >= 1 and page_size >= 1, f"plan_kv_rows: C {C}, page_size {page_size}")
    i = torch.arange(C, device=dev)[None, :]
    pos = start_pos.long()[:, None] + i  # [B, C]
    valid = i < n_valid.long()[:, None]
    logical = torch.where(valid, pos // page_size, 0).clamp(max=max_pages - 1)
    phys = torch.where(valid, page_table.gather(1, logical).long(), TRASH_PAGE)
    rows = (phys * page_size + pos % page_size).to(torch.int32).reshape(-1)
    return KVRows(rows, page_table, start_pos, n_valid, C, page_size)


def plan_kv_rows_ragged(page_rows: torch.Tensor, tok_row: torch.Tensor, tok_pos: torch.Tensor,
                        page_size: int) -> KVRows:
    """The rows of a packed ragged round: token t of row ``tok_row[t]``
    (``R`` = padding, which goes to the trash page) at ``tok_pos[t]``,
    through ``page_rows[tok_row[t]]``. One lookup a token, where the chunk
    rule over the gathered ``page_rows[tok_row]`` [T, max_pages] table
    gives the same rows (tests/test_torch_kv_write.py)."""
    dev = page_rows.device
    _check_index("page_rows", page_rows, 2, dev)
    _check_index("tok_row", tok_row, 1, dev)
    _check_index("tok_pos", tok_pos, 1, dev)
    R, max_pages = page_rows.shape
    check(tok_pos.shape == tok_row.shape, f"plan_kv_rows_ragged: tok_pos "
          f"{tuple(tok_pos.shape)} and tok_row {tuple(tok_row.shape)} disagree")
    valid = tok_row < R
    safe = tok_row.long().clamp(max=R - 1)
    pos = tok_pos.long()
    logical = torch.where(valid, pos // page_size, 0).clamp(max=max_pages - 1)
    phys = torch.where(valid, page_rows[safe, logical].long(), TRASH_PAGE)
    rows = (phys * page_size + pos % page_size).to(torch.int32)
    return KVRows(rows, page_rows, tok_pos, valid.to(torch.int32), 1, page_size, token_row=safe)


def append_kernel_for(cache_dtype: torch.dtype, n_kv: int, head_dim: int) -> str:
    """The KV-row writer's entry for a cache of ``cache_dtype`` (a pure
    function, like ``quant_matmul.kernel_for``): ``kv_append_sm90`` for
    bf16, ``kv_append_q8_sm90`` for int8 (head rows of at most 256 values).
    Rows must be whole 16-byte chunks. Raises for a cache neither takes:
    there is no other body to fall back to."""
    if not (n_kv >= 1 and head_dim >= 8 and head_dim % 8 == 0):
        raise ValueError(f"the KV-row writer takes head rows of a multiple of 8 values "
                         f"(n_kv {n_kv}, head_dim {head_dim})")
    if cache_dtype == torch.int8:
        if head_dim > 256:
            raise ValueError(f"kv_append_q8_sm90 takes head_dim <= 256, not {head_dim}")
        return "kv_append_q8_sm90"
    if cache_dtype != torch.bfloat16:
        raise ValueError(f"the KV-row writer takes a bf16 or int8 cache, not {cache_dtype}")
    return "kv_append_sm90"


_WRITE_TENSORS = ("rows", "k", "v", "k_pages", "v_pages")


def _row_stride(name: str, x: torch.Tensor, N: int, HD: int) -> int:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"paged_kv_write: {name} must be bf16, not {x.dtype}")
    if not (x.dim() == 2 and x.shape[0] == N and x.shape[1] == HD and x.stride(1) == 1
            and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0):
        raise ValueError(f"paged_kv_write: {name} must be [{N}, {HD}] rows of 16-byte chunks "
                         f"(got {tuple(x.shape)}, strides {x.stride()})")
    return x.stride(0)


def prepare_kv_write(rows: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor, layer: int, *,
                     k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
                     n_kv: int | None = None) -> kernels.Prepared:
    """Check a ``paged_kv_write`` call and build its launch (``out`` the K
    pages, written in place). The engine calls it once a layer, so the
    checks are plain comparisons and a message is formatted only for a
    call it refuses."""
    tensors = (rows, k, v, k_pages, v_pages)
    if not all(t.is_cuda for t in tensors):
        name = next(n for n, t in zip(_WRITE_TENSORS, tensors) if not t.is_cuda)
        raise ValueError(f"paged_kv_write: {name} is a CPU tensor; the KV-row writer runs on "
                         "CUDA tensors (paged_kv_write_ref is the plain version)")
    if not (rows.dtype == torch.int32 and rows.dim() == 1 and rows.is_contiguous()
            and rows.shape[0] >= 1):
        raise ValueError(f"paged_kv_write: rows must be a contiguous int32 [N] tensor, N >= 1 "
                         f"(got {rows.dtype}, shape {tuple(rows.shape)}, strides "
                         f"{rows.stride()})")
    L, P, PS, HD = k_pages.shape
    if not (v_pages.shape == k_pages.shape and v_pages.dtype == k_pages.dtype
            and k_pages.is_contiguous() and v_pages.is_contiguous() and 0 <= layer < L):
        raise ValueError(f"paged_kv_write: k_pages {tuple(k_pages.shape)} and v_pages "
                         f"{tuple(v_pages.shape)} must be one contiguous [L, P, page_size, HD] "
                         f"shape and type, and layer {layer} one of its L")
    N = rows.shape[0]
    strides = (_row_stride("k", k, N, HD), _row_stride("v", v, N, HD))
    dev = k_pages.get_device()
    if not all(t.get_device() == dev for t in tensors):
        raise ValueError("paged_kv_write: tensors on more than one device")
    args = (k.data_ptr(), v.data_ptr(), rows.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if k_pages.dtype != torch.int8:
        name = append_kernel_for(k_pages.dtype, 1, HD)
        return kernels.Prepared(name, args + (layer, N, P, PS, HD) + strides, k_pages,
                                tensors)
    if n_kv is None or n_kv < 1 or HD % n_kv:
        raise ValueError(f"paged_kv_write: an int8 cache needs n_kv dividing {HD} (got {n_kv})")
    name = append_kernel_for(k_pages.dtype, n_kv, HD // n_kv)
    if k_scales is None or v_scales is None:
        raise ValueError("paged_kv_write: an int8 cache needs its scale planes")
    SPAD = k_scales.shape[2]
    if not (k_scales.dtype == torch.float32 and v_scales.dtype == torch.float32
            and k_scales.shape == (L, P, SPAD, PS) and v_scales.shape == k_scales.shape
            and n_kv <= SPAD and k_scales.is_contiguous() and v_scales.is_contiguous()
            and k_scales.get_device() == dev and v_scales.get_device() == dev):
        raise ValueError(f"paged_kv_write: scale planes {tuple(k_scales.shape)} "
                         f"{k_scales.dtype} disagree with the pages {tuple(k_pages.shape)}")
    return kernels.Prepared(
        name, args + (k_scales.data_ptr(), v_scales.data_ptr(), layer, N, P, PS, n_kv,
                      HD // n_kv, SPAD) + strides,
        k_pages, tensors + (k_scales, v_scales))


def paged_kv_write(rows: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, layer: int, *, k_scales: torch.Tensor | None = None,
                   v_scales: torch.Tensor | None = None, n_kv: int | None = None) -> None:
    """Write N tokens' K and V rows (``k``, ``v`` bf16 [N, Hkv*hd], each row
    stride a whole number of 16-byte chunks) into layer ``layer``'s pages at
    ``rows`` (``KVRows.rows``), in place, in one launch of the KV-row
    writer; an int8 cache (``k_scales``, ``v_scales``, ``n_kv`` given)
    quantizes each head row and writes its scale. Raises on a tensor it
    does not take, a CPU one included."""
    prepare_kv_write(rows, k, v, k_pages, v_pages, layer, k_scales=k_scales, v_scales=v_scales,
                     n_kv=n_kv).launch()


def paged_kv_write_ref(plan: KVRows, k: torch.Tensor, v: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, layer: int, *,
                       k_scales: torch.Tensor | None = None,
                       v_scales: torch.Tensor | None = None, n_kv: int | None = None) -> None:
    """Plain version: the chunk scatter on the plan's own inputs (a ragged
    round's table gathered per token), quantizing for an int8 cache — the
    write the engine made before the writer existed, held against the JAX
    package's ``scatter_kv_chunk`` / ``scatter_kv_chunk_q8``."""
    B, C = plan.start_pos.shape[0], plan.chunk
    table = plan.page_table if plan.token_row is None else plan.page_table[plan.token_row]
    k4, v4 = k.reshape(B, C, 1, -1), v.reshape(B, C, 1, -1)
    if k_pages.dtype == torch.int8:
        if n_kv is None:
            raise ValueError("an int8 KV write needs n_kv")
        scatter_kv_chunk_q8(k_pages, v_pages, k_scales, v_scales, k4, v4, table, plan.start_pos,
                            plan.n_valid, plan.page_size, layer, n_kv)
    else:
        scatter_kv_chunk(k_pages, v_pages, k4, v4, table, plan.start_pos, plan.n_valid,
                         plan.page_size, layer)
