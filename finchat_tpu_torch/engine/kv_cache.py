"""Paged KV cache: device tensors + host-side page allocator (bf16 / fp32,
or int8 with per-token-per-head scales).

- Device side: ``k_pages``/``v_pages`` shaped ``[n_layers, num_pages,
  page_size, n_kv_heads * head_dim]`` — token-major pages with the KV heads
  fused into the minor dim, the JAX package's layout, so the kernels and
  the tests see the same tensors on both sides. Physical page 0 is a TRASH
  page: writes from padding lanes and inactive slots are redirected there,
  which keeps every step a fixed-shape write with no host branching. Its
  contents are garbage by design; attention masks by ``kv_len`` and
  causality alone.
- ``kv_quant="int8"`` stores the pages as int8 with per-token-per-head fp32
  scales in parallel ``[n_layers, num_pages, scale_rows(n_kv_heads),
  page_size]`` planes (heads padded to 8 rows: the JAX package's layout,
  which its session records carry). Each token row is quantized on its own
  at write time (``quantize_kv_rows``), so a write never requantizes rows
  already in the page.
- Writes are in place: ``scatter_kv_chunk`` is an indexed ``index_put_``
  into the layer's pages (the JAX package's XLA scatter rebuilt the buffer;
  PyTorch updates the storage it was given).
- Host side: ``PageAllocator`` — a free list with ownership tracking; a page
  is owned by at most one sequence, and double-free or foreign-free raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from finchat_tpu_torch.models.llama import LlamaConfig
from finchat_tpu_torch.models.quant import symmetric_scale
from finchat_tpu_torch.utils.metrics import METRICS

TRASH_PAGE = 0


def scale_rows(n_kv: int) -> int:
    """Rows of a page's scale block: KV heads padded to a multiple of 8."""
    return -(-n_kv // 8) * 8


@dataclass
class PagedKVCache:
    """Device-side paged cache tensors (the leading layer axis is indexed
    per layer by the attention callbacks and the kernels). ``k_scales`` /
    ``v_scales`` exist for an int8 cache only (``None`` otherwise)."""

    k_pages: torch.Tensor  # [L, P, page_size, Hkv * head_dim] (model dtype, or int8)
    v_pages: torch.Tensor
    page_size: int
    num_pages: int
    k_scales: torch.Tensor | None = None  # [L, P, scale_rows(Hkv), page_size] fp32
    v_scales: torch.Tensor | None = None

    @classmethod
    def create(cls, config: LlamaConfig, num_pages: int, page_size: int,
               device: torch.device | str, kv_quant: str = "") -> "PagedKVCache":
        shape = (config.n_layers, num_pages, page_size,
                 config.n_kv_heads * config.head_dim)
        if kv_quant:
            if kv_quant != "int8":
                raise ValueError(f"unknown kv_quant mode {kv_quant!r} (supported: 'int8')")
            sshape = (config.n_layers, num_pages, scale_rows(config.n_kv_heads), page_size)
            return cls(
                k_pages=torch.zeros(shape, dtype=torch.int8, device=device),
                v_pages=torch.zeros(shape, dtype=torch.int8, device=device),
                page_size=page_size, num_pages=num_pages,
                k_scales=torch.zeros(sshape, dtype=torch.float32, device=device),
                v_scales=torch.zeros(sshape, dtype=torch.float32, device=device),
            )
        return cls(
            k_pages=torch.zeros(shape, dtype=config.dtype, device=device),
            v_pages=torch.zeros(shape, dtype=config.dtype, device=device),
            page_size=page_size, num_pages=num_pages,
        )


def page_hbm_bytes(config: LlamaConfig, page_size: int, kv_quant: str = "") -> int:
    """Device bytes ONE page costs across all layers (K and V, plus the int8
    scale rows), computed without allocating; mirrors ``create``'s shapes."""
    row = config.n_kv_heads * config.head_dim
    itemsize = 1 if kv_quant else config.dtype.itemsize
    per = 2 * config.n_layers * page_size * row * itemsize
    if kv_quant:
        per += 2 * config.n_layers * scale_rows(config.n_kv_heads) * page_size * 4
    return per


class PageAllocationError(RuntimeError):
    pass


class PageAllocator:
    """Host-side free-list allocator with ownership invariants.

    Page 0 is reserved as the trash page and never handed out.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the trash page)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # pop() yields low ids first
        self._owner: dict[int, str] = {}  # page id -> sequence id

    @property
    def used_count(self) -> int:
        return len(self._owner)

    def can_allocate(self, n: int) -> bool:
        return len(self._free) >= n

    def allocate(self, seq_id: str, n: int) -> list[int]:
        if n > len(self._free):
            raise PageAllocationError(
                f"requested {n} pages for {seq_id}, only {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert p not in self._owner, f"invariant violation: page {p} already owned"
            self._owner[p] = seq_id
        METRICS.set_gauge("finchat_kv_pages_used", self.used_count)
        return pages

    def free(self, seq_id: str, pages: list[int]) -> None:
        for p in pages:
            owner = self._owner.get(p)
            if owner is None:
                raise PageAllocationError(f"double free of page {p} by {seq_id}")
            if owner != seq_id:
                raise PageAllocationError(
                    f"sequence {seq_id} freeing page {p} owned by {owner}"
                )
            del self._owner[p]
            self._free.append(p)
        METRICS.set_gauge("finchat_kv_pages_used", self.used_count)

    def owned_by(self, seq_id: str) -> list[int]:
        return [p for p, s in self._owner.items() if s == seq_id]

    def check_invariants(self) -> None:
        """Every page is exactly one of {trash, free, owned-once}."""
        free_set = set(self._free)
        owned_set = set(self._owner)
        assert len(free_set) == len(self._free), "duplicate pages in free list"
        assert not (free_set & owned_set), "page both free and owned"
        assert TRASH_PAGE not in free_set and TRASH_PAGE not in owned_set
        assert free_set | owned_set | {TRASH_PAGE} == set(range(self.num_pages))


def pages_needed(n_tokens: int, page_size: int) -> int:
    return max(1, -(-n_tokens // page_size))


def scatter_kv_chunk(
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*hd] full-depth cache
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, C, Hkv, hd]
    v_new: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32 physical page ids (0 = trash)
    start_pos: torch.Tensor,  # [B] int32 absolute position of chunk token 0
    n_valid: torch.Tensor,  # [B] int32 how many of the C tokens are real
    page_size: int,
    layer: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a chunk of new K/V into one layer's pages, IN PLACE.

    Token (b, i) lands at absolute position ``start_pos[b] + i`` → logical
    page ``pos // page_size``, offset ``pos % page_size``, physical page
    ``page_table[b, logical]``. Padding lanes (i >= n_valid[b]) are
    redirected to the trash page. Returns the same two tensors.
    """
    B, C = k_new.shape[:2]
    hd_fused = k_pages.shape[-1]
    idx = _chunk_rows(page_table, start_pos, n_valid, C, page_size)
    k_pages[layer].index_put_(idx, k_new.reshape(B * C, hd_fused).to(k_pages.dtype))
    v_pages[layer].index_put_(idx, v_new.reshape(B * C, hd_fused).to(v_pages.dtype))
    return k_pages, v_pages


def _chunk_rows(page_table: torch.Tensor, start_pos: torch.Tensor, n_valid: torch.Tensor,
                C: int, page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, row in page) of each of the B x C chunk tokens,
    flattened; padding lanes (i >= n_valid[b]) go to the trash page."""
    i = torch.arange(C, device=page_table.device)[None, :]
    pos = start_pos.long()[:, None] + i  # [B, C]
    logical = (pos // page_size).clamp(max=page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, logical)
    valid = i < n_valid.long()[:, None]
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    return phys.reshape(-1), (pos % page_size).reshape(-1)


def quantize_kv_rows(x: torch.Tensor, n_kv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8 quantization of KV rows ``x [...,
    Hkv*hd]``: returns (int8 rows ``[..., Hkv*hd]``, fp32 scales ``[...,
    Hkv]``) with scale = the head's amax / 127 (1/127 for an all-zero head,
    so dequantization is exact), ``q = clip(round(x / scale), -127, 127)`` —
    a true division, round half to even."""
    lead = x.shape[:-1]
    hd = x.shape[-1] // n_kv
    xh = x.reshape(*lead, n_kv, hd).float()
    amax = xh.abs().amax(dim=-1)  # [..., Hkv]
    scales = symmetric_scale(amax, 127.0)
    q = torch.clamp(torch.round(xh / scales[..., None]), -127, 127).to(torch.int8)
    return q.reshape(*lead, n_kv * hd), scales


def scatter_kv_chunk_q8(
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*hd] int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor,
    k_new: torch.Tensor,  # [B, C, Hkv, hd] float
    v_new: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    start_pos: torch.Tensor,  # [B]
    n_valid: torch.Tensor,  # [B]
    page_size: int,
    layer: int,
    n_kv: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantizing variant of ``scatter_kv_chunk``, IN PLACE: int8 rows into
    the pages, each token's per-head scales into the scale planes (trash
    lanes write the trash page's rows and scales). Returns the four
    tensors."""
    B, C = k_new.shape[:2]
    hd_fused = k_pages.shape[-1]
    phys, offset = _chunk_rows(page_table, start_pos, n_valid, C, page_size)
    k_q, k_s = quantize_kv_rows(k_new.reshape(B * C, hd_fused), n_kv)
    v_q, v_s = quantize_kv_rows(v_new.reshape(B * C, hd_fused), n_kv)
    k_pages[layer].index_put_((phys, offset), k_q)
    v_pages[layer].index_put_((phys, offset), v_q)
    # scale layout is [page, head_row, token]: one indexed write per plane
    heads = torch.arange(n_kv, device=k_pages.device)[None, :]
    sidx = (phys[:, None], heads, offset[:, None])
    k_scales[layer].index_put_(sidx, k_s)
    v_scales[layer].index_put_(sidx, v_s)
    return k_pages, v_pages, k_scales, v_scales


def gather_kv_q8(
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*hd] int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    page_size: int,
    layer: int,
    n_kv: int,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantizing variant of ``gather_kv``: dense ``[B, max_len, Hkv,
    hd]`` in ``dtype``, each value ``float(q8) * scale`` cast to ``dtype``."""
    B, max_pages = page_table.shape
    pt = page_table.long()

    def deq(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        x = pages[layer][pt]  # [B, MP, PS, Hkv*hd] int8
        s = scales[layer][pt]  # [B, MP, SPAD, PS] fp32
        PS = x.shape[2]
        hd = x.shape[-1] // n_kv
        xh = x.reshape(B, max_pages, PS, n_kv, hd).float()
        s_t = s[:, :, :n_kv, :].transpose(2, 3)  # [B, MP, PS, Hkv]
        out = (xh * s_t[..., None]).to(dtype)
        return out.reshape(B, max_pages * PS, n_kv, hd)

    return deq(k_pages, k_scales), deq(v_pages, v_scales)


def gather_kv_any(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor | None,
    v_scales: torch.Tensor | None,
    page_table: torch.Tensor,
    page_size: int,
    layer: int,
    n_kv: int,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``gather_kv`` dispatching on the cache dtype (an int8 cache
    dequantizes to ``dtype``; a float cache is cast to it)."""
    if k_pages.dtype == torch.int8:
        return gather_kv_q8(k_pages, v_pages, k_scales, v_scales, page_table, page_size,
                            layer, n_kv, dtype=dtype)
    k, v = gather_kv(k_pages, v_pages, page_table, page_size, layer, n_kv)
    return k.to(dtype), v.to(dtype)


def gather_kv(
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*hd]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    page_size: int,
    layer: int,
    n_kv: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather one layer's pages for each sequence into a contiguous
    [B, max_len, Hkv, hd] copy (max_len = max_pages * page_size). Plain
    path; the CUDA kernels read pages in place instead."""
    B, max_pages = page_table.shape
    pt = page_table.long()
    k = k_pages[layer][pt]  # [B, max_pages, page_size, Hkv*hd]
    v = v_pages[layer][pt]
    T = max_pages * page_size
    return (k.reshape(B, T, n_kv, k.shape[-1] // n_kv),
            v.reshape(B, T, n_kv, v.shape[-1] // n_kv))
