"""Paged KV cache: device tensors + host-side page allocator (bf16 / fp32).

- Device side: ``k_pages``/``v_pages`` shaped ``[n_layers, num_pages,
  page_size, n_kv_heads * head_dim]`` — token-major pages with the KV heads
  fused into the minor dim, the JAX package's layout, so the kernels and
  the tests see the same tensors on both sides. Physical page 0 is a TRASH
  page: writes from padding lanes and inactive slots are redirected there,
  which keeps every step a fixed-shape write with no host branching. Its
  contents are garbage by design; attention masks by ``kv_len`` and
  causality alone.
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
from finchat_tpu_torch.utils.metrics import METRICS

TRASH_PAGE = 0


@dataclass
class PagedKVCache:
    """Device-side paged cache tensors (the leading layer axis is indexed
    per layer by the attention callbacks and the kernels)."""

    k_pages: torch.Tensor  # [L, P, page_size, Hkv * head_dim]
    v_pages: torch.Tensor
    page_size: int
    num_pages: int

    @classmethod
    def create(cls, config: LlamaConfig, num_pages: int, page_size: int,
               device: torch.device | str) -> "PagedKVCache":
        shape = (config.n_layers, num_pages, page_size,
                 config.n_kv_heads * config.head_dim)
        return cls(
            k_pages=torch.zeros(shape, dtype=config.dtype, device=device),
            v_pages=torch.zeros(shape, dtype=config.dtype, device=device),
            page_size=page_size, num_pages=num_pages,
        )


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
    dev = k_pages.device
    i = torch.arange(C, device=dev)[None, :]
    pos = start_pos.long()[:, None] + i  # [B, C]
    logical = (pos // page_size).clamp(max=page_table.shape[1] - 1)
    offset = pos % page_size
    phys = torch.gather(page_table.long(), 1, logical)
    valid = i < n_valid.long()[:, None]
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    idx = (phys.reshape(-1), offset.reshape(-1))
    k_pages[layer].index_put_(idx, k_new.reshape(B * C, hd_fused).to(k_pages.dtype))
    v_pages[layer].index_put_(idx, v_new.reshape(B * C, hd_fused).to(v_pages.dtype))
    return k_pages, v_pages


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
