"""Paged KV cache: device tensors + host-side page allocator (bf16 / fp32,
or int8 with per-token-per-head scales).

- Device side: ``k_pages``/``v_pages`` shaped ``[n_layers, num_pages,
  page_size, n_kv_heads * head_dim]`` — token-major pages with the KV heads
  fused into the minor dim, the JAX package's layout, so the kernels and
  the tests see the same tensors on both sides (a tensor-parallel rank's
  pool holds its own KV heads, ``config.local_kv_heads``). Physical page 0
  is a TRASH page: writes from padding lanes and inactive slots go there,
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
  ``BoundedKVPolicy`` is the sink + window eviction plan of bounded KV
  serving (host integer math; the scheduler's eviction wave applies it).
- Page snapshots for the session KV cache: ``gather_pages_host`` copies a
  set of pages (all layers, K, V and the int8 scale planes) to CPU tensors
  ``[L, n, ...]``, ``scatter_pages_device`` writes such a snapshot back into
  other pages. The layout is the JAX package's, so a snapshot holds the
  same bytes in both packages.
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
                 config.local_kv_heads * config.head_dim)
        if kv_quant:
            if kv_quant != "int8":
                raise ValueError(f"unknown kv_quant mode {kv_quant!r} (supported: 'int8')")
            sshape = (config.n_layers, num_pages, scale_rows(config.local_kv_heads), page_size)
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
    scale rows), computed without allocating; mirrors ``create``'s shapes
    (a tensor-parallel rank's own slice: its KV heads)."""
    row = config.local_kv_heads * config.head_dim
    itemsize = 1 if kv_quant else config.dtype.itemsize
    per = 2 * config.n_layers * page_size * row * itemsize
    if kv_quant:
        per += 2 * config.n_layers * scale_rows(config.local_kv_heads) * page_size * 4
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
    def free_count(self) -> int:
        return len(self._free)

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

    def reset(self) -> None:
        """Return every page to the free list and drop all ownership: the
        breaker's rebuild path, where the device pool was just replaced and
        nothing the old owners pointed at exists any more. Never valid while
        an owner still expects its pages to hold live KV."""
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._owner.clear()
        METRICS.set_gauge("finchat_kv_pages_used", 0)

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


@dataclass(frozen=True)
class BoundedKVPolicy:
    """Bounded KV serving (the JAX package's ``BoundedKVPolicy``): the first
    ``sink_pages`` pages of a row are pinned (the attention sink) and a
    sliding window of the ``window_pages`` most recent pages survives;
    everything between is evicted back to the page pool as the context
    grows, so a live session holds at most ``sink_pages + window_pages``
    pages whatever its length.

    Eviction is host metadata riding the paged indirection: an evicted page
    leaves the row's logical page list (later pages shift down one logical
    slot, physically nothing moves) and returns to the allocator. The row
    tracks ``kv_gap``, the evicted tokens (a whole number of pages), and
    every KV write and attention mask runs at the compacted position
    ``absolute - kv_gap`` while positions and rotary stay absolute. The
    compacted mask is exact for the surviving set: a new query's position
    is past every evicted one, so ``c_kv <= c_q`` iff ``abs_kv <= abs_q``
    for sink and window tokens alike.

    Every method is host integer math (no device work, no sync): the
    scheduler's eviction wave calls them between dispatches, and the
    free-run staging uses them to cap a capture at the next eviction
    boundary, so a captured round sees the host-stepped gap schedule."""

    sink_pages: int
    window_pages: int
    page_size: int

    @property
    def enabled(self) -> bool:
        return self.sink_pages > 0 and self.window_pages > 0

    @property
    def budget_pages(self) -> int:
        """The most pages a bounded row ever holds (its whole page list)."""
        return self.sink_pages + self.window_pages

    @property
    def sink_tokens(self) -> int:
        return self.sink_pages * self.page_size

    def validate(self, *, prefill_chunk: int, max_pages_per_seq: int,
                 decode_loop_depth: int = 1, spec_tokens: int = 0) -> None:
        """Feasibility at engine construction: the window must always be
        able to make room for the next dispatch's writes by evicting full
        post-sink pages, so a chunk (prefill) or a fused or spec burst
        (decode) plus one partly written tail page must fit."""
        if not self.enabled:
            return
        if self.sink_pages < 1 or self.window_pages < 1:
            raise ValueError(
                "bounded KV needs kv_sink_pages >= 1 and kv_window_pages >= 1 "
                f"(got sink={self.sink_pages}, window={self.window_pages}); "
                "set both to 0 for unbounded serving"
            )
        burst = max(prefill_chunk, 1 + max(decode_loop_depth - 1, spec_tokens))
        need = -(-burst // self.page_size) + 2  # burst + partial tail + slack
        if self.window_pages < need:
            raise ValueError(
                f"kv_window_pages={self.window_pages} cannot hold a "
                f"{burst}-token dispatch burst between eviction waves; "
                f"need >= {need} pages of {self.page_size} tokens "
                "(grow the window or shrink prefill_chunk)"
            )
        if self.budget_pages > max_pages_per_seq:
            raise ValueError(
                f"bounded budget {self.budget_pages} pages exceeds "
                f"max_pages_per_seq={max_pages_per_seq}; grow max_seq_len "
                "or shrink the sink/window"
            )

    def row_pages(self, n_tokens: int) -> int:
        """Pages a bounded row needs for ``n_tokens`` of compacted context:
        the unbounded requirement capped at the budget."""
        return min(pages_needed(n_tokens, self.page_size), self.budget_pages)

    def plan_eviction(self, compacted_ctx: int, incoming: int,
                      capacity_pages: int, pinned_pages: int) -> int:
        """How many whole post-sink pages to evict so the next dispatch's
        ``incoming`` tokens fit the row's ``capacity_pages`` page list.
        ``compacted_ctx`` is the row's compacted written length (absolute
        less ``kv_gap``, tokens still in flight included); ``pinned_pages``
        is the unevictable head (the sink, or a larger shared head pinned
        whole). Returns 0 when everything fits; raises
        ``PageAllocationError`` when not enough full post-sink pages exist.
        A function of the written-token count alone, which the free-run
        capture's equality with the host-stepped loop leans on."""
        need = -(-(compacted_ctx + incoming) // self.page_size)
        e = max(0, need - capacity_pages)
        if e == 0:
            return 0
        # only FULL post-sink pages are evictable (the newest, possibly
        # partial page holds the live tail; pinned head pages never move)
        evictable = max(0, compacted_ctx // self.page_size - pinned_pages)
        if e > evictable:
            raise PageAllocationError(
                f"bounded eviction infeasible: need {e} pages, only "
                f"{evictable} evictable (ctx={compacted_ctx}, "
                f"incoming={incoming}, capacity={capacity_pages}, "
                f"pinned={pinned_pages})"
            )
        return e


def gather_pages_host(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor | None,
    v_scales: torch.Tensor | None,
    page_ids: list[int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Copy a set of physical pages to the host across all layers: returns
    ``(k [L, n, PS, row], v, k_scales | None, v_scales | None)`` as CPU
    tensors of the pool's dtypes (a bf16 pool gives ``torch.bfloat16``).

    The session cache's offload path. The gather runs on the current
    stream, so it is ordered after every step already enqueued that may
    still append into these pages, and the copy to the host is synchronous:
    the caller frees the pages right after, and returning before the copy
    landed would race the next sequence's writes into them. A per-turn
    cost, never on the per-token path. On the CPU the gather is already a
    copy that owns its storage."""
    ids = torch.as_tensor(page_ids, dtype=torch.long).to(k_pages.device)

    def take(pages: torch.Tensor | None) -> torch.Tensor | None:
        return None if pages is None else pages.index_select(1, ids).cpu()

    quantized = k_pages.dtype == torch.int8
    return (take(k_pages), take(v_pages), take(k_scales) if quantized else None,
            take(v_scales) if quantized else None)


def scatter_pages_device(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor | None,
    v_scales: torch.Tensor | None,
    page_ids: list[int],
    host: tuple,
) -> None:
    """Write a host snapshot (``gather_pages_host``'s layout, or a leading
    slice of one) into the pages ``page_ids``, IN PLACE: the first
    ``len(page_ids)`` snapshot pages land in order. The session cache's
    restore path.

    A snapshot of the other page-pool dtype raises: an int8 snapshot cast
    into a bf16 pool (or the reverse) would be plausible-looking garbage
    KV. Callers refuse such snapshots earlier and count them; this is the
    last line."""
    k, v, ks, vs = host
    n = len(page_ids)
    if k.shape[1] < n:
        raise ValueError(f"snapshot holds {k.shape[1]} pages, need {n}")
    if k.dtype != k_pages.dtype:
        raise ValueError(
            f"snapshot dtype {str(k.dtype).removeprefix('torch.')} does not match the "
            f"page-pool dtype {str(k_pages.dtype).removeprefix('torch.')} (cross-mode "
            "restore refused)")
    dev = k_pages.device
    ids = torch.as_tensor(page_ids, dtype=torch.long).to(dev)

    def put(pages: torch.Tensor, snap: torch.Tensor) -> None:
        pages.index_copy_(1, ids, snap[:, :n].to(dev))

    put(k_pages, k)
    put(v_pages, v)
    if k_pages.dtype == torch.int8:
        if ks is None or vs is None:
            raise ValueError("an int8 cache needs the snapshot's scale planes")
        put(k_scales, ks)
        put(v_scales, vs)


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
