"""Ragged paged attention: one dispatch shape for every row of a round.

The batch is a PACKED token buffer ``q [T, H, D]``: each row owns a
contiguous span of tokens and carries its own descriptors —

- ``tok_row [T]``: the row each packed token belongs to (``R`` marks buffer
  padding). Rows are packed in ascending, contiguous order (the engine packs
  them so).
- ``tok_pos [T]``: the token's absolute position in its sequence.
- ``page_table [R, max_pages]``: per-row physical page list (0 = trash).
- ``kv_len [R]``: valid KV length per row INCLUDING this dispatch's tokens.

A 512-token prefill chunk and a 1-token decode row are both rows of the
same buffer. ``kv_gap`` (bounded KV) shifts positions and lengths into
compacted coordinates at the wrapper (``_compact_window``), so the kernel
body is gap-oblivious, as in the JAX package.

``ragged_flash_attention`` launches hand-written kernels (replacing the
TPU kernel ``_ragged_kernel``) on CUDA tensors, over tiles that each belong
to exactly one row, built here with a few torch ops and no host sync;
``ragged_paged_attention_ref`` is their plain version, the JAX reference's
per-token ``gather_kv`` + ``mha_reference`` math. ``ops/dispatch.py`` picks
one by the tensors' device. ``ragged_kernels_for`` (ops/paged_attention.py)
routes: a round of 64-row tiles over pages of whole 64-key tiles is two
launches into one output — its prefill tiles through the ragged entry of
the bf16 prefill body (``ragged_paged_attention_sm90``,
``csrc/attention_bf16_sm90.cu``), its rows of one token through the ragged
entry of the decode body (``ragged_paged_attention_decode_sm90``,
``csrc/attention_decode_sm90.cu``, each row's pages split over blocks); any
other round goes to the older body (``csrc/ragged_paged_attention.cu``).
Padding tokens: the kernels write zeros, the reference (like JAX's)
averages the trash row; nothing reads them.

``plan_ragged`` builds a round's descriptors once (the engine does so per
round, not per layer): the compacted positions and lengths, the tiles, each
row's first token and length. Every wrapper takes one as ``plan``.

``ragged_flash_attention_q8`` is the same over an int8 cache with its
scale planes (replacing ``_ragged_kernel_q8``), dequantizing each K/V tile
as ``bf16(float(q8) * scale)``; the plain version is
``ragged_paged_attention_ref`` given the scale planes. Its tiles hold 64
query rows (Llama-3's group of 4 times 16 tokens), so at a page size of a
multiple of 64 ``attention_kernel_for`` (ops/paged_attention.py) sends it to
the Hopper body ``ragged_paged_attention_q8_sm90``
(``csrc/attention_q8_sm90.cu``), and every other call to
``ragged_paged_attention_q8``. ``prepare_ragged(name, ..., route=False)``
builds the launch of a named kernel with no routing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from finchat_tpu_torch.engine.kv_cache import gather_kv_any
from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.kernels import check
from finchat_tpu_torch.ops.paged_attention import (
    RAGGED_BF16_PAIR,
    check_kernel_shapes,
    check_sm90_call,
    decode_split,
    key_tile,
    query_tiles_per_block,
    ragged_kernels_for,
    sm_count,
    tile_tokens,
)
from finchat_tpu_torch.ops.refs import mha_reference

# bytes of gathered KV the plain version materializes per token chunk
_REF_CHUNK_BYTES = 512 << 20


def _compact_window(tok_row, tok_pos, kv_len, kv_gap, R: int):
    """Bounded-KV coordinate shift: ``kv_gap[r]`` tokens of row ``r`` were
    evicted and its page table walks only the survivors, so masking runs in
    compacted coordinates (positions and lengths shift down by the row's
    gap) while rotary positions upstream stay absolute. ``kv_gap=None`` is
    the identity."""
    if kv_gap is None:
        return tok_pos, kv_len
    gap = kv_gap.to(torch.int32)
    safe = tok_row.long().clamp(max=R - 1)
    # the clamp guards padding tokens (tok_pos 0)
    tok_pos = (tok_pos.to(torch.int32) - gap[safe]).clamp(min=0)
    kv_len = (kv_len.to(torch.int32) - gap).clamp(min=0)
    return tok_pos, kv_len


def ragged_paged_attention_ref(
    q: torch.Tensor,  # [T, H, D] packed query tokens
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [R, max_pages] int32 per-row physical pages
    tok_row: torch.Tensor,  # [T] int32 — owning row per packed token (R = padding)
    tok_pos: torch.Tensor,  # [T] int32 — absolute position per packed token
    kv_len: torch.Tensor,  # [R] int32
    layer: int,
    *,
    page_size: int,
    n_kv: int,
    scale: float | None = None,
    kv_gap: torch.Tensor | None = None,  # [R] int32 — bounded-KV window offset
    k_scales: torch.Tensor | None = None,  # int8 cache: [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: each packed token is one batch element with ``Sq = 1``
    over its row's gathered pages (the JAX reference's math), taken in
    token chunks so the dense copy stays bounded at production shapes. An
    int8 cache (with its scale planes) is dequantized to ``q.dtype`` as it
    is gathered."""
    T = q.shape[0]
    R, MP = page_table.shape
    dev = q.device
    tok_pos, kv_len = _compact_window(tok_row, tok_pos, kv_len, kv_gap, R)
    # row R = an all-trash row with kv_len 0 (the padding-token row)
    pt_pad = torch.cat([page_table.to(torch.int32),
                        torch.zeros((1, MP), dtype=torch.int32, device=dev)])
    kv_pad = torch.cat([kv_len.to(torch.int32), torch.zeros((1,), dtype=torch.int32, device=dev)])
    row = tok_row.long().clamp(max=R)
    # the int8 gather dequantizes through an fp32 copy: budget 4 bytes a value
    val_bytes = 4 if k_pages.dtype == torch.int8 else k_pages.element_size()
    per_token = MP * page_size * k_pages.shape[-1] * val_bytes * 2
    chunk = max(1, _REF_CHUNK_BYTES // per_token)
    outs = []
    for t0 in range(0, T, chunk):
        r = row[t0:t0 + chunk]
        k_all, v_all = gather_kv_any(k_pages, v_pages, k_scales, v_scales, pt_pad[r],
                                     page_size, layer, n_kv, dtype=q.dtype)
        outs.append(mha_reference(
            q[t0:t0 + chunk, None], k_all, v_all, causal=True,
            q_offset=tok_pos[t0:t0 + chunk], kv_len=kv_pad[r], scale=scale,
        )[:, 0])
    return torch.cat(outs)


def ragged_tiles(tok_row: torch.Tensor, R: int, bq: int):
    """Tile descriptors for the kernels, from ``tok_row`` alone and without a
    host sync: ``NT = ceil(T / bq) + R`` tiles (an upper bound on what the
    rows need); tile j covers tokens ``[tile_start, tile_start + tile_len)``
    of row ``tile_row``. Tiles past the rows' own (``tile_row == R``) cover
    the padding suffix, at most ``bq`` tokens each — the bound guarantees
    they reach the end of the buffer. Returns ``(tile_row, tile_start,
    tile_len, NT, q_start, q_len)``, the last two per row: its first packed
    token and its token count (int32)."""
    T = tok_row.shape[0]
    dev = tok_row.device
    row = tok_row.long().clamp(max=R)
    q_len = torch.zeros(R + 1, dtype=torch.long, device=dev)
    q_len.scatter_add_(0, row, torch.ones_like(row))
    q_len = q_len[:R]
    q_start = torch.cumsum(q_len, 0) - q_len  # [R] exclusive
    n_tiles = (q_len + bq - 1) // bq
    cum = torch.cumsum(n_tiles, 0)  # [R] inclusive
    NT = -(-T // bq) + R
    j = torch.arange(NT, device=dev)
    r_of_j = torch.searchsorted(cum, j, right=True)  # R = past every row
    spare = r_of_j >= R
    r_safe = r_of_j.clamp(max=R - 1)
    k = j - (cum[r_safe] - n_tiles[r_safe])
    start = q_start[r_safe] + k * bq
    length = torch.minimum(q_len[r_safe] - k * bq, torch.full_like(k, bq))
    pad_start = q_len.sum() + (j - cum[-1]) * bq
    pad_len = (T - pad_start).clamp(min=0, max=bq)
    tile_row = torch.where(spare, torch.full_like(r_of_j, R), r_of_j)
    tile_start = torch.where(spare, pad_start, start)
    tile_len = torch.where(spare, pad_len, length)
    return (tile_row.to(torch.int32), tile_start.to(torch.int32),
            tile_len.to(torch.int32), NT, q_start.to(torch.int32), q_len.to(torch.int32))


@dataclass(frozen=True)
class RaggedPlan:
    """A round's descriptors, shared by every layer's attention call: the
    positions and lengths in compacted coordinates (``_compact_window``),
    the tiles of ``bq`` tokens (``ragged_tiles``), and each row's first
    packed token and token count."""

    tok_pos: torch.Tensor  # [T] int32
    kv_len: torch.Tensor  # [R] int32
    tile_row: torch.Tensor  # [NT] int32
    tile_start: torch.Tensor
    tile_len: torch.Tensor
    n_tiles: int
    q_start: torch.Tensor  # [R] int32
    q_len: torch.Tensor  # [R] int32
    bq: int


def plan_ragged(tok_row: torch.Tensor, tok_pos: torch.Tensor, kv_len: torch.Tensor, *,
                group: int, kv_gap: torch.Tensor | None = None) -> RaggedPlan:
    """Build a round's descriptors once, on its device, with torch ops and
    no host sync; ``group`` (query heads a KV head) sets the tile tokens."""
    R = kv_len.shape[0]
    bq = tile_tokens(group, 64)
    tok_pos, kv_len = _compact_window(tok_row, tok_pos, kv_len, kv_gap, R)
    tile_row, tile_start, tile_len, NT, q_start, q_len = ragged_tiles(tok_row, R, bq)
    return RaggedPlan(tok_pos.contiguous(), kv_len.contiguous(), tile_row, tile_start, tile_len,
                      NT, q_start, q_len, bq)


def ragged_flash_attention(
    q: torch.Tensor,  # [T, H, D] packed
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [R, max_pages]
    tok_row: torch.Tensor,  # [T]
    tok_pos: torch.Tensor,  # [T]
    kv_len: torch.Tensor,  # [R]
    layer: int,
    *,
    page_size: int,
    n_kv: int,
    scale: float | None = None,
    kv_gap: torch.Tensor | None = None,  # [R] int32 — bounded-KV window offset
    plan: RaggedPlan | None = None,  # the round's descriptors (plan_ragged), if built
) -> torch.Tensor:
    """Ragged paged attention over the bf16 cache by the CUDA kernels
    ``ragged_kernels_for`` picks; returns [T, H, D]. Raises on a tensor it
    does not take, a CPU one included."""
    check(q.is_cuda, "the ragged attention kernel runs on CUDA tensors "
          "(ragged_paged_attention_ref is the plain version)")
    return prepare_ragged("ragged_paged_attention", q, k_pages, v_pages, page_table, tok_row,
                          tok_pos, kv_len, layer, page_size=page_size, n_kv=n_kv, scale=scale,
                          kv_gap=kv_gap, plan=plan).launch()


def ragged_flash_attention_q8(
    q: torch.Tensor,  # [T, H, D] packed
    k_pages: torch.Tensor,  # [L, P, page_size, Hkv*D] int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # [L, P, scale_rows, page_size] fp32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [R, max_pages]
    tok_row: torch.Tensor,  # [T]
    tok_pos: torch.Tensor,  # [T]
    kv_len: torch.Tensor,  # [R]
    layer: int,
    *,
    page_size: int,
    n_kv: int,
    scale: float | None = None,
    kv_gap: torch.Tensor | None = None,  # [R] int32 — bounded-KV window offset
    plan: RaggedPlan | None = None,  # the round's descriptors (plan_ragged), if built
) -> torch.Tensor:
    """Ragged paged attention over the int8 cache by the CUDA kernel
    ``ragged_kernels_for`` picks; returns [T, H, D] bf16. Raises on a
    tensor it does not take, a CPU one included."""
    check(q.is_cuda, "the ragged attention kernel runs on CUDA tensors "
          "(ragged_paged_attention_ref is the plain version)")
    return prepare_ragged("ragged_paged_attention_q8", q, k_pages, v_pages, page_table, tok_row,
                          tok_pos, kv_len, layer, page_size=page_size, n_kv=n_kv, scale=scale,
                          kv_gap=kv_gap, k_scales=k_scales, v_scales=v_scales,
                          plan=plan).launch()


def prepare_ragged(kind: str, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                   page_table: torch.Tensor, tok_row: torch.Tensor, tok_pos: torch.Tensor,
                   kv_len: torch.Tensor, layer: int, *, page_size: int, n_kv: int,
                   scale: float | None = None, kv_gap: torch.Tensor | None = None,
                   k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
                   plan: RaggedPlan | None = None,
                   route: bool = True) -> kernels.Prepared | kernels.PreparedSeq:
    """Check a ragged attention call and build its launches — the
    descriptors included, unless ``plan`` brings the round's — without
    launching: the kernels ``ragged_kernels_for`` picks for ``kind`` (two
    into one output for a bf16 round of 64-row tiles), or with
    ``route=False`` the one kernel named ``kind`` (an entry of the pair
    then writes only its own rows). The wrappers launch it once;
    ``chip_smoke.py`` times the launches alone (the descriptors cost the
    host more than the kernels cost the card at a served round's shapes)."""
    check(q.is_cuda, f"the {kind} kernel runs on CUDA tensors")
    names = ("ragged_paged_attention", "ragged_paged_attention_q8") + (
        () if route else ("ragged_paged_attention_q8_sm90", *RAGGED_BF16_PAIR))
    check(kind in names, f"{kind} is not a ragged attention kernel")
    q8 = kind.startswith("ragged_paged_attention_q8")
    scales = (k_scales, v_scales) if q8 else None
    check(scales is None or (k_scales is not None and v_scales is not None),
          f"{kind} reads an int8 cache: give its k_scales and v_scales")
    T, H, D = q.shape
    R, MP = page_table.shape
    group = H // n_kv
    bq = tile_tokens(group, 64)
    rows = group * bq
    check(q.dtype == torch.bfloat16, "ragged attention kernel takes bf16 q only")
    check_kernel_shapes(H, D, k_pages, v_pages, page_size, n_kv, rows, scales)
    check(page_table.dtype == torch.int32 and tok_row.dtype == torch.int32
          and tok_pos.dtype == torch.int32 and kv_len.dtype == torch.int32,
          "page_table, tok_row, tok_pos, kv_len must be int32")
    check(tok_row.shape == (T,) and tok_pos.shape == (T,) and kv_len.shape == (R,),
          "ragged descriptor shapes disagree with q / page_table")
    for t in (q, k_pages, v_pages, page_table, tok_row, tok_pos, kv_len, *(scales or ())):
        check(t.is_cuda and t.device == q.device and t.is_contiguous(),
              "ragged attention tensors must be contiguous on one CUDA device")
    check(0 <= layer < k_pages.shape[0], f"layer {layer} out of range")
    if route:
        run = ragged_kernels_for(kind, rows, page_size, group)
    else:
        run = (kind,)
        check(kind not in RAGGED_BF16_PAIR
              or ragged_kernels_for("ragged_paged_attention", rows, page_size,
                                    group) == RAGGED_BF16_PAIR,
              f"{kind} takes bf16 rounds of 64-row tiles over pages of whole 64-key tiles, "
              f"a group of at most 16 rows (got {rows} rows, page_size {page_size}, "
              f"group {group})")
    tensors = (q, k_pages, v_pages, *(scales or ()))
    for name in run:
        if name == "ragged_paged_attention_q8_sm90":
            check_sm90_call(name, rows, page_size, 1, tensors)
        elif name in RAGGED_BF16_PAIR:
            check(all(t.data_ptr() % 16 == 0 for t in tensors),
                  f"{name} takes 16-byte aligned q and pages")
    if plan is None:
        plan = plan_ragged(tok_row, tok_pos, kv_len, group=group, kv_gap=kv_gap)
    check(plan.bq == bq and plan.tok_pos.shape == (T,) and plan.kv_len.shape == (R,)
          and plan.tok_pos.device == q.device, "the ragged plan is not this call's")
    out = torch.empty_like(q)
    parts = tuple(_ragged_launch(name, q, k_pages, v_pages, scales, page_table, plan, out, layer,
                                 n_kv, scale) for name in run)
    return parts[0] if len(parts) == 1 else kernels.PreparedSeq(parts)


def _ragged_launch(name: str, q, k_pages, v_pages, scales, page_table, plan: RaggedPlan, out,
                   layer: int, n_kv: int, scale: float | None) -> kernels.Prepared:
    """The C arguments of one ragged kernel's launch over ``plan``."""
    T, H, D = q.shape
    R, MP = page_table.shape
    L, P, PS, _ = k_pages.shape
    sm_scale = float(scale if scale is not None else D ** -0.5)
    keep = (q, k_pages, v_pages, *(scales or ()), page_table, plan, out)
    if name == "ragged_paged_attention_decode_sm90":
        # each one-token row's pages over ``splits`` blocks; the fp32
        # partials (acc, then m and l) in one workspace, merged in the launch
        splits, pps = decode_split(R, n_kv, MP, PS, sm_count(q.device))
        ws = part_acc = part_ml = None
        if splits > 1:
            n = splits * R * H
            ws = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
            part_acc, part_ml = ws.data_ptr(), ws[n * D:].data_ptr()
        args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(), part_acc,
                part_ml, page_table.data_ptr(), plan.tok_pos.data_ptr(), plan.kv_len.data_ptr(),
                plan.q_start.data_ptr(), plan.q_len.data_ptr(),
                layer, T, R, H, n_kv, D, P, PS, MP, splits, pps, sm_scale)
        return kernels.Prepared(name, args, out, keep, ws)
    cache = [k_pages.data_ptr(), v_pages.data_ptr()]
    dims = [layer, T, R, H, n_kv, D, P, PS]
    if scales is not None:
        cache += [scales[0].data_ptr(), scales[1].data_ptr()]
        dims.append(scales[0].shape[2])
    # the bf16 prefill body's entry also reads each row's first token and
    # length (it skips the tiles of one-token rows, which the decode entry
    # takes) and takes the query tiles a block, from the bucket's tiles
    rows = tiles = ()
    if name == "ragged_paged_attention_sm90":
        rows = (plan.q_start.data_ptr(), plan.q_len.data_ptr())
        tiles = (query_tiles_per_block(1, T, H // n_kv, n_kv, sm_count(q.device)),)
    args = (q.data_ptr(), *cache,
            out.data_ptr(), page_table.data_ptr(), plan.tok_pos.data_ptr(),
            plan.kv_len.data_ptr(), plan.tile_row.data_ptr(), plan.tile_start.data_ptr(),
            plan.tile_len.data_ptr(), *rows,
            *dims, key_tile(PS), MP, plan.n_tiles, plan.bq, *tiles, sm_scale)
    return kernels.Prepared(name, args, out, keep)
