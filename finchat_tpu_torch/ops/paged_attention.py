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

``paged_flash_attention_q8`` is the same over an int8 cache with
per-token-per-head scale planes (replacing ``_paged_kernel_q8``): each K/V
value is ``bf16(float(q8) * scale)``. ``paged_attention_q8_ref`` is its
plain version (``gather_kv_q8`` + ``mha_reference``). ``attention_kernel_for``,
a pure function of the call's block shape, picks the kernel:

- ``paged_attention_decode_sm90`` / ``paged_attention_q8_decode_sm90``
  (``csrc/attention_decode_sm90.cu``): every decode call (C == 1, a group
  of at most 16 query heads) over pages of whole 64-key tiles, for both
  caches. An asynchronous ring of K/V tiles, the 4 warps of a block each
  taking 16 keys of every tile, tensor-core products; each sequence's
  pages are split over blocks by ``decode_split``, sized for the card's
  SMs, and the fp32 partials merged in the same launch.
- ``paged_attention_sm90`` (``csrc/attention_bf16_sm90.cu``): bf16 blocks
  of 64 query rows over pages of whole 64-key tiles, no page split — the
  prefill chunks. An asynchronous ring of K/V tiles landing in the layout
  the tensor cores read, ``query_tiles_per_block`` query tiles of 64 rows
  a block sharing each fetched tile.
- ``paged_attention_q8_sm90`` (``csrc/attention_q8_sm90.cu``): int8 blocks
  of 64 query rows over pages of whole 64-key tiles, no page split — the
  prefill chunks. An asynchronous ring of raw int8 tiles, one
  dequantization per tile from shared memory, tensor-core products.
- ``paged_attention`` / ``paged_attention_q8`` (``csrc/paged_attention.cu``,
  one body with a bf16 or an int8 loader): every other call — small row
  groups, pages that are not a multiple of 64 keys, and decode there
  (split by ``decode_splits``).

A ragged round (ops/ragged_paged_attention.py) is routed by
``ragged_kernels_for``: over the bf16 cache at 64-row tiles and pages of
whole 64-key tiles it is two launches — its prefill tiles through the
ragged entry of the bf16 prefill body (``ragged_paged_attention_sm90``),
its one-token rows through the ragged entry of the decode body
(``ragged_paged_attention_decode_sm90``, each row's pages split over
blocks by ``decode_split``); every other ragged call is the one kernel
``attention_kernel_for`` names.

Nothing gives way to anything else: a CUDA tensor reaches the one kernel
the rule names or raises. ``prepare_paged(name, ..., route=False)`` builds
the launch of a named kernel with no routing (``chip_smoke.py`` times both
bodies on the same inputs with it).
"""

from __future__ import annotations

import functools

import torch

from finchat_tpu_torch.engine.kv_cache import gather_kv, gather_kv_q8
from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.kernels import check
from finchat_tpu_torch.ops.refs import mha_reference

MAX_ROWS = 64  # query rows per kernel block: group * tile tokens
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may opt into
DECODE_PAGES_PER_SPLIT = 4  # decode: pages per block before splitting a sequence
SM90_ROWS = 64  # the Hopper prefill bodies (bf16, int8): query rows per tile
SM90_KEYS = 64  # ... and keys per tile (a page holds whole tiles)
SM90_MAX_TILES = 2  # the Hopper bf16 body: query tiles a block (one a warpgroup)
DECODE_KEYS = 64  # the Hopper decode body: keys per tile (a page holds whole tiles)
DECODE_MAX_GROUP = 16  # ... query rows per block (the mma's 16 rows)
# decode_split: blocks per SM the split aims at were every sequence's row
# full — 16, so that calls whose rows are mostly empty (B=64 over 1-4k of 8k;
# the serve's 8 live slots of 64 at 41 of 64 pages) still give ~2 blocks an
# SM with a live key — and the fewest tiles a split takes
DECODE_BLOCKS_PER_SM = 16
DECODE_MIN_TILES = 4
ATTENTION_KINDS = ("paged_attention", "paged_attention_q8", "ragged_paged_attention",
                   "ragged_paged_attention_q8")


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


def decode_splits(C: int, max_pages: int) -> tuple[int, int]:
    """(splits, pages per split) of a paged call: a decode call (C == 1)
    over more than ``DECODE_PAGES_PER_SPLIT`` pages spreads each sequence
    over several blocks whose fp32 partials a second kernel merges; every
    other call walks all its pages in one block."""
    if C == 1 and max_pages > DECODE_PAGES_PER_SPLIT:
        return -(-max_pages // DECODE_PAGES_PER_SPLIT), DECODE_PAGES_PER_SPLIT
    return 1, max_pages


def decode_split(B: int, n_kv: int, max_pages: int, page_size: int, n_sm: int
                 ) -> tuple[int, int]:
    """(splits, pages per split) of a call to the Hopper decode body: the
    pages of a row over the splits that would give ``DECODE_BLOCKS_PER_SM *
    n_sm`` blocks were every sequence's ``max_pages`` pages live, rounded
    up, but never fewer than ``DECODE_MIN_TILES`` key tiles a split (so a
    split's ring has tiles to keep in flight) nor more than ``max_pages``.
    Split s covers pages
    [s * pps, (s + 1) * pps); the splits together cover ``max_pages``. The
    kernel reads ``kv_len`` on the card: blocks past a sequence's last live
    key return at once, and a sequence within one split writes its output
    directly."""
    if min(B, n_kv, max_pages, page_size, n_sm) < 1:
        raise ValueError("decode_split takes positive B, n_kv, max_pages, page_size, n_sm")
    want = -(-DECODE_BLOCKS_PER_SM * n_sm // (B * n_kv))
    min_pages = -(-DECODE_MIN_TILES * DECODE_KEYS // page_size)
    pps = min(max_pages, max(min_pages, -(-max_pages // want)))
    return -(-max_pages // pps), pps


def query_tiles_per_block(B: int, C: int, group: int, n_kv: int, n_sm: int) -> int:
    """Query tiles of 64 rows a block of the Hopper bf16 body takes (one a
    consumer warpgroup, sharing every fetched K/V tile). A block holds the
    whole ring, so one runs per SM: the fewest waves over ``n_sm`` SMs win.
    One tile a block where the call's one-tile blocks (``B * n_kv`` pairs
    of sequence and KV head, ``ceil(C / tile_tokens)`` tiles each) all fit
    in one wave, so each SM takes the least work a block can; else
    ``SM90_MAX_TILES`` (or the chunk's one tile), which halves the waves —
    a lone 512-token chunk among them. Block j of a sequence and KV head
    takes tiles [j * tiles, (j + 1) * tiles) of the chunk's.
    ``tools/attention_bf16_diag.py`` times both choices."""
    if min(B, C, group, n_kv, n_sm) < 1:
        raise ValueError("query_tiles_per_block takes positive B, C, group, n_kv, n_sm")
    n_tiles = -(-C // tile_tokens(group, C))
    return 1 if B * n_kv * n_tiles <= n_sm else min(SM90_MAX_TILES, n_tiles)


def attention_kernel_for(kind: str, rows: int, page_size: int, splits: int, *,
                         decode: bool = False) -> str:
    """The kernel that serves an attention call of ``kind`` (one of
    ``ATTENTION_KINDS``) whose blocks hold ``rows`` query rows (group *
    tile tokens) over pages of ``page_size`` tokens, each sequence's pages
    split over ``splits`` blocks (``decode_splits``); ``decode`` for a paged
    call of one query token per sequence. A paged decode call of at most
    ``DECODE_MAX_GROUP`` rows over pages of whole 64-key tiles goes to the
    Hopper decode body (``kind + "_decode_sm90"``, either cache; it takes
    its own split, ``decode_split``); a paged call (either cache) or an
    int8 ragged call of 64-row blocks over whole 64-key tiles with no split
    to the Hopper prefill bodies (``kind + "_sm90"``: bf16 or int8); every
    other call to ``kind`` — a bf16 ragged round among them, which
    ``ragged_kernels_for`` asks about only where it does not send the round
    to its pair of Hopper entries."""
    if kind not in ATTENTION_KINDS:
        raise ValueError(f"unknown attention kernel kind {kind!r}")
    if (decode and kind.startswith("paged_") and rows <= DECODE_MAX_GROUP
            and page_size % DECODE_KEYS == 0):
        return f"{kind}_decode_sm90"
    if ((kind.endswith("_q8") or kind == "paged_attention") and rows == SM90_ROWS
            and page_size % SM90_KEYS == 0 and splits == 1):
        return f"{kind}_sm90"
    return kind


RAGGED_BF16_PAIR = ("ragged_paged_attention_sm90", "ragged_paged_attention_decode_sm90")


def ragged_kernels_for(kind: str, rows: int, page_size: int, group: int) -> tuple[str, ...]:
    """The kernels that serve a ragged call of ``kind`` (``ragged_paged_attention``
    or ``ragged_paged_attention_q8``), launched in order, whose tiles hold
    ``rows`` query rows (group * tile tokens) over pages of ``page_size``
    tokens. A bf16 round of 64-row tiles over pages of whole 64-key tiles,
    with a group the decode body takes (at most ``DECODE_MAX_GROUP`` rows),
    is ``RAGGED_BF16_PAIR``: the prefill tiles through the bf16 prefill
    body's ragged entry, the rows of one token through the decode body's
    (a row is judged by its length, never by its tiles). Every other call is
    the one kernel ``attention_kernel_for`` names: K3 for the other bf16
    rounds, the Hopper int8 body or the older one for the int8 cache."""
    if (kind == "ragged_paged_attention" and rows == SM90_ROWS
            and page_size % SM90_KEYS == 0 and group <= DECODE_MAX_GROUP):
        return RAGGED_BF16_PAIR
    return (attention_kernel_for(kind, rows, page_size, 1),)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (``decode_split``'s
    ``n_sm``)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_sm90_call(name: str, rows: int, page_size: int, splits: int,
                    tensors: tuple[torch.Tensor, ...]) -> None:
    """Raise unless the Hopper body ``name`` takes this call: the block shape
    ``attention_kernel_for`` sends to it, 16-byte aligned operands."""
    check(attention_kernel_for(name.removesuffix("_sm90"), rows, page_size, splits) == name,
          f"{name} takes 64-row blocks over pages of whole 64-key tiles, no split "
          f"(got {rows} rows, page_size {page_size}, {splits} splits)")
    check(all(t.data_ptr() % 16 == 0 for t in tensors),
          f"{name} takes 16-byte aligned q, pages and scale planes")


def check_decode_call(name: str, C: int, group: int, page_size: int,
                      tensors: tuple[torch.Tensor, ...]) -> None:
    """Raise unless the Hopper decode body ``name`` takes this call: one
    query token a sequence, a group of at most 16 rows, pages of whole
    64-key tiles, 16-byte aligned operands."""
    kind = name.removesuffix("_decode_sm90")
    check(attention_kernel_for(kind, group, page_size, 1, decode=C == 1) == name,
          f"{name} takes one query token a sequence, a group of at most "
          f"{DECODE_MAX_GROUP} rows and pages of whole {DECODE_KEYS}-key tiles "
          f"(got C={C}, group {group}, page_size {page_size})")
    check(all(t.data_ptr() % 16 == 0 for t in tensors),
          f"{name} takes 16-byte aligned q, pages and scale planes")


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
    """Attention over the bf16 paged KV cache by the CUDA kernel
    ``attention_kernel_for`` picks; returns [B, C, H, D]. Raises on a tensor
    it does not take, a CPU one included."""
    check(q.is_cuda, "the paged attention kernel runs on CUDA tensors "
          "(paged_attention_ref is the plain version)")
    return prepare_paged("paged_attention", q, k_pages, v_pages, page_table, q_offset, kv_len,
                         layer, page_size=page_size, n_kv=n_kv, scale=scale).launch()


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
    """Attention over the int8 paged KV cache by the CUDA kernel
    ``attention_kernel_for`` picks; returns [B, C, H, D] bf16. Raises on a
    tensor it does not take, a CPU one included."""
    check(q.is_cuda, "the paged attention kernel runs on CUDA tensors "
          "(paged_attention_q8_ref is the plain version)")
    return prepare_paged("paged_attention_q8", q, k_pages, v_pages, page_table, q_offset,
                         kv_len, layer, page_size=page_size, n_kv=n_kv, k_scales=k_scales,
                         v_scales=v_scales, scale=scale).launch()


def prepare_paged(kind: str, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                  page_table: torch.Tensor, q_offset: torch.Tensor, kv_len: torch.Tensor,
                  layer: int, *, page_size: int, n_kv: int,
                  k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
                  scale: float | None = None, route: bool = True) -> kernels.Prepared:
    """Check a paged attention call and build its launch, without launching:
    the kernel ``attention_kernel_for`` picks for ``kind`` (one of
    ``ATTENTION_KINDS``), or with ``route=False`` the kernel named ``kind``.
    The wrappers launch it once; ``chip_smoke.py`` times the launch alone."""
    check(q.is_cuda, f"the {kind} kernel runs on CUDA tensors")
    names = ("paged_attention", "paged_attention_q8") + (() if route else (
        "paged_attention_sm90", "paged_attention_q8_sm90", "paged_attention_decode_sm90",
        "paged_attention_q8_decode_sm90"))
    check(kind in names, f"{kind} is not a paged attention kernel")
    scales = (k_scales, v_scales) if kind.startswith("paged_attention_q8") else None
    check(scales is None or (k_scales is not None and v_scales is not None),
          f"{kind} reads an int8 cache: give its k_scales and v_scales")
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
    L, P, PS, _ = k_pages.shape
    MP = page_table.shape[1]
    splits, pps = decode_splits(C, MP)
    name = attention_kernel_for(kind, group * bq, PS, splits, decode=C == 1) if route else kind
    if name.endswith("_decode_sm90"):
        check_decode_call(name, C, group, PS, (q, k_pages, v_pages, *(scales or ())))
        splits, pps = decode_split(B, n_kv, MP, PS, sm_count(q.device))
    elif name.endswith("_sm90"):
        check_sm90_call(name, group * bq, PS, splits, (q, k_pages, v_pages, *(scales or ())))
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        # the fp32 partials of the split blocks (scratch, allocated here),
        # merged by a second small kernel
        part_acc = torch.empty((splits, B * C, H, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((splits, B * C, H, 2), dtype=torch.float32, device=q.device)
    cache = [k_pages.data_ptr(), v_pages.data_ptr()]
    dims = [layer, B, C, H, n_kv, D, P, PS]
    if scales is not None:
        cache += [scales[0].data_ptr(), scales[1].data_ptr()]
        dims.append(scales[0].shape[2])
    # the bf16 Hopper body also takes its query tiles a block
    tiles = ((query_tiles_per_block(B, C, group, n_kv, sm_count(q.device)),)
             if name == "paged_attention_sm90" else ())
    args = (q.data_ptr(), *cache,
            out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), page_table.data_ptr(),
            q_offset.data_ptr(), kv_len.data_ptr(),
            *dims, key_tile(PS), MP, bq, splits, pps, *tiles,
            float(scale if scale is not None else D ** -0.5))
    keep = (q, k_pages, v_pages, *(scales or ()), page_table, q_offset, kv_len, part_acc, part_ml)
    return kernels.Prepared(name, args, out, keep)
