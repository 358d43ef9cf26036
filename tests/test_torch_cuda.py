"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and skips
elsewhere. The file imports no JAX, so it runs on the GPU machine as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX). The cases cover every
kernel variant a wrapper can select, at small shapes: the Hopper decode
body (bf16 and int8 caches; contexts of 0, 1, a tile edge and a split edge
plus and minus one, B=64 over 1-4k and one 16k-token sequence; two launches
bit-identical; the older decode body by name beside it), the older body's
decode blocks with page splits (pages of 16), full 64-row tiles on tensor cores (Llama-3's group of 4, and
groups of 2 and 8), the FMA fallback for pages that are not a multiple of
64 keys, small row groups, the Hopper bf16 prefill body (64-row query
tiles, one or two a block, over a cache whose trash page and stale rows
are NaN; Llama-3-8B's 4 x 512 chunk at q_offset 0, 1024 and 2048; two
launches bit-identical; the older body by name beside it), ragged rows with padding and a ``kv_gap`` row,
K3's Hopper pair (``-k ragged_attention_bf16_pair``: a bf16 round's prefill
tiles through the bf16 prefill body's ragged entry and its one-token rows
through the decode body's, over a cache whose trash page and stale rows are
NaN, each case launched twice over an output and a split workspace filled
with NaN and bit-identical, each entry by name, the older body beside it),
and the KV append — each over a bf16 cache and over an int8 cache with its
scale planes — and the KV-row writer (``-k kv_write``: ``kv_write_sm90.cu``,
both entries against the chunk scatter: a decode step of 9 lanes, 3 x 100
chunks over pages of 16 with padding lanes and a lane with no real token,
a packed 64-token round with padding, int8 head rows of 64, 128 and 256
values; K and V with row strides of their own; two launches identical;
the refusals), and the fused dequant matmul's three kernels: v2 by name
(int8, int4 per column and per group of 128, bf16 and fp32 output, 64- and
128-row blocks, ragged M, N and unaligned rows), the Hopper kernel (TMA +
``wgmma``: ragged M, N off the 128-column tile, K off the 64-row tile,
128- and 256-row tiles, int4 per column and per group of 128) and the
decode body (``-k qmm_decode``: split K over a TMA ring, M of 1 to 64,
llama3-8b's layer shapes at M=64, a head-like fp32 N, int4 groups of 8 to
128 and a split ending inside a K tile; each case launched twice over a
workspace and output filled with NaN, bit-identical), with the routing
rule among them, and each of the Hopper entries launched first on a fresh
thread (``-k fresh_thread``) — and contiguous flash attention (K7), forward and
backward (causal and not, ``q_offset``/``kv_len`` with an empty sequence,
GQA groups of 4 and 8, lengths off the 64-row tile; the older forward by
name), and K7's Hopper forward (``-k "flash and sm90"``: the bf16 prefill
body's contiguous entry, routed by ``flash_kernel_for``; out and
log-sum-exp over outputs filled with NaN and K/V whose rows at or past each
kv_len are NaN, a sequence's last box running into the next sequence's NaN
rows, a call smaller than one TMA box, groups of 1 to 8, one and two query
tiles a block, two launches bit-identical, the refusals, and a 2-layer
train step through it), and K7's Hopper backward (``-k "flash and bwd"``:
``flash_attention_bwd_sm90``, routed by ``flash_bwd_kernel_for``, on the
Hopper forward's out and lse over the same calls; dq, dk and dv over
outputs filled with NaN, at the card's SM count and at one SM, two launches
bit-identical, the refusals; the older backward is held by name in the
contiguous cases above).

Tolerance for attention, per output row (one token of one head):
``max|got - want| <= min(2e-2, 2^-6 * max|want|)`` over the row. Both sides
round their output to bf16, one ulp apart at worst (2^-7 of the row's top
binade), and round P to bf16 at different points of the fp32 softmax; 2^-6
is two ulps at the row's own scale, so a dropped key tile or a
mis-weighted split shows at any context length, and 2e-2 caps rows of
large values (a query with a handful of keys) at the former flat limit. The
appends are held bit-exact (a copy; the quantizing one divides and rounds
as its plain version does, IEEE, no fast math). Rows with no key
(``kv_len == 0``, padding tokens) are zeros in the kernels, while the plain
versions keep the reference's average over trash; those rows are checked
for zeros instead.

Tolerance for the dequant matmul: with bf16 output, per output row
``max|got - want| <= 2^-7 * max|want row|`` (both round an fp32 sum of the
same exact products to bf16, one ulp of the row's top binade apart at
worst); with fp32 output, per element ``K * 2^-22 * (|x| @ |w|)``, a bound
on two fp32 summations of K products in any order (each within ``K * 2^-23``
of the exact sum, relative to the sum of magnitudes).

Tolerance for K7's backward against its plain version on the same inputs
(q, k, v, the kernel's out and lse, dout): per tensor
``||got - want|| / ||want|| <= 1e-2`` and per row (one token of one head)
``max|got - want| <= 2^-5 * max(max|want row|, 2^-10 * max|want|)``. The
kernel rounds dS to bf16 (2^-9 relative) before its two products and every
gradient to bf16 once; the plain version keeps dS in fp32. An emulation of
those rounding points on the CPU (tests/test_torch_k7_rounding.py) gives
2.6e-3 per tensor and a quarter of the row limit. The floor is for rows whose gradient vanishes: the first
query of a causal sequence sees one key, so its dS = dP - delta is zero up
to fp32 cancellation (~1e-7 on both sides, in different orders). Rows with
no valid key (``kv_len == 0``) are zeros in the kernel, forward and
backward; the plain forward averages over them, so they are masked.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finchat_tpu_torch.engine.kv_cache import scale_rows  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_ref,
    flash_bwd_kernel_for,
    flash_kernel_for,
    prepare_flash,
    prepare_flash_bwd,
)
from finchat_tpu_torch.models.quant import dequantize, quantize, quantize_int4  # noqa: E402
from finchat_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from finchat_tpu_torch.ops.kv_append import (  # noqa: E402
    paged_kv_append,
    paged_kv_append_q8,
    paged_kv_append_q8_ref,
    paged_kv_append_ref,
    paged_kv_write,
    paged_kv_write_ref,
    plan_kv_rows,
    plan_kv_rows_ragged,
    prepare_kv_write,
)
from finchat_tpu_torch.ops.paged_attention import (  # noqa: E402
    attention_kernel_for,
    decode_split,
    decode_splits,
    paged_attention_q8_ref,
    paged_attention_ref,
    paged_flash_attention,
    paged_flash_attention_q8,
    prepare_paged,
    sm_count,
    tile_tokens,
)
from finchat_tpu_torch.ops.quant_matmul import decode_split as qmm_decode_split  # noqa: E402
from finchat_tpu_torch.ops.quant_matmul import (  # noqa: E402
    kernel_for,
    prepare,
    quant_matmul_int4,
    quant_matmul_int8,
    quant_matmul_ref,
    run_kernel,
)
from finchat_tpu_torch.ops.ragged_paged_attention import (  # noqa: E402
    prepare_ragged,
    ragged_flash_attention,
    ragged_flash_attention_q8,
    ragged_paged_attention_ref,
)

pytestmark = pytest.mark.cuda

REL_TOL = 2.0 ** -6
ATOL = 2e-2
D = 128


def _assert_rows_close(got, want):
    """Each output row within min(ATOL, REL_TOL * its largest reference
    value)."""
    diff = (got.float() - want.float()).abs().amax(-1)
    limit = (REL_TOL * want.float().abs().amax(-1)).clamp(max=ATOL)
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"a row's error is {worst:.3f} x its limit"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cache(dev, n_kv: int, ps: int, n_pages: int, seed: int):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (2, n_pages, ps, n_kv * D)
    return (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16),
            torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16), g)


def _page_table(rng, kv_lens, ps: int, mp: int, n_pages: int, dev):
    ids = rng.permutation(np.arange(1, n_pages))
    pt = np.zeros((len(kv_lens), mp), np.int32)
    nxt = 0
    for b, n in enumerate(kv_lens):
        k = max(1, -(-n // ps))
        pt[b, :k] = ids[nxt:nxt + k]
        nxt += k
    return torch.from_numpy(pt).to(dev)


# (name, H, Hkv, page_size, max_pages, C, q_offsets, kv_lens)
PAGED = [
    ("decode_splits", 8, 2, 128, 8, 1, [9, 300, 0, 1000, 511], [10, 301, 0, 1001, 512]),
    ("decode_ps16", 8, 2, 16, 20, 1, [3, 150, 299], [4, 151, 300]),
    ("prefill_tc_ps64", 8, 2, 64, 6, 40, [0, 70], [40, 110]),
    ("prefill_fma_ps16", 8, 2, 16, 12, 40, [0, 70], [40, 110]),
    ("prefill_tc_group2", 4, 2, 128, 4, 40, [0, 200, 0], [40, 240, 0]),
    ("prefill_tc_group8", 16, 2, 128, 4, 40, [5, 100], [45, 140]),
    ("prefill_small_rows", 8, 2, 128, 4, 3, [0, 77], [3, 80]),
]


@pytest.mark.parametrize("case", PAGED, ids=[c[0] for c in PAGED])
def test_paged_attention_kernel_matches_plain(dev, case):
    _name, H, Hkv, ps, mp, C, q_off, kv_len = case
    rng = np.random.default_rng(0)
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in kv_len)
    kp, vp, g = _cache(dev, Hkv, ps, n_pages, seed=1)
    pt = _page_table(rng, kv_len, ps, mp, n_pages, dev)
    q = torch.randn((len(kv_len), C, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    group = H // Hkv
    name = attention_kernel_for("paged_attention", group * tile_tokens(group, C), ps,
                                decode_splits(C, mp)[0], decode=C == 1)
    before = LAUNCHES[name]
    got = paged_flash_attention(q, kp, vp, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    want = paged_attention_ref(q, kp, vp, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    live = kl > 0
    _assert_rows_close(got[live], want[live])
    assert bool((got[~live] == 0).all())


# rows (q_len, pos0, kv_len), padded length, page_size, per-row kv_gap
RAGGED = [
    ("chunks_decode_padding_tc", [(40, 0, 40), (1, 90, 91), (20, 64, 84), (1, 5, 6)],
     96, 128, None),
    ("fma_ps16", [(40, 0, 40), (1, 90, 91), (20, 64, 84)], 70, 16, None),
    ("gap_row", [(24, 300, 324), (1, 40, 41)], 40, 128, [128, 0]),
]


@pytest.mark.parametrize("case", RAGGED, ids=[c[0] for c in RAGGED])
def test_ragged_attention_kernel_matches_plain(dev, case):
    _name, rows, T, ps, gaps = case
    H, Hkv, mp = 8, 2, 8
    rng = np.random.default_rng(2)
    comp = [kv - (gaps[r] if gaps else 0) for r, (_q, _p, kv) in enumerate(rows)]
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in comp)
    kp, vp, g = _cache(dev, Hkv, ps, n_pages, seed=3)
    pt = _page_table(rng, comp, ps, mp, n_pages, dev)
    tok_row, tok_pos = [], []
    for r, (q_len, p0, _kv) in enumerate(rows):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row += [len(rows)] * (T - n_real)
    tok_pos += [0] * (T - n_real)
    args = (
        torch.randn((T, H, D), generator=g, device=dev, dtype=torch.bfloat16), kp, vp, pt,
        torch.tensor(tok_row, dtype=torch.int32, device=dev),
        torch.tensor(tok_pos, dtype=torch.int32, device=dev),
        torch.tensor([kv for _q, _p, kv in rows], dtype=torch.int32, device=dev), 1,
    )
    kw = dict(page_size=ps, n_kv=Hkv,
              kv_gap=None if gaps is None else torch.tensor(gaps, dtype=torch.int32,
                                                            device=dev))
    got = ragged_flash_attention(*args, **kw)
    want = ragged_paged_attention_ref(*args, **kw)
    _assert_rows_close(got[:n_real], want[:n_real])
    assert bool((got[n_real:] == 0).all())


def test_kv_append_kernel_bit_exact(dev):
    B, ps, Hkv, mp, P = 9, 16, 2, 4, 40
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    kp = torch.randn((3, P, ps, Hkv * D), generator=g, device=dev, dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    pt = torch.arange(1, 1 + B * mp, dtype=torch.int32, device=dev).reshape(B, mp)
    # two invalid lanes at distinct offsets, one with pos past its table row
    pos = torch.tensor([0, 5, 17, 33, 63, 1, 9, 40, 500], dtype=torch.int32, device=dev)
    n_valid = torch.tensor([1, 1, 1, 1, 1, 0, 1, 1, 0], dtype=torch.int32, device=dev)
    kv_new = torch.randn((B, 1, 2 * Hkv * D), generator=g, device=dev, dtype=torch.bfloat16)
    k_ref, v_ref = kp.clone(), vp.clone()
    paged_kv_append(kv_new, kp, vp, pt, pos, n_valid, 2, page_size=ps)
    paged_kv_append_ref(kv_new, k_ref, v_ref, pt, pos, n_valid, 2, page_size=ps)
    assert torch.equal(kp, k_ref) and torch.equal(vp, v_ref)


def test_kernel_wrappers_refuse_what_they_do_not_take(dev):
    kp = torch.zeros((1, 4, 16, 2 * D), dtype=torch.float32, device=dev)
    q = torch.zeros((1, 1, 4, D), dtype=torch.bfloat16, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        paged_flash_attention(q, kp, kp, torch.zeros((1, 2), **i32), torch.zeros(1, **i32),
                              torch.ones(1, **i32), 0, page_size=16, n_kv=2)
    with pytest.raises(ValueError, match="int32"):
        paged_flash_attention(q, kp.bfloat16(), kp.bfloat16(), torch.zeros((1, 2), device=dev,
                              dtype=torch.int64), torch.zeros(1, **i32), torch.ones(1, **i32),
                              0, page_size=16, n_kv=2)


# --- the Hopper bf16 prefill body (csrc/attention_bf16_sm90.cu) -----------------

# (name, H, Hkv, page_size, C, q_offsets, kv_lens): the cases of the CPU
# emulation (tests/test_torch_attn_bf16.py) — q_offset 0 with a partial
# query tile, a 64-key tile edge and +-1, kv_len below q_offset + C and a
# sequence with kv_len 0, at pages of 64 and 128 — then groups of 2 (32
# tokens a tile) and 8 (8 tokens, a thread's two rows in different heads)
# over an odd number of query tiles with a partial last one and padding,
# then Llama-3-8B's serving chunk, 4 x 512 at q_offset 0, 1024 and 2048
PAGED_BF16_SM90 = [
    (f"{name}_ps{ps}", 8, 2, ps, C, q_off, kv_len)
    for name, C, q_off, kv_len in (
        ("q0", 192, [0, 0, 0], [192, 150, 192]),
        ("tile_edges", 64, [63, 64, 65, 0], [127, 128, 129, 64]),
        ("padding_and_empty", 100, [30, 0, 200], [90, 0, 257]))
    for ps in (64, 128)
] + [
    (f"group{H // 2}_ps{ps}", H, 2, ps, 100, [0, 70, 130], [100, 170, 200])
    for H, ps in ((4, 64), (16, 128))
] + [(f"llama3_8b_4x512_q{o}", 32, 8, 128, 512, [o] * 4, [o + 512] * 4) for o in (0, 1024, 2048)]


def _bf16_sm90_call(dev, case, seed: int):
    """A call of PAGED_BF16_SM90 over a cache whose trash page and rows at or
    past each kv_len are NaN (the body must never read them), and the same
    call over a clean copy for the plain version."""
    _name, H, Hkv, ps, C, q_off, kv_len = case
    rng = np.random.default_rng(seed)
    mp = -(-(max(kv_len) + 64) // ps) + 1  # every row's tail is the trash page
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in kv_len)
    kp, vp, g = _cache(dev, Hkv, ps, n_pages, seed=seed)
    pt = _page_table(rng, kv_len, ps, mp, n_pages, dev)
    q = torch.randn((len(kv_len), C, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    kp_bad, vp_bad = kp.clone(), vp.clone()
    for t in (kp_bad, vp_bad):
        t[:, 0] = float("nan")
        for b, n in enumerate(kv_len):
            for p in range(mp):
                lo = n - p * ps
                if int(pt[b, p]) and lo < ps:
                    t[:, int(pt[b, p]), max(lo, 0):] = float("nan")
    kw = dict(page_size=ps, n_kv=Hkv)
    return (q, kp_bad, vp_bad, pt, qo, kl, 1), (q, kp, vp, pt, qo, kl, 1), kw


@pytest.mark.parametrize("n_sm", ["card", "one"])
@pytest.mark.parametrize("case", PAGED_BF16_SM90, ids=[c[0] for c in PAGED_BF16_SM90])
def test_paged_attention_bf16_sm90_matches_plain(dev, case, n_sm, monkeypatch):
    """The routed wrapper launches the Hopper bf16 body once a call; its rows
    match the plain version, rows without keys are zeros, and two launches
    are bit-identical, over a cache whose trash page and stale rows are
    NaN. With ``n_sm`` "one", ``query_tiles_per_block`` sees a card of one
    SM and gives every block two query tiles wherever the chunk has two. The
    older body, launched by name on the same inputs, still matches."""
    import finchat_tpu_torch.ops.paged_attention as pa

    if n_sm == "one":
        monkeypatch.setattr(pa, "sm_count", lambda device: 1)
    args, clean, kw = _bf16_sm90_call(dev, case, seed=41)
    kl = args[5]
    before = dict(LAUNCHES)
    got = paged_flash_attention(*args, **kw)
    again = paged_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    assert moved == {"paged_attention_sm90": 2}
    assert torch.equal(got, again)  # one order of operations: a stale stage shows as a change
    want = paged_attention_ref(*clean, **kw)
    live = kl > 0
    assert bool(torch.isfinite(got.float()).all())
    _assert_rows_close(got[live], want[live])
    assert bool((got[~live] == 0).all())
    old = prepare_paged("paged_attention", *clean, **kw, route=False)
    assert old.name == "paged_attention"
    got_old = old.launch()
    torch.cuda.synchronize()
    _assert_rows_close(got_old[live], want[live])


def test_paged_attention_bf16_sm90_refuses_what_it_does_not_take(dev):
    args, _clean, kw = _bf16_sm90_call(dev, PAGED_BF16_SM90[0], seed=42)
    q = args[0]
    name = "paged_attention_sm90"
    with pytest.raises(ValueError, match="CUDA tensors"):
        prepare_paged(name, q.cpu(), *args[1:], **kw, route=False)
    wide = torch.zeros((*q.shape[:3], 2 * D), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        prepare_paged(name, wide[..., :D], *args[1:], **kw, route=False)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        prepare_paged(name, flat[1:].view(q.shape), *args[1:], **kw, route=False)
    with pytest.raises(ValueError, match="64-row blocks"):  # 8 tokens: 32 rows
        prepare_paged(name, q[:, :8].contiguous(), *args[1:], **kw, route=False)


# --- K3's Hopper route: the bf16 ragged pair ------------------------------------

# rows (q_len, pos0, kv_len) in absolute coordinates, padded length,
# page_size, max_pages, per-row kv_gap, (H, Hkv): prefill rows beside decode
# rows over several key tiles and padding, at pages of 128 and 64; a
# 17-token row (its last tile holds one token) beside decode rows over many
# splits; kv_gap rows; padding rows without tokens and a decode row with
# kv_len 0; groups of 2 and 8; and Llama-3-8B's shape, two 512-token chunks
# and 12 decode rows over 1-4k tokens in a 1,536-token bucket
RAGGED_PAIR = [
    ("mixed_ps128", [(40, 0, 40), (1, 90, 91), (20, 64, 84), (1, 600, 601), (1, 5, 6)],
     96, 128, 8, None, (8, 2)),
    ("mixed_ps64", [(33, 0, 33), (1, 1000, 1001), (50, 150, 200), (1, 63, 64)], 100, 64, 20,
     None, (8, 2)),
    ("row17_splits", [(17, 50, 67), (1, 5000, 5001), (1, 2100, 2101), (16, 300, 316)], 48, 128,
     64, None, (8, 2)),
    ("kv_gap_ps64", [(24, 300, 324), (1, 40, 41), (30, 100, 130), (1, 900, 905)], 64, 64, 20,
     [128, 0, 64, 256], (8, 2)),
    ("padding_rows_kv0", [(20, 10, 30), (0, 0, 0), (1, 0, 0), (1, 90, 91), (0, 0, 0)], 40, 128,
     8, None, (8, 2)),
    ("group2_ps64", [(70, 20, 90), (1, 300, 301), (1, 64, 65)], 96, 64, 8, None, (4, 2)),
    ("group8_ps128", [(30, 0, 30), (1, 200, 201), (9, 120, 129)], 48, 128, 4, None, (16, 2)),
    ("llama3_8b_round", [(512, 0, 512), (512, 1024, 1536)]
     + [(1, n - 1, n) for n in (1, 63, 64, 65, 700, 1000, 1664, 1665, 2500, 3333, 4000, 4096)],
     1536, 128, 64, None, (32, 8)),
]


def _ragged_pair_call(dev, case, seed: int):
    """A round of RAGGED_PAIR over a cache whose trash page and rows at or
    past each row's compacted kv_len are NaN (the entries must never read
    them), and the same round over a clean copy for the plain version and
    the older body."""
    _name, rows, T, ps, mp, gaps, (H, Hkv) = case
    rng = np.random.default_rng(seed)
    comp = [kv - (gaps[r] if gaps else 0) for r, (_q, _p, kv) in enumerate(rows)]
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in comp)
    kp, vp, g = _cache(dev, Hkv, ps, n_pages, seed=seed)
    pt = _page_table(rng, comp, ps, mp, n_pages, dev)
    tok_row, tok_pos = [], []
    for r, (q_len, p0, _kv) in enumerate(rows):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row += [len(rows)] * (T - n_real)
    tok_pos += [0] * (T - n_real)
    q = torch.randn((T, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    desc = (pt, torch.tensor(tok_row, dtype=torch.int32, device=dev),
            torch.tensor(tok_pos, dtype=torch.int32, device=dev),
            torch.tensor([kv for _q, _p, kv in rows], dtype=torch.int32, device=dev), 1)
    kp_bad, vp_bad = kp.clone(), vp.clone()
    for t in (kp_bad, vp_bad):
        t[:, 0] = float("nan")
        for r, n in enumerate(comp):
            for p in range(mp):
                lo = n - p * ps
                if int(pt[r, p]) and lo < ps:
                    t[:, int(pt[r, p]), max(lo, 0):] = float("nan")
    kw = dict(page_size=ps, n_kv=Hkv,
              kv_gap=None if gaps is None else torch.tensor(gaps, dtype=torch.int32,
                                                            device=dev))
    # which packed tokens each entry writes: one-token rows (decode entry),
    # the other rows' tokens (prefill entry), padding (prefill entry's zeros)
    one = [q_len == 1 for q_len, _p, _kv in rows]
    row_of = torch.tensor(tok_row, device=dev)
    real = row_of < len(rows)
    dec = real & torch.tensor(one + [False], device=dev)[row_of.clamp(max=len(rows))]
    live = real & (torch.tensor(comp + [0], device=dev)[row_of] > 0)
    return (q, kp_bad, vp_bad, *desc), (q, kp, vp, *desc), kw, dec, live, real


def _nan_launch(call):
    """Fill the call's output and every workspace with NaN, launch it, and
    return a copy of the output."""
    for part in call.parts:
        part.out.fill_(float("nan"))
        if part.scratch is not None:
            part.scratch.fill_(float("nan"))
    out = call.launch().clone()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("n_sm", ["card", "one"])
@pytest.mark.parametrize("case", RAGGED_PAIR, ids=[c[0] for c in RAGGED_PAIR])
def test_ragged_attention_bf16_pair_matches_plain(dev, case, n_sm, monkeypatch):
    """The routed wrapper launches the two Hopper ragged entries once each
    and nothing else; every real row matches the plain version, rows without
    keys and the padding are zeros, over a cache whose trash page and stale
    rows are NaN; two launches over an output and a split workspace filled
    with NaN are bit-identical; each entry launched by name writes its own
    rows; the older body, launched by name on the same inputs, matches.
    With ``n_sm`` "one", the prefill entry takes two tiles of a row a block
    (``query_tiles_per_block`` on one SM) and the decode entry splits for
    one SM."""
    import finchat_tpu_torch.ops.ragged_paged_attention as rpa

    if n_sm == "one":
        monkeypatch.setattr(rpa, "sm_count", lambda device: 1)
    args, clean, kw, dec, live, real = _ragged_pair_call(dev, case, seed=51)
    before = dict(LAUNCHES)
    got = ragged_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    assert moved == {"ragged_paged_attention_sm90": 1, "ragged_paged_attention_decode_sm90": 1}
    want = ragged_paged_attention_ref(*clean, **kw)
    assert bool(torch.isfinite(got.float()).all())
    _assert_rows_close(got[live], want[live])
    assert bool((got[~live] == 0).all())
    call = prepare_ragged("ragged_paged_attention", *args, **kw)
    assert [p.name for p in call.parts] == ["ragged_paged_attention_sm90",
                                           "ragged_paged_attention_decode_sm90"]
    first, second = _nan_launch(call), _nan_launch(call)
    assert torch.equal(first, second) and torch.equal(first, got)
    for name, mine in (("ragged_paged_attention_sm90", ~dec),
                       ("ragged_paged_attention_decode_sm90", dec & real)):
        alone = _nan_launch(prepare_ragged(name, *args, **kw, route=False))
        assert torch.equal(alone[mine], got[mine]), name
    old = prepare_ragged("ragged_paged_attention", *clean, **kw, route=False)
    assert old.name == "ragged_paged_attention"
    got_old = old.launch()
    torch.cuda.synchronize()
    _assert_rows_close(got_old[live], want[live])


def test_ragged_bf16_pair_refuses_what_it_does_not_take(dev):
    args, _clean, kw, *_ = _ragged_pair_call(dev, RAGGED_PAIR[0], seed=52)
    q = args[0]
    for name in ("ragged_paged_attention_sm90", "ragged_paged_attention_decode_sm90"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            prepare_ragged(name, q.cpu(), *args[1:], **kw, route=False)
        flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=dev)
        with pytest.raises(ValueError, match="16-byte aligned"):
            prepare_ragged(name, flat[1:].view(q.shape), *args[1:], **kw, route=False)
    wide = torch.zeros((*q.shape[:2], 2 * D), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        prepare_ragged("ragged_paged_attention_sm90", wide[..., :D], *args[1:], **kw,
                       route=False)
    # pages of part tiles (16 keys): K3's round, not the pair's
    kp16 = torch.zeros((2, 4, 16, 2 * D), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="64-row tiles"):
        prepare_ragged("ragged_paged_attention_sm90", q, kp16, kp16, *args[3:],
                       page_size=16, n_kv=2, route=False)


# --- the quantized plane -------------------------------------------------------

def _q8_cache(dev, n_kv: int, ps: int, n_pages: int, seed: int):
    """An int8 cache: random rows in [-127, 127] and positive scales."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (2, n_pages, ps, n_kv * D)
    sshape = (2, n_pages, scale_rows(n_kv), ps)
    k = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand(sshape, generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand(sshape, generator=g, device=dev) * 0.02 + 1e-3
    return k, v, ks, vs, g


@pytest.mark.parametrize("case", PAGED, ids=[c[0] for c in PAGED])
def test_paged_attention_q8_kernel_matches_plain(dev, case):
    _name, H, Hkv, ps, mp, C, q_off, kv_len = case
    rng = np.random.default_rng(0)
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in kv_len)
    kp, vp, ks, vs, g = _q8_cache(dev, Hkv, ps, n_pages, seed=5)
    pt = _page_table(rng, kv_len, ps, mp, n_pages, dev)
    q = torch.randn((len(kv_len), C, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    group = H // Hkv
    name = attention_kernel_for("paged_attention_q8", group * tile_tokens(group, C), ps,
                                decode_splits(C, mp)[0], decode=C == 1)
    before = LAUNCHES[name]
    got = paged_flash_attention_q8(q, kp, vp, ks, vs, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    want = paged_attention_q8_ref(q, kp, vp, ks, vs, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    live = kl > 0
    _assert_rows_close(got[live], want[live])
    assert bool((got[~live] == 0).all())


@pytest.mark.parametrize("case", RAGGED, ids=[c[0] for c in RAGGED])
def test_ragged_attention_q8_kernel_matches_plain(dev, case):
    _name, rows, T, ps, gaps = case
    H, Hkv, mp = 8, 2, 8
    rng = np.random.default_rng(2)
    comp = [kv - (gaps[r] if gaps else 0) for r, (_q, _p, kv) in enumerate(rows)]
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in comp)
    kp, vp, ks, vs, g = _q8_cache(dev, Hkv, ps, n_pages, seed=6)
    pt = _page_table(rng, comp, ps, mp, n_pages, dev)
    tok_row, tok_pos = [], []
    for r, (q_len, p0, _kv) in enumerate(rows):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row += [len(rows)] * (T - n_real)
    tok_pos += [0] * (T - n_real)
    q = torch.randn((T, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    desc = (pt, torch.tensor(tok_row, dtype=torch.int32, device=dev),
            torch.tensor(tok_pos, dtype=torch.int32, device=dev),
            torch.tensor([kv for _q, _p, kv in rows], dtype=torch.int32, device=dev), 1)
    kw = dict(page_size=ps, n_kv=Hkv,
              kv_gap=None if gaps is None else torch.tensor(gaps, dtype=torch.int32,
                                                            device=dev))
    got = ragged_flash_attention_q8(q, kp, vp, ks, vs, *desc, **kw)
    want = ragged_paged_attention_ref(q, kp, vp, *desc, k_scales=ks, v_scales=vs, **kw)
    _assert_rows_close(got[:n_real], want[:n_real])
    assert bool((got[n_real:] == 0).all())


# The Hopper body of int8 attention (csrc/attention_q8_sm90.cu): calls of
# 64-row blocks over pages of whole 64-key tiles. (name, H, Hkv, page_size,
# max_pages, C, q_offsets, kv_lens): page sizes 64 and 128, kv_len off the
# 64-key tile and a sequence with kv_len 0, query tiles crossing a page
# boundary, enough key tiles for the 4-stage ring to wrap, groups of 2 and 8
PAGED_SM90 = [
    ("ps64_kv_len_odd_and_empty", 8, 2, 64, 8, 40, [0, 70, 0], [40, 110, 0]),
    ("ps128_tiles_cross_pages", 8, 2, 128, 6, 48, [100, 230], [148, 278]),
    ("ps128_ring_wraps", 8, 2, 128, 8, 64, [500, 900], [564, 964]),
    ("ps64_group2", 4, 2, 64, 8, 64, [0, 200], [64, 264]),
    ("ps128_group8", 16, 2, 128, 4, 24, [5, 100], [29, 124]),
]


@pytest.mark.parametrize("case", PAGED_SM90, ids=[c[0] for c in PAGED_SM90])
def test_paged_attention_q8_sm90_matches_plain(dev, case):
    _name, H, Hkv, ps, mp, C, q_off, kv_len = case
    rng = np.random.default_rng(10)
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in kv_len)
    kp, vp, ks, vs, g = _q8_cache(dev, Hkv, ps, n_pages, seed=11)
    pt = _page_table(rng, kv_len, ps, mp, n_pages, dev)
    q = torch.randn((len(kv_len), C, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    before = dict(LAUNCHES)
    got = paged_flash_attention_q8(q, kp, vp, ks, vs, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    again = paged_flash_attention_q8(q, kp, vp, ks, vs, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_attention_q8_sm90"] == before["paged_attention_q8_sm90"] + 2
    assert LAUNCHES["paged_attention_q8"] == before["paged_attention_q8"]
    # one order of operations: a stale ring stage shows as a change
    assert torch.equal(got, again)
    want = paged_attention_q8_ref(q, kp, vp, ks, vs, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    live = kl > 0
    _assert_rows_close(got[live], want[live])
    assert bool((got[~live] == 0).all())
    # the older body on the same inputs, launched by name, agrees as well
    old = prepare_paged("paged_attention_q8", q, kp, vp, pt, qo, kl, 1, page_size=ps, n_kv=Hkv,
                        k_scales=ks, v_scales=vs, route=False).launch()
    _assert_rows_close(old[live], want[live])


# rows (q_len, pos0, kv_len), padded length, page_size, per-row kv_gap:
# prefill rows, decode rows over several key tiles and padding tokens
RAGGED_SM90 = [
    ("mixed_ps128", [(40, 0, 40), (1, 90, 91), (20, 64, 84), (1, 600, 601), (1, 5, 6)],
     96, 128, None),
    ("mixed_ps64", [(33, 0, 33), (1, 1000, 1001), (50, 150, 200), (1, 63, 64)], 100, 64, None),
    ("mixed_ps64_gap", [(24, 300, 324), (1, 40, 41), (30, 100, 130)], 64, 64, [128, 0, 64]),
]


@pytest.mark.parametrize("case", RAGGED_SM90, ids=[c[0] for c in RAGGED_SM90])
def test_ragged_attention_q8_sm90_matches_plain(dev, case):
    _name, rows, T, ps, gaps = case
    H, Hkv, mp = 8, 2, 20
    rng = np.random.default_rng(12)
    comp = [kv - (gaps[r] if gaps else 0) for r, (_q, _p, kv) in enumerate(rows)]
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in comp)
    kp, vp, ks, vs, g = _q8_cache(dev, Hkv, ps, n_pages, seed=13)
    pt = _page_table(rng, comp, ps, mp, n_pages, dev)
    tok_row, tok_pos = [], []
    for r, (q_len, p0, _kv) in enumerate(rows):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row += [len(rows)] * (T - n_real)
    tok_pos += [0] * (T - n_real)
    q = torch.randn((T, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    desc = (pt, torch.tensor(tok_row, dtype=torch.int32, device=dev),
            torch.tensor(tok_pos, dtype=torch.int32, device=dev),
            torch.tensor([kv for _q, _p, kv in rows], dtype=torch.int32, device=dev), 1)
    kw = dict(page_size=ps, n_kv=Hkv,
              kv_gap=None if gaps is None else torch.tensor(gaps, dtype=torch.int32,
                                                            device=dev))
    before = dict(LAUNCHES)
    got = ragged_flash_attention_q8(q, kp, vp, ks, vs, *desc, **kw)
    again = ragged_flash_attention_q8(q, kp, vp, ks, vs, *desc, **kw)
    torch.cuda.synchronize()
    name = "ragged_paged_attention_q8"
    assert LAUNCHES[f"{name}_sm90"] == before[f"{name}_sm90"] + 2
    assert LAUNCHES[name] == before[name]
    assert torch.equal(got, again)
    want = ragged_paged_attention_ref(q, kp, vp, *desc, k_scales=ks, v_scales=vs, **kw)
    _assert_rows_close(got[:n_real], want[:n_real])
    assert bool((got[n_real:] == 0).all())
    old = prepare_ragged(name, q, kp, vp, *desc, k_scales=ks, v_scales=vs, route=False,
                         **kw).launch()
    _assert_rows_close(old[:n_real], want[:n_real])


# (kind, C or ragged tokens, page_size): int8 calls the older body keeps
Q8_OLD_ROUTES = [("paged_attention_q8", 40, 16), ("paged_attention_q8", 1, 16),
                 ("ragged_paged_attention_q8", 20, 16)]


@pytest.mark.parametrize("case", Q8_OLD_ROUTES, ids=[f"{k}_C{c}_ps{p}"
                                                     for k, c, p in Q8_OLD_ROUTES])
def test_q8_attention_keeps_the_older_body_off_the_hopper_shapes(dev, case):
    kind, C, ps = case
    H, Hkv, mp = 8, 2, 40
    kv_len = [C + 300, C + 7]
    rng = np.random.default_rng(14)
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in kv_len)
    kp, vp, ks, vs, g = _q8_cache(dev, Hkv, ps, n_pages, seed=15)
    pt = _page_table(rng, kv_len, ps, mp, n_pages, dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    before = dict(LAUNCHES)
    if kind == "paged_attention_q8":
        q = torch.randn((2, C, H, D), generator=g, device=dev, dtype=torch.bfloat16)
        qo = kl - C
        got = paged_flash_attention_q8(q, kp, vp, ks, vs, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
        want = paged_attention_q8_ref(q, kp, vp, ks, vs, pt, qo, kl, 1, page_size=ps, n_kv=Hkv)
    else:
        tr = torch.tensor([0] * C + [1] * C, dtype=torch.int32, device=dev)
        tp = torch.cat([torch.arange(n - C, n, device=dev) for n in kv_len]).to(torch.int32)
        q = torch.randn((2 * C, H, D), generator=g, device=dev, dtype=torch.bfloat16)
        got = ragged_flash_attention_q8(q, kp, vp, ks, vs, pt, tr, tp, kl, 1, page_size=ps,
                                        n_kv=Hkv)
        want = ragged_paged_attention_ref(q, kp, vp, pt, tr, tp, kl, 1, page_size=ps, n_kv=Hkv,
                                          k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert LAUNCHES[kind] == before[kind] + 1
    assert LAUNCHES[f"{kind}_sm90"] == before[f"{kind}_sm90"]
    _assert_rows_close(got, want)
    if kind == "paged_attention_q8":
        with pytest.raises(ValueError, match="64-row blocks"):
            prepare_paged(f"{kind}_sm90", q, kp, vp, pt, qo, kl, 1, page_size=ps, n_kv=Hkv,
                          k_scales=ks, v_scales=vs, route=False)


def test_kv_append_q8_kernel_bit_exact(dev):
    """Quantized rows and scales, bit-exact, with invalid lanes (one with
    pos past its table row) and an all-zero head."""
    B, ps, Hkv, mp, P = 9, 16, 2, 4, 40
    kp, vp, ks, vs, g = _q8_cache(dev, Hkv, ps, P, seed=7)
    pt = torch.arange(1, 1 + B * mp, dtype=torch.int32, device=dev).reshape(B, mp)
    pos = torch.tensor([0, 5, 17, 33, 63, 1, 9, 40, 500], dtype=torch.int32, device=dev)
    n_valid = torch.tensor([1, 1, 1, 1, 1, 0, 1, 1, 0], dtype=torch.int32, device=dev)
    kv_new = torch.randn((B, 1, 2 * Hkv * D), generator=g, device=dev, dtype=torch.bfloat16)
    kv_new[2, 0, :D] = 0
    ref = [t.clone() for t in (kp, vp, ks, vs)]
    before = LAUNCHES["kv_append_q8"]
    paged_kv_append_q8(kv_new, kp, vp, ks, vs, pt, pos, n_valid, 1, page_size=ps, n_kv=Hkv)
    torch.cuda.synchronize()
    assert LAUNCHES["kv_append_q8"] == before + 1
    paged_kv_append_q8_ref(kv_new, *ref, pt, pos, n_valid, 1, page_size=ps, n_kv=Hkv)
    for got, want in zip((kp, vp, ks, vs), ref):
        assert torch.equal(got, want)


# (M, K, N, mode, group, out fp32): 64- and 128-row blocks, ragged M and N,
# N = 260 (rows not 16-byte aligned), K not a multiple of the 64-key tile
# --- the KV-row writer (csrc/kv_write_sm90.cu) ----------------------------------

# (name, head_dim, page_size): a decode step of 9 lanes (two invalid at
# distinct offsets, one with pos past its table row), chunks of 3 x 100 over
# pages of 16 (padding lanes, a lane with n_valid 0), a packed round of 64
# tokens with padding tokens, and int8 head rows of 64 and 256 values
KV_WRITE = [("decode_b9", 128, 16), ("chunk_b3x100_ps16", 128, 16), ("round_t64", 128, 16),
            ("chunk_hd64", 64, 16), ("chunk_hd256", 256, 16)]


def _kv_write_call(dev, case: str, hd: int, ps: int, q8: bool, seed: int = 5):
    """(plan, k, v, cache) of a writer case over 2 KV heads: K a slice of a
    wider buffer (row stride 2 * HD), V contiguous, an all-zero K head; the
    cache random (bf16, or int8 with positive scales)."""
    Hkv = 2
    HD = Hkv * hd
    i32 = dict(dtype=torch.int32, device=dev)
    if case == "decode_b9":
        B, mp = 9, 4
        pt = torch.arange(1, 1 + B * mp, **i32).reshape(B, mp)
        plan = plan_kv_rows(pt, torch.tensor([0, 5, 17, 33, 63, 1, 9, 40, 500], **i32),
                            torch.tensor([1, 1, 1, 1, 1, 0, 1, 1, 0], **i32), 1, ps)
    elif case == "round_t64":
        R, mp, T = 8, 8, 64
        tok_row, tok_pos = [], []
        for r, (q_len, p0) in enumerate([(20, 5), (1, 70), (17, 30), (1, 0), (1, 99)]):
            tok_row += [r] * q_len
            tok_pos += list(range(p0, p0 + q_len))
        pad = T - len(tok_row)
        plan = plan_kv_rows_ragged(torch.arange(1, 1 + R * mp, **i32).reshape(R, mp),
                                   torch.tensor(tok_row + [R] * pad, **i32),
                                   torch.tensor(tok_pos + [0] * pad, **i32), ps)
    else:
        B, C, mp = 3, 100, 12
        pt = torch.arange(1, 1 + B * mp, **i32).reshape(B, mp)
        plan = plan_kv_rows(pt, torch.tensor([3, 40, 500], **i32),
                            torch.tensor([100, 70, 0], **i32), C, ps)
    N, P = plan.rows.numel(), int(plan.page_table.max()) + 2
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    wide = torch.randn((N, 2 * HD), generator=g, device=dev, dtype=torch.bfloat16)
    k, v = wide[:, HD:], torch.randn((N, HD), generator=g, device=dev, dtype=torch.bfloat16)
    k[2, :hd] = 0  # an all-zero head: scale 1/127
    shape = (2, P, ps, HD)
    if not q8:
        return plan, k, v, [torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
                            for _ in range(2)] + [None, None]
    sshape = (2, P, scale_rows(Hkv), ps)
    return plan, k, v, (
        [torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
         for _ in range(2)]
        + [torch.rand(sshape, generator=g, device=dev) * 0.02 + 1e-3 for _ in range(2)])


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", KV_WRITE, ids=[c[0] for c in KV_WRITE])
def test_kv_write_sm90_bit_exact(dev, case, q8):
    """Both entries against the chunk scatter on the same inputs: pages and
    scale planes bit-exact (but the trash page where padding lanes share
    its rows: the decode step's invalid lanes do not, so there the whole
    cache), the wrapper launching its entry once, two launches identical."""
    name, hd, ps = case
    plan, k, v, cache = _kv_write_call(dev, name, hd, ps, q8)
    ref = [None if t is None else t.clone() for t in cache]
    again = [None if t is None else t.clone() for t in cache]
    kernel = "kv_append_q8_sm90" if q8 else "kv_append_sm90"

    def planes(c):
        return dict(k_scales=c[2], v_scales=c[3], n_kv=2)

    before = dict(LAUNCHES)
    paged_kv_write(plan.rows, k, v, cache[0], cache[1], 1, **planes(cache))
    prepare_kv_write(plan.rows, k, v, again[0], again[1], 1, **planes(again)).launch()
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] - before[n] for n in LAUNCHES if LAUNCHES[n] != before[n]} == \
        {kernel: 2}
    paged_kv_write_ref(plan, k, v, ref[0], ref[1], 1, **planes(ref))
    live = slice(None) if name == "decode_b9" else slice(1, None)
    for got, second, want in zip(cache, again, ref):
        if got is None:
            continue
        assert torch.equal(got[:, live], want[:, live])
        assert torch.equal(got[:, live], second[:, live])
    assert not torch.equal(cache[0], _kv_write_call(dev, name, hd, ps, q8)[3][0])


def test_kv_write_sm90_refuses_what_it_does_not_take(dev):
    """A CPU tensor, a wrong dtype, a non-contiguous or int64 ``rows`` and
    a cache of neither type are refused with a message naming them, and no
    launch is counted."""
    plan, k, v, (kp, vp, _ks, _vs) = _kv_write_call(dev, "decode_b9", 128, 16, False)
    rows = plan.rows
    before = dict(LAUNCHES)
    for args, match in (((rows, k.cpu(), v, kp, vp), "k is a CPU tensor"),
                        ((rows.cpu(), k, v, kp, vp), "rows is a CPU tensor"),
                        ((rows, k, v.float(), kp, vp), "v must be bf16"),
                        ((torch.stack([rows, rows], 1)[:, 0], k, v, kp, vp),
                         "rows must be a contiguous int32"),
                        ((rows.long(), k, v, kp, vp), "rows must be a contiguous int32"),
                        ((rows, k, v, kp.float(), vp.float()), "bf16 or int8 cache"),
                        ((rows[:4], k, v, kp, vp), r"k must be \[4, 256\]")):
        with pytest.raises(ValueError, match=match):
            paged_kv_write(*args, 1)
    with pytest.raises(ValueError, match="int8 cache needs n_kv"):
        paged_kv_write(rows, k, v, kp.to(torch.int8), vp.to(torch.int8), 1)
    assert LAUNCHES == before


# --- the Hopper decode body (C = 1, csrc/attention_decode_sm90.cu) -------------

def _decode_lens(case: str, B: int, Hkv: int, ps: int, mp: int, dev) -> list[int]:
    """Contexts of a decode case. "edges": 0, 1, a 64-key tile edge and the
    split edge (``decode_split`` on this card) each plus and minus one, and a
    sequence whose page-table tail is the trash page; "b64": 64 sequences
    over 1-4k tokens; "long": one 16k-token sequence."""
    if case == "b64":
        return [int(x) for x in np.random.default_rng(21).integers(1, 4097, 64)]
    if case == "long":
        return [16384]
    span = decode_split(B, Hkv, mp, ps, sm_count(dev))[1] * ps
    lens = [0, 1, 63, 64, 65, span - 1, span, span + 1, 2 * span + 7, 3]
    return lens[:B]


# (name, contexts, page_size, max_pages, H, Hkv)
DECODE_SM90 = [
    ("edges_ps64", "edges", 64, 12, 8, 2),
    ("edges_ps128", "edges", 128, 8, 8, 2),
    ("edges_group8_ps128", "edges", 128, 8, 16, 2),
    ("b64_1to4k", "b64", 128, 32, 32, 8),
    ("one_16k", "long", 128, 128, 32, 8),
]


def _decode_call(dev, case, q8: bool, seed: int):
    _name, lens, ps, mp, H, Hkv = case
    B = 64 if lens == "b64" else (1 if lens == "long" else 10)
    kv_len = _decode_lens(lens, B, Hkv, ps, mp, dev)
    rng = np.random.default_rng(seed)
    n_pages = 2 + sum(max(1, -(-n // ps)) for n in kv_len)
    if q8:
        kp, vp, ks, vs, g = _q8_cache(dev, Hkv, ps, n_pages, seed=seed)
        scales = dict(k_scales=ks, v_scales=vs)
    else:
        kp, vp, g = _cache(dev, Hkv, ps, n_pages, seed=seed)
        scales = {}
    pt = _page_table(rng, kv_len, ps, mp, n_pages, dev)
    q = torch.randn((B, 1, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = (kl - 1).clamp(min=0)
    if B > 3:
        qo[3] = 0  # a query behind its context: the causal bound cuts its keys to one
    return (q, kp, vp, pt, qo, kl, 1), dict(page_size=ps, n_kv=Hkv, **scales)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", DECODE_SM90, ids=[c[0] for c in DECODE_SM90])
def test_paged_attention_decode_sm90_matches_plain(dev, case, q8):
    """The routed wrapper launches the decode body once; its rows match the
    plain version, rows without keys are zeros, and two launches of the same
    call are bit-identical. The older body, launched by name on the same
    inputs, still matches."""
    args, kw = _decode_call(dev, case, q8, seed=31)
    kind = "paged_attention_q8" if q8 else "paged_attention"
    name = f"{kind}_decode_sm90"
    kl = args[5]
    before = dict(LAUNCHES)
    if q8:
        got = paged_flash_attention_q8(*args[:3], kw["k_scales"], kw["v_scales"], *args[3:],
                                       page_size=kw["page_size"], n_kv=kw["n_kv"])
        want = paged_attention_q8_ref(*args[:3], kw["k_scales"], kw["v_scales"], *args[3:],
                                      page_size=kw["page_size"], n_kv=kw["n_kv"])
    else:
        got = paged_flash_attention(*args, **kw)
        want = paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    assert moved == {name: 1}
    live = kl > 0
    _assert_rows_close(got[live], want[live])
    assert bool((got[~live] == 0).all())
    call = prepare_paged(kind, *args, **kw)
    assert call.name == name
    first = call.launch().clone()
    assert torch.equal(first, call.launch())
    assert torch.equal(first, got)
    old = prepare_paged(kind, *args, **kw, route=False).launch()
    torch.cuda.synchronize()
    _assert_rows_close(old[live], want[live])


def test_decode_sm90_wrapper_refuses_what_it_does_not_take(dev):
    args, kw = _decode_call(dev, DECODE_SM90[1], False, seed=32)
    q = args[0]
    for name in ("paged_attention_decode_sm90", "paged_attention_q8_decode_sm90"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            prepare_paged(name, q.cpu(), *args[1:], **kw, route=False)
    wide = torch.zeros((q.shape[0], 1, q.shape[2], 2 * D), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        prepare_paged("paged_attention_decode_sm90", wide[..., :D], *args[1:], **kw,
                      route=False)
    q2 = torch.zeros((q.shape[0], 2, q.shape[2], D), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="one query token"):
        prepare_paged("paged_attention_decode_sm90", q2, *args[1:], **kw, route=False)


QMM = [
    ("int8_decode", 64, 512, 384, "int8", 0, False),
    ("int8_prefill", 300, 256, 260, "int8", 0, False),
    ("int8_head_fp32", 7, 256, 520, "int8", 0, True),
    ("int8_k_edge", 33, 200, 256, "int8", 0, False),
    ("int4_g0", 64, 512, 384, "int4", 0, False),
    ("int4_g128", 130, 512, 260, "int4", 128, False),
    ("int4_g8_fp32", 5, 96, 128, "int4", 8, True),
]


@pytest.mark.parametrize("case", QMM, ids=[c[0] for c in QMM])
def test_quant_matmul_kernel_matches_plain(dev, case):
    _name, M, K, N, mode, group, f32 = case
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    qt = quantize_int4(w, group) if mode == "int4" else quantize(w)
    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    out_dtype = torch.float32 if f32 else None
    name = f"quant_matmul_{mode}"
    before = LAUNCHES[name]
    # v2 by name: the aligned cases of at most 64 rows route to the decode body
    got = run_kernel(name, x, qt.q, qt.scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    want = quant_matmul_ref(x, qt, out_dtype=out_dtype)
    assert got.dtype == want.dtype and got.shape == (M, N)
    diff = (got.float() - want.float()).abs()
    if f32:
        mag = x.float().abs() @ dequantize(qt, torch.bfloat16).float().abs()
        assert bool((diff <= K * 2.0 ** -22 * mag).all())
    else:
        limit = 2.0 ** -7 * want.float().abs().amax(-1, keepdim=True)
        assert bool((diff <= limit).all()), (diff / limit.clamp(min=1e-30)).max().item()


# (M, K, N, mode, group): calls the Hopper kernel serves — ragged M (130,
# 300, and 1084 = 2 x 512 + 60, the ragged round's rows), N a multiple of 16
# but not of the 128-column tile (1040), K a multiple of 8 but not of the
# 64-row tile (200), a K of 64 tiles (the ring wraps 16 times), int4 per
# group of 128, 32 and 8 and per column; 128-row tiles, and 256-row ones where the
# grid fills the card (the two "wide" cases, on 132 SMs)
QMM_SM90 = [
    ("int8_m130", 130, 512, 384, "int8", 0),
    ("int8_m1084_n14336_wide", 1084, 512, 14336, "int8", 0),
    ("int4_g128_m2048_wide", 2048, 256, 14336, "int4", 128),
    ("int8_m300_n1040", 300, 256, 1040, "int8", 0),
    ("int8_m1084", 1084, 512, 256, "int8", 0),
    ("int8_k200", 130, 200, 256, "int8", 0),
    ("int8_m1084_k4096", 1084, 4096, 1024, "int8", 0),
    ("int4_g128", 300, 512, 384, "int4", 128),
    ("int4_g128_m1084_n1040", 1084, 1024, 1040, "int4", 128),
    ("int4_g0_n1040", 130, 256, 1040, "int4", 0),
    # groups of 8 and 32 rows: several scale groups inside one 64-row K tile
    ("int4_g8_m300", 300, 512, 384, "int4", 8),
    ("int4_g32_m1084_n1040", 1084, 1024, 1040, "int4", 32),
]


@pytest.mark.parametrize("case", QMM_SM90, ids=[c[0] for c in QMM_SM90])
def test_quant_matmul_sm90_kernel_matches_plain(dev, case):
    _name, M, K, N, mode, group = case
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    qt = quantize_int4(w, group) if mode == "int4" else quantize(w)
    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    name, v2 = f"quant_matmul_{mode}_sm90", f"quant_matmul_{mode}"
    before, before_v2 = LAUNCHES[name], LAUNCHES[v2]
    fn = quant_matmul_int4 if mode == "int4" else quant_matmul_int8
    got = fn(x, qt.q, qt.scale)
    again = fn(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2 and LAUNCHES[v2] == before_v2
    # one accumulation order: a stale or half-written tile shows as a change
    assert torch.equal(got, again)
    want = quant_matmul_ref(x, qt)
    assert got.dtype == want.dtype and got.shape == (M, N)
    diff = (got.float() - want.float()).abs()
    limit = 2.0 ** -7 * want.float().abs().amax(-1, keepdim=True)
    assert bool((diff <= limit).all()), (diff / limit.clamp(min=1e-30)).max().item()


# (name, M, K, N, mode, group, fp32 out): calls the decode body serves —
# llama3-8b's four layer shapes at M=64 (k/v [4096, 1024] in 32 splits, q/o
# in 8, gate/up in 2, down [14336, 4096] in 8 on 132 SMs), M of 1, 5, 8, 16
# and 33 (x's tile of 8, 16, 32 and 64 rows, rows past M zero), N off the
# 128-column block (1040), K of 4 tiles, a head-like fp32 N of 32,768 at
# M=64 and at the prefill chunk's M=4, fp32 out through the split sum, int4
# per column and per group of 128, 32 and 8 (two groups in a 16-k step),
# and int4 g32 at K = 1,056: the last split ends on a group boundary inside
# its K tile
QMM_DECODE = [
    ("int8_m64_kv", 64, 4096, 1024, "int8", 0, False),
    ("int8_m64_qo", 64, 4096, 4096, "int8", 0, False),
    ("int8_m64_gate_up", 64, 4096, 14336, "int8", 0, False),
    ("int8_m64_down", 64, 14336, 4096, "int8", 0, False),
    ("int8_m1_kv", 1, 4096, 1024, "int8", 0, False),
    ("int8_m5_k256_n1040", 5, 256, 1040, "int8", 0, False),
    ("int8_m8_k14336_n1040", 8, 14336, 1040, "int8", 0, False),
    ("int8_m16_k256_n14336", 16, 256, 14336, "int8", 0, False),
    ("int8_m33_n1040", 33, 4096, 1040, "int8", 0, False),
    ("int8_m64_head_fp32", 64, 4096, 32768, "int8", 0, True),
    ("int8_m4_head_fp32", 4, 4096, 32768, "int8", 0, True),
    ("int8_m33_k14336_n1024_fp32", 33, 14336, 1024, "int8", 0, True),
    ("int4_g0_m64_gate_up", 64, 4096, 14336, "int4", 0, False),
    ("int4_g0_m5_k256_n1040", 5, 256, 1040, "int4", 0, False),
    ("int4_g128_m64_gate_up", 64, 4096, 14336, "int4", 128, False),
    ("int4_g128_m64_down", 64, 14336, 4096, "int4", 128, False),
    ("int4_g128_m1_kv", 1, 4096, 1024, "int4", 128, False),
    ("int4_g128_m16_head_fp32", 16, 4096, 32768, "int4", 128, True),
    ("int4_g32_m33_qo", 33, 4096, 4096, "int4", 32, False),
    ("int4_g32_m8_k1056_n1040", 8, 1056, 1040, "int4", 32, False),
    ("int4_g32_m64_k1056_n1024", 64, 1056, 1024, "int4", 32, False),
    ("int4_g8_m64_k256_n1024", 64, 256, 1024, "int4", 8, False),
    ("int4_g8_m5_n1040_fp32", 5, 4096, 1040, "int4", 8, True),
]


@pytest.mark.parametrize("case", QMM_DECODE, ids=[c[0] for c in QMM_DECODE])
def test_qmm_decode_sm90_matches_plain(dev, case):
    _name, M, K, N, mode, group, f32 = case
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    qt = quantize_int4(w, group) if mode == "int4" else quantize(w)
    del w
    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    out_dtype = torch.float32 if f32 else None
    name = f"quant_matmul_{mode}_decode_sm90"
    assert kernel_for(mode, M, K, N, group or K, f32) == name
    call = prepare(name, x, qt.q, qt.scale, out_dtype=out_dtype)
    splits, _k_split = qmm_decode_split(K, N, group or K, sm_count(dev))
    assert (call.scratch is None) == (splits == 1)
    outs = []
    for _ in range(2):
        # a split never written, or never summed, shows as NaN
        call.out.fill_(float("nan"))
        if call.scratch is not None:
            call.scratch.fill_(float("nan"))
        before = dict(LAUNCHES)
        outs.append(call.launch().clone())
        torch.cuda.synchronize()
        assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} == \
            {name: 1}
    # one accumulation order: a stale or half-summed split shows as a change
    assert torch.equal(outs[0], outs[1])
    before = LAUNCHES[name]
    routed = (quant_matmul_int4 if mode == "int4" else quant_matmul_int8)(
        x, qt.q, qt.scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1 and torch.equal(routed, outs[0])
    got = outs[0]
    want = quant_matmul_ref(x, qt, out_dtype=out_dtype)
    assert got.dtype == want.dtype and got.shape == (M, N)
    diff = (got.float() - want.float()).abs()
    if f32:
        limit = K * 2.0 ** -22 * (x.float().abs() @ dequantize(qt, torch.bfloat16).float().abs())
    else:
        limit = 2.0 ** -7 * want.float().abs().amax(-1, keepdim=True)
    assert bool((diff <= limit).all()), (diff / limit.clamp(min=1e-30)).max().item()


# (M, N, fp32 out, kernel): at most 64 rows go to the decode body, bf16 or
# fp32 out; 65 rows to the Hopper kernel with bf16 out, to v2 with fp32 out;
# weight rows that are not 16-byte multiples to v2 at any row count
QMM_ROUTES = [(64, 256, False, "_decode_sm90"), (130, 256, True, ""), (130, 260, False, ""),
              (65, 256, False, "_sm90"), (64, 256, True, "_decode_sm90"), (64, 260, False, "")]
_QMM_INT8 = ("quant_matmul_int8", "quant_matmul_int8_sm90", "quant_matmul_int8_decode_sm90")


@pytest.mark.parametrize("case", QMM_ROUTES, ids=[f"M{c[0]}_N{c[1]}_f32{int(c[2])}"
                                                  for c in QMM_ROUTES])
def test_quant_matmul_routes_between_the_two_kernels(dev, case):
    M, N, f32, kind = case
    K = 256
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    qt = quantize(torch.randn((K, N), generator=g, device=dev) * K ** -0.5)
    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    before = {k: LAUNCHES[k] for k in _QMM_INT8}
    out_dtype = torch.float32 if f32 else None
    got = quant_matmul_int8(x, qt.q, qt.scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    moved = f"quant_matmul_int8{kind}"
    assert {k: LAUNCHES[k] - before[k] for k in _QMM_INT8} == \
        {k: int(k == moved) for k in _QMM_INT8}
    want = quant_matmul_ref(x, qt, out_dtype=out_dtype)
    limit = (K * 2.0 ** -22 * (x.float().abs() @ dequantize(qt, torch.bfloat16).float().abs())
             if f32 else 2.0 ** -7 * want.float().abs().amax(-1, keepdim=True))
    assert bool(((got.float() - want.float()).abs() <= limit).all())


# each Hopper K8 entry with its weight mode and rows: (kernel, rows, int4 group)
K8_SM90 = [("quant_matmul_int8_sm90", 128, 0), ("quant_matmul_int4_sm90", 128, 64),
           ("quant_matmul_int8_decode_sm90", 16, 0), ("quant_matmul_int4_decode_sm90", 16, 64)]


@pytest.mark.parametrize("case", K8_SM90, ids=[c[0] for c in K8_SM90])
def test_k8_sm90_entry_launches_first_on_a_fresh_thread(dev, case):
    """``cuTensorMapEncodeTiled`` needs the device's context current on
    the calling thread, and a thread that has made no runtime call yet
    (autograd's backward thread) has none: each entry makes its runtime
    call before it encodes its maps. The call is prepared here and
    launched first on a new thread, then held against the plain version
    (a bf16 output row within 2^-7 of its largest value)."""
    name, M, group = case
    K, N = 256, 256
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    qt = quantize_int4(w, group) if "int4" in name else quantize(w)
    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    call = prepare(name, x, qt.q, qt.scale)
    errors = []

    def first_launch():
        try:
            call.launch()
        except RuntimeError as e:
            errors.append(e)

    thread = threading.Thread(target=first_launch)
    thread.start()
    thread.join()
    assert not errors, errors
    torch.cuda.synchronize()
    want = quant_matmul_ref(x, qt)
    limit = 2.0 ** -7 * want.float().abs().amax(-1, keepdim=True)
    assert bool(((call.out.float() - want.float()).abs() <= limit).all())


def test_quantized_wrappers_refuse_what_they_do_not_take(dev):
    qt = quantize(torch.randn((128, 64), device=dev))
    x = torch.zeros((4, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        quant_matmul_int8(x.float(), qt.q, qt.scale)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul_int8(torch.zeros((128, 4), dtype=torch.bfloat16, device=dev).T, qt.q,
                          qt.scale)
    with pytest.raises(ValueError, match="int8"):
        quant_matmul_int4(x, qt.q.float(), qt.scale[None])
    with pytest.raises(ValueError, match="bf16 output"):
        run_kernel("quant_matmul_int8_sm90", x, qt.q, qt.scale, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="1 to 64 rows"):
        run_kernel("quant_matmul_int8_decode_sm90", torch.zeros((65, 128), dtype=torch.bfloat16,
                                                                device=dev), qt.q, qt.scale)
    with pytest.raises(ValueError, match="N % 16 == 0"):
        qt_260 = quantize(torch.randn((128, 260), device=dev))
        run_kernel("quant_matmul_int8_decode_sm90", x, qt_260.q, qt_260.scale)
    kp, vp, ks, vs, _g = _q8_cache(dev, 2, 16, 4, seed=9)
    i32 = dict(dtype=torch.int32, device=dev)
    q = torch.zeros((1, 1, 4, D), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="int8 cache"):
        paged_flash_attention_q8(q, kp.float(), vp.float(), ks, vs, torch.zeros((1, 2), **i32),
                                 torch.zeros(1, **i32), torch.ones(1, **i32), 0, page_size=16,
                                 n_kv=2)
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_attention_q8(q, kp, vp, ks.transpose(2, 3).contiguous().transpose(2, 3), vs,
                                 torch.zeros((1, 2), **i32), torch.zeros(1, **i32),
                                 torch.ones(1, **i32), 0, page_size=16, n_kv=2)
    with pytest.raises(ValueError, match="fp32"):
        paged_kv_append_q8(torch.zeros((1, 1, 4 * D), dtype=torch.bfloat16, device=dev), kp, vp,
                           ks.half(), vs.half(), torch.zeros((1, 2), **i32),
                           torch.zeros(1, **i32), torch.ones(1, **i32), 0, page_size=16,
                           n_kv=2)


# --- contiguous flash attention (K7) ----------------------------------------

# (name, B, Sq, Sk, H, Hkv, causal, q_offsets, kv_lens)
FLASH = [
    ("causal_square_group4", 2, 200, 200, 8, 2, True, None, None),
    ("offset_kv_len_empty_row", 3, 70, 300, 8, 2, True, [0, 100, 230], [70, 170, 0]),
    ("offset_short_kv", 2, 96, 160, 4, 1, True, [64, 40], [160, 100]),
    ("non_causal_mha", 1, 100, 130, 4, 4, False, None, [117]),
    ("causal_group8", 1, 129, 129, 16, 2, True, None, None),
]


def _flash_inputs(dev, case, seed: int):
    _name, B, Sq, Sk, H, Hkv, causal, q_off, kv_len = case
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    q, k, v, dout = rnd(B, Sq, H, D), rnd(B, Sk, Hkv, D), rnd(B, Sk, Hkv, D), rnd(B, Sq, H, D)
    qo = torch.tensor(q_off or [0] * B, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len or [Sk] * B, dtype=torch.int32, device=dev)
    return q, k, v, dout, qo, kl, causal


def _assert_grad_close(got, want):
    """Per tensor relative norm <= 1e-2 and per row <= 2^-5 of the row's
    largest reference value (floored at 2^-10 of the tensor's)."""
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    assert rel <= 1e-2, f"relative error {rel:.3e}"
    diff = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp(min=2.0 ** -10 * want.abs().max().item())
    assert bool((diff <= 2.0 ** -5 * scale).all()), "a row is off"


@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_attention_forward_kernel_matches_plain(dev, case):
    """The older forward, launched by name (the rule sends the causal cases of
    64-row tiles to the Hopper entry, held below)."""
    q, k, v, _dout, qo, kl, causal = _flash_inputs(dev, case, seed=10)
    before = LAUNCHES["flash_attention"]
    out, lse = flash_attention_fwd(q, k, v, qo, kl, causal=causal, scale=D ** -0.5,
                                   kernel="flash_attention")
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want, want_lse = flash_attention_ref(q, k, v, q_offset=qo, kv_len=kl, causal=causal)
    live = kl > 0
    _assert_rows_close(out[live], want[live])
    assert bool((out[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_attention_backward_kernel_matches_plain(dev, case):
    """The older backward, launched by name (the rule sends the causal cases
    of 64-row tiles to the Hopper backward, held below)."""
    q, k, v, dout, qo, kl, causal = _flash_inputs(dev, case, seed=11)
    kw = dict(causal=causal, scale=D ** -0.5)
    out, lse = flash_attention_fwd(q, k, v, qo, kl, **kw)
    before = LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, dout, qo, kl, **kw, kernel="flash_attention_bwd")
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, q_offset=qo, kv_len=kl, **kw)
    for g, w in zip(got, want):
        _assert_grad_close(g, w)
    live = kl > 0
    assert all(bool((g[~live] == 0).all()) for g in got)


def test_flash_attention_autograd_launches_both_kernels(dev):
    """``flash_attention`` is differentiable: backward() runs the routed
    backward kernel after the routed forward (the Hopper forward and
    backward at this causal group of 4), and the gradients equal a direct
    call's."""
    q, k, v, dout, qo, kl, _causal = _flash_inputs(dev, FLASH[0], seed=12)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd = flash_kernel_for(True, q.shape[2] // k.shape[2], D, q.shape[1], True)
    bwd = flash_bwd_kernel_for(True, q.shape[2] // k.shape[2], D, q.shape[1], True)
    assert (fwd, bwd) == ("flash_attention_sm90", "flash_attention_bwd_sm90")
    f0, b0 = LAUNCHES[fwd], LAUNCHES[bwd]
    out = flash_attention(*leaves)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (LAUNCHES[fwd], LAUNCHES[bwd]) == (f0 + 1, b0 + 1)
    _o, lse = flash_attention_fwd(q, k, v, qo, kl, causal=True, scale=D ** -0.5)
    direct = flash_attention_bwd(q, k, v, out.detach(), lse, dout, qo, kl, causal=True,
                                 scale=D ** -0.5)
    for leaf, want in zip(leaves, direct):
        assert torch.equal(leaf.grad, want)


def test_flash_attention_wrapper_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 8, 4, D), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 8, 2, D), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                        k[..., :64].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.cpu(), k.cpu(), k.cpu())


# --- K7's Hopper forward: the bf16 prefill body's contiguous entry ------------

# (name, B, Sq, Sk, H, Hkv, q_offsets, kv_lens): causal calls the rule sends
# to the entry — Sk off the 64-key box, so a sequence's last box runs into
# the next sequence's rows (NaN where that sequence has kv_len 0); a call
# smaller than one 64-row box; kv_len under Sk and q_offset; a partial last
# query tile; groups of 1, 2, 4 and 8; and Llama-3-8B's training shape
FLASH_SM90 = [
    ("spill_into_next_sequence", 3, 100, 100, 8, 2, [0, 0, 0], [100, 0, 77]),
    ("smaller_than_a_box", 1, 16, 16, 8, 2, [0], [16]),
    ("offset_kv_len_empty_row", 3, 70, 300, 8, 2, [0, 100, 230], [70, 170, 0]),
    ("partial_tile_group4", 2, 100, 163, 8, 2, [63, 0], [163, 100]),
    ("mha_group1", 1, 130, 130, 2, 2, [0], [130]),
    ("group2", 2, 96, 96, 4, 2, [0, 0], [96, 50]),
    ("group8", 1, 129, 129, 16, 2, [0], [129]),
    ("llama3_8b_train", 1, 2048, 2048, 32, 8, [0], [2048]),
]


def _flash_sm90_inputs(dev, case, seed: int):
    """A call of FLASH_SM90 with K/V whose rows at or past each kv_len are
    NaN (the entry must never read them into a sum), and the same call over
    clean K/V for the plain version."""
    _name, B, Sq, Sk, H, Hkv, q_off, kv_len = case
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, k, v = (torch.randn((B, S, n, D), generator=g, device=dev, dtype=torch.bfloat16)
               for S, n in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    stale = torch.arange(Sk, device=dev)[None, :] >= kl[:, None]  # [B, Sk]
    k_bad, v_bad = (t.masked_fill(stale[:, :, None, None], float("nan")) for t in (k, v))
    return (q, k_bad, v_bad, qo, kl), (q, k, v, qo, kl)


def _nan_flash_launch(call):
    """Fill the call's output and log-sum-exp with NaN, launch it, and
    return copies of both."""
    call.out.fill_(float("nan"))
    call.aux.fill_(float("nan"))
    out = call.launch().clone()
    torch.cuda.synchronize()
    return out, call.aux.clone()


@pytest.mark.parametrize("n_sm", ["card", "one"])
@pytest.mark.parametrize("case", FLASH_SM90, ids=[c[0] for c in FLASH_SM90])
def test_flash_attention_sm90_matches_plain(dev, case, n_sm, monkeypatch):
    """The routed wrapper launches the Hopper entry once a call; its rows and
    log-sum-exp match the plain version, rows without keys are zeros with
    lse -inf, over K/V whose stale rows are NaN and an output and lse filled
    with NaN; two launches are bit-identical. With ``n_sm`` "one",
    ``query_tiles_per_block`` gives every block two query tiles wherever the
    call has two."""
    import finchat_tpu_torch.ops.flash_attention as fa

    if n_sm == "one":
        monkeypatch.setattr(fa, "sm_count", lambda device: 1)
    args, clean = _flash_sm90_inputs(dev, case, seed=61)
    kl = args[4]
    kw = dict(causal=True, scale=D ** -0.5)
    before = dict(LAUNCHES)
    flash_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    assert moved == {"flash_attention_sm90": 1}
    call = prepare_flash(*args, **kw)
    assert call.name == "flash_attention_sm90"
    (got, lse), (again, lse2) = _nan_flash_launch(call), _nan_flash_launch(call)
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    want, want_lse = flash_attention_ref(*clean[:3], q_offset=clean[3], kv_len=clean[4],
                                         causal=True)
    live = kl > 0
    assert bool(torch.isfinite(got.float()).all())
    _assert_rows_close(got[live], want[live])
    assert bool((got[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-3, rtol=1e-4)


def test_flash_attention_sm90_refuses_what_it_does_not_take(dev):
    """The wrapper refuses a call the rule does not send to the entry; the
    entry itself refuses (cudaErrorInvalidValue) a non-causal call, tiles
    that do not hold 64 rows and a misaligned operand."""
    args, _clean = _flash_sm90_inputs(dev, FLASH_SM90[2], seed=62)
    q, k, v, qo, kl = args
    with pytest.raises(ValueError, match="64 rows"):
        prepare_flash(*args, causal=False, scale=1.0, kernel="flash_attention_sm90")
    with pytest.raises(ValueError, match="64 rows"):  # 8 tokens: 32 rows
        prepare_flash(q[:, :8].contiguous(), k, v, qo, kl, causal=True, scale=1.0,
                      kernel="flash_attention_sm90")
    with pytest.raises(ValueError, match="CUDA"):
        prepare_flash(*(t.cpu() for t in args), causal=True, scale=1.0)
    call = prepare_flash(*args, causal=True, scale=D ** -0.5)
    ptrs, dims, (bq, tiles, scale) = call.args[:7], list(call.args[7:14]), call.args[14:]
    causal_at = 6  # B, Sq, Sk, H, HKV, D, causal
    bad = {"non-causal": (ptrs, dims[:causal_at] + [0], bq, tiles),
           "32-row tiles": (ptrs, dims, bq // 2, tiles),
           "three tiles a block": (ptrs, dims, bq, 3),
           "misaligned q": ((ptrs[0] + 2,) + ptrs[1:], dims, bq, tiles)}
    for label, (p, d, b, t) in bad.items():
        with pytest.raises(RuntimeError, match="cudaError 1"):
            kernels.launch("flash_attention_sm90", *p, *d, b, t, scale)
        torch.cuda.synchronize()


def test_train_step_through_flash_sm90(dev):
    """A 2-layer step at head_dim 128 and a group of 4 through the Hopper
    forward (each layer's forward twice under remat, the older forward never)
    and the Hopper backward (once a layer, the older backward never): the loss and every leaf's gradient against the same
    step with the plain attention (loss within 1e-2, each leaf within 5e-2,
    the limits chip_smoke.py holds the 8B widths to)."""
    from finchat_tpu_torch.models.llama import LlamaConfig, dense_causal_attention, init_params
    from finchat_tpu_torch.train.train_step import named_leaves, value_and_grad

    config = LlamaConfig(vocab_size=260, dim=512, n_layers=2, n_heads=4, n_kv_heads=1,
                         hidden_dim=1024)
    g = torch.Generator(device=dev)
    g.manual_seed(63)
    params = init_params(config, g, dev)
    tokens = torch.randint(0, config.vocab_size, (2, 256), generator=g, device=dev)
    names = ("flash_attention_sm90", "flash_attention", "flash_attention_bwd",
             "flash_attention_bwd_sm90")
    before = [LAUNCHES[n] for n in names]
    loss, grads = value_and_grad(params, tokens, config=config)
    torch.cuda.synchronize()
    assert [LAUNCHES[n] - b for n, b in zip(names, before)] == [4, 0, 0, 2]
    loss_p, grads_p = value_and_grad(params, tokens, config=config,
                                     attention=dense_causal_attention)
    assert abs(loss.item() - loss_p.item()) <= 1e-2
    plain = dict(named_leaves(grads_p))
    for path, got in named_leaves(grads):
        want = plain[path].float()
        rel = ((got.float() - want).norm() / want.norm().clamp(min=1e-30)).item()
        assert rel <= 5e-2, f"{path}: relative {rel:.3e}"


# --- K7's Hopper backward ------------------------------------------------------

BWD_SM90 = "flash_attention_bwd_sm90"


def _nan_bwd_launch(call):
    """Fill the call's dq, dk and dv with NaN, launch it, and return copies
    of the three."""
    grads = (call.out, *call.aux)
    for g in grads:
        g.fill_(float("nan"))
    call.launch()
    torch.cuda.synchronize()
    return tuple(g.clone() for g in grads)


@pytest.mark.parametrize("n_sm", ["card", "one"])
@pytest.mark.parametrize("case", FLASH_SM90, ids=[c[0] for c in FLASH_SM90])
def test_flash_attention_bwd_sm90_matches_plain(dev, case, n_sm, monkeypatch):
    """The routed backward launches the Hopper kernel once a call, on the
    Hopper forward's out and lse over K/V whose rows at or past each kv_len
    are NaN; its dq, dk and dv, over outputs filled with NaN, match the plain
    backward on clean K/V (per tensor and per row, ``_assert_grad_close``),
    a kv_len-0 sequence's are zeros, and two launches are bit-identical. With
    ``n_sm`` "one", the dQ pass takes two query tiles a block wherever the
    call has two."""
    import finchat_tpu_torch.ops.flash_attention as fa

    if n_sm == "one":
        monkeypatch.setattr(fa, "sm_count", lambda device: 1)
    args, clean = _flash_sm90_inputs(dev, case, seed=64)
    q, k, v, qo, kl = args
    g = torch.Generator(device=dev)
    g.manual_seed(65)
    dout = torch.randn(q.shape, generator=g, device=dev, dtype=torch.bfloat16)
    kw = dict(causal=True, scale=D ** -0.5)
    out, lse = flash_attention_fwd(*args, **kw)
    before = dict(LAUNCHES)
    flash_attention_bwd(q, k, v, out, lse, dout, qo, kl, **kw)
    torch.cuda.synchronize()
    moved = {n: LAUNCHES[n] - before[n] for n in LAUNCHES if LAUNCHES[n] != before[n]}
    assert moved == {BWD_SM90: 1}
    call = prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, **kw)
    assert call.name == BWD_SM90
    got, again = _nan_bwd_launch(call), _nan_bwd_launch(call)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_bwd_ref(*clean[:3], out, lse, dout, q_offset=clean[3],
                                   kv_len=clean[4], **kw)
    live = kl > 0
    for grad, w in zip(got, want):
        assert bool(torch.isfinite(grad.float()).all())
        _assert_grad_close(grad[live], w[live])
        assert bool((grad[~live] == 0).all())


def test_flash_attention_bwd_sm90_refuses_what_it_does_not_take(dev):
    """The wrapper refuses a call the rule does not send to the kernel; the
    C entry itself refuses (cudaErrorInvalidValue) a non-causal call, tiles
    that do not hold 64 rows, three dQ tiles a block and a misaligned
    operand."""
    args, _clean = _flash_sm90_inputs(dev, FLASH_SM90[2], seed=66)
    q, k, v, qo, kl = args
    out, lse = flash_attention_fwd(*args, causal=True, scale=D ** -0.5)
    dout = torch.zeros_like(q)
    with pytest.raises(ValueError, match="64 rows"):
        prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, causal=False, scale=1.0,
                          kernel=BWD_SM90)
    q8 = q[:, :8].contiguous()  # 8 tokens: 32 rows
    with pytest.raises(ValueError, match="64 rows"):
        prepare_flash_bwd(q8, k, v, q8, lse[:, :, :8].contiguous(), q8, qo, kl, causal=True,
                          scale=1.0, kernel=BWD_SM90)
    with pytest.raises(ValueError, match="CUDA"):
        prepare_flash_bwd(*(t.cpu() for t in (q, k, v, out, lse, dout, qo, kl)), causal=True,
                          scale=1.0)
    call = prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, causal=True, scale=D ** -0.5)
    ptrs, dims, (bq, tiles, scale) = call.args[:12], list(call.args[12:19]), call.args[19:]
    causal_at = 6  # B, Sq, Sk, H, HKV, D, causal
    bad = {"non-causal": (ptrs, dims[:causal_at] + [0], bq, tiles),
           "32-row tiles": (ptrs, dims, bq // 2, tiles),
           "three tiles a block": (ptrs, dims, bq, 3),
           "misaligned dq": (ptrs[:7] + (ptrs[7] + 2,) + ptrs[8:], dims, bq, tiles)}
    for label, (p, d, b, t) in bad.items():
        with pytest.raises(RuntimeError, match="cudaError 1"):
            kernels.launch(BWD_SM90, *p, *d, b, t, scale)
        torch.cuda.synchronize()
