"""K3's Hopper route on the CPU: a bf16 ragged round as two launches.

A bf16 round of 64-row tiles over pages of whole 64-key tiles runs as the
ragged entry of the bf16 prefill body (``csrc/attention_bf16_sm90.cu``) over
its prefill tiles, then the ragged entry of the decode body
(``csrc/attention_decode_sm90.cu``) over its rows of one token, each row's
pages split over blocks by ``decode_split``. Held here without a card:

- the routing rule (``ragged_kernels_for``) across row counts, page sizes
  and groups, the int8 cache's route unchanged;
- the round's descriptors (``plan_ragged``): what the two entries read of
  them covers every real token exactly once and the padding suffix exactly
  once; a row is judged by its length, never by its tiles (a 17-token
  row's last tile of one token is the prefill entry's); a ``kv_gap`` row
  keeps its compacted positions;
- the partition's arithmetic: a torch emulation at fp32 of both entries —
  one or two tiles of a row a block, each walking the block's keys (cut at
  kv_len and at its last tile's last position) in 128-key tiles of 64-key
  boxes, never a box past those keys nor the trash page, V's rows at or
  past kv_len zeroed; each one-token
  row split by ``decode_split`` into 64-key tiles of 16 keys a warp, the
  warps' and the splits' base-2 partials merged — against the JAX
  ``ragged_flash_attention`` in interpret mode, as the JAX package's own
  tests run it here;
- the engine builds a round's descriptors once, not once a layer, and its
  tokens and logits are what the per-layer descriptors give.

Tolerances: fp32 inputs with P kept in fp32, ``atol=1e-5`` — the same math
as the reference in another order (a line-for-line port of
``mha_reference`` differs by ~4e-7 on such shapes). With P rounded to bf16
before the PV product, as both kernels round it: each probability moves by
at most 2^-9 of itself while the denominator keeps the unrounded sum, so an
output moves by at most 2^-9 * max|v|; held within that plus 1e-5.
``tests/test_torch_cuda.py`` holds the kernels themselves on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from finchat_tpu.ops.ragged_paged_attention import (  # noqa: E402
    ragged_flash_attention as jax_ragged,
)
from finchat_tpu_torch.engine import engine as engine_mod  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import gather_kv  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops import paged_attention as pa  # noqa: E402
from finchat_tpu_torch.ops import ragged_paged_attention as rpa  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402

torch.set_float32_matmul_precision("highest")

N_SM = 132  # an H100 SXM
LOG2E = 1.4426950408889634
PAIR = ("ragged_paged_attention_sm90", "ragged_paged_attention_decode_sm90")


# --- routing -------------------------------------------------------------------

@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("page_size", [16, 64, 128, 96])
def test_bf16_rounds_route_by_tile_rows_page_and_group(group, page_size):
    """The pair takes every group the decode body takes (at most 16 rows) at
    64-row tiles over whole 64-key tiles; a group of 32 and pages of part
    tiles keep K3."""
    rows = group * pa.tile_tokens(group, 64)
    got = pa.ragged_kernels_for("ragged_paged_attention", rows, page_size, group)
    if group <= 16 and page_size % 64 == 0:
        assert rows == 64 and got == PAIR
    else:
        assert got == ("ragged_paged_attention",)


@pytest.mark.parametrize("rows", [4, 16, 63, 64])
@pytest.mark.parametrize("page_size", [16, 64, 128])
def test_int8_rounds_keep_their_route(rows, page_size):
    got = pa.ragged_kernels_for("ragged_paged_attention_q8", rows, page_size, 4)
    want = "ragged_paged_attention_q8_sm90" if rows == 64 and page_size % 64 == 0 else \
        "ragged_paged_attention_q8"
    assert got == (want,) == (pa.attention_kernel_for("ragged_paged_attention_q8", rows,
                                                      page_size, 1),)


def test_both_entries_are_registered():
    for name, src in zip(PAIR, ("attention_bf16_sm90.cu", "attention_decode_sm90.cu")):
        assert name in kernels.KERNELS and name in kernels.LAUNCHES
        assert kernels.KERNELS[name][0] == src
    # the prefill entry: K3's arguments with each row's first token and
    # length after its pointers, and the tiles a block before scale and stream
    old = kernels.KERNELS["ragged_paged_attention"][2]
    assert kernels.KERNELS[PAIR[0]][2] == old[:10] + [kernels._P] * 2 + old[10:-2] + \
        [kernels._I] + old[-2:]


def test_pair_entries_refuse_cpu_tensors_and_other_calls():
    q = torch.zeros((32, 8, 128), dtype=torch.bfloat16)
    kp = torch.zeros((1, 4, 64, 2 * 128), dtype=torch.bfloat16)
    pt = torch.ones((2, 2), dtype=torch.int32)
    tok = torch.zeros(32, dtype=torch.int32)
    kv = torch.ones(2, dtype=torch.int32)
    for name in PAIR:
        with pytest.raises(ValueError, match="CUDA tensors"):
            rpa.prepare_ragged(name, q, kp, kp, pt, tok, tok, kv, 0, page_size=64, n_kv=2,
                               route=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rpa.ragged_flash_attention(q, kp, kp, pt, tok, tok, kv, 0, page_size=64, n_kv=2)


# --- the round's descriptors -------------------------------------------------------

def prefill_blocks(plan: rpa.RaggedPlan, R: int, tiles: int):
    """The prefill entry's blocks, read off the descriptors as the kernel
    reads them: (row, [(first token, tokens) of each tile it takes]) for
    each block with work, and the padding tiles' (first token, tokens). At
    two tiles a block, block j takes tile j and the next descriptor's tile
    if it is of the same row, and returns if tile j is an odd tile of its
    row; tiles of one-token rows return at once."""
    q_len, q_start = plan.q_len.tolist(), plan.q_start.tolist()
    t_row, t_start, t_len = (plan.tile_row.tolist(), plan.tile_start.tolist(),
                             plan.tile_len.tolist())
    blocks, pads = [], []
    for j, (r, s, n) in enumerate(zip(t_row, t_start, t_len)):
        if r >= R:
            pads.append((s, n))
            continue
        if q_len[r] == 1:
            continue
        taken = [(s, n)]
        if tiles == 2:
            if ((s - q_start[r]) // plan.bq) % 2:
                continue
            if j + 1 < len(t_row) and t_row[j + 1] == r:
                taken.append((t_start[j + 1], t_len[j + 1]))
        blocks.append((r, taken))
    return blocks, pads


def _entries(plan: rpa.RaggedPlan, R: int, T: int, tiles: int = 1):
    """What each entry writes: per token, the prefill entry's writes, its
    zeros (padding tiles) and the decode entry's writes (row r of one token
    at q_start[r])."""
    pre, zero, dec = np.zeros(T, int), np.zeros(T, int), np.zeros(T, int)
    blocks, pads = prefill_blocks(plan, R, tiles)
    for _r, taken in blocks:
        for s, n in taken:
            pre[s:s + n] += 1
    for s, n in pads:
        zero[s:s + n] += 1
    for r, (s, n) in enumerate(zip(plan.q_start.tolist(), plan.q_len.tolist())):
        if n == 1:
            dec[s] += 1
    return pre, zero, dec


def _round(lens, T):
    R = len(lens)
    tok_row = np.concatenate([np.repeat(np.arange(R), lens),
                              np.full(T - sum(lens), R)]).astype(np.int32)
    return torch.from_numpy(tok_row), R


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("group", [2, 4, 8])
def test_every_token_is_written_once(group, tiles):
    """Random rounds: each real token by exactly one entry (the decode entry
    for rows of one token, the prefill entry for every other row, at one or
    two tiles a block), each padding token zeroed exactly once."""
    rng = np.random.default_rng(6)
    for _trial in range(30):
        R = int(rng.integers(1, 12))
        lens = [int(x) for x in rng.choice([0, 1, 1, 1, 2, 15, 16, 17, 40, 64], size=R)]
        T = sum(lens) + int(rng.integers(0, 40))
        if T == 0:
            continue
        tok_row, R = _round(lens, T)
        kv = torch.tensor([n + 5 for n in lens], dtype=torch.int32)
        pos = torch.zeros(T, dtype=torch.int32)
        plan = rpa.plan_ragged(tok_row, pos, kv, group=group)
        pre, zero, dec = _entries(plan, R, T, tiles)
        assert np.all(pre + zero + dec == 1)
        row = tok_row.numpy()
        one = np.asarray(lens)[np.minimum(row, R - 1)] == 1
        real = row < R
        assert np.all(dec[real & one] == 1) and np.all(pre[real & ~one] == 1)
        assert np.all(zero[~real] == 1)


def test_a_row_is_judged_by_its_length_not_its_tiles():
    """A 17-token row ends in a one-token tile: the prefill entry's. Rows
    of one token go to the decode entry and to nothing else."""
    lens = [17, 1, 1, 16]
    tok_row, R = _round(lens, 48)
    plan = rpa.plan_ragged(tok_row, torch.arange(48, dtype=torch.int32),
                           torch.tensor([40, 9, 9, 30], dtype=torch.int32), group=4)
    assert plan.bq == 16
    tiles = list(zip(plan.tile_row.tolist(), plan.tile_start.tolist(), plan.tile_len.tolist()))
    assert (0, 16, 1) in tiles  # the 17-token row's last tile holds one token
    for tiles in (1, 2):
        pre, zero, dec = _entries(plan, R, 48, tiles)
        assert pre[16] == 1 and dec[16] == 0
        assert dec[17] == 1 and dec[18] == 1 and pre[17] == 0 and pre[18] == 0
    # at two tiles a block, the 17-token row's block takes both its tiles
    blocks, _pads = prefill_blocks(plan, R, 2)
    assert (0, [(0, 16), (16, 1)]) in blocks
    assert plan.q_start.tolist() == [0, 17, 18, 19] and plan.q_len.tolist() == lens


def test_kv_gap_row_keeps_its_compacted_positions():
    lens = [6, 1, 1]
    tok_row, R = _round(lens, 12)
    pos = torch.tensor([300, 301, 302, 303, 304, 305, 740, 40, 0, 0, 0, 0], dtype=torch.int32)
    kv = torch.tensor([306, 741, 41], dtype=torch.int32)
    gap = torch.tensor([128, 256, 0], dtype=torch.int32)
    plan = rpa.plan_ragged(tok_row, pos, kv, group=4, kv_gap=gap)
    assert plan.tok_pos.tolist()[:8] == [172, 173, 174, 175, 176, 177, 484, 40]
    assert plan.kv_len.tolist() == [178, 485, 41]
    # the decode entry reads each row's position at its first token
    assert [plan.tok_pos[s].item() for s in plan.q_start.tolist()] == [172, 484, 40]


# --- the partition, emulated at fp32 -------------------------------------------------

def _prefill_tile(rows_q, pos, kv, k_row, v_row, pt_row, page_size, c, p_dtype, last):
    """One tile of a prefill entry's block for one KV head: ``rows_q`` [n, D]
    (the tile's tokens x the group), ``pos`` [n] compacted positions,
    ``k_row``/``v_row`` [S, D] the row's gathered keys of this head,
    ``last`` the largest position of the block's tiles."""
    S, D = k_row.shape
    block_keys = min(S, kv, last + 1)
    m = torch.full((rows_q.shape[0],), -1e30)
    l = torch.zeros(rows_q.shape[0])
    acc = torch.zeros(rows_q.shape[0], D)
    nan = torch.tensor(math.nan)
    for t in range(math.ceil(max(block_keys, 0) / 128)):
        k0 = 128 * t
        nb = 1 + (block_keys - k0 > 64)
        for h in range(nb):
            assert int(pt_row[(k0 + 64 * h) // page_size]) != 0, "a trash-page fetch"
        keys = torch.arange(k0, k0 + 128)
        fetched = keys < k0 + 64 * nb
        k_t = torch.full((128, D), math.nan)
        v_t = torch.full((128, D), math.nan)
        n_in = min(128, S - k0)
        k_t[:n_in], v_t[:n_in] = k_row[k0:k0 + n_in], v_row[k0:k0 + n_in]
        k_t = torch.where(fetched[:, None], k_t, nan)
        v_t = torch.where((fetched & (keys < kv))[:, None], v_t, torch.zeros(()))
        s = rows_q @ k_t.T
        ok = (keys[None, :] < kv) & (keys[None, :] <= pos[:, None])
        s = torch.where(ok, s, torch.tensor(-math.inf))
        mn = torch.maximum(m, s.max(-1).values)
        corr = torch.exp2((m - mn) * c)
        p = torch.exp2(s * c - (mn * c)[:, None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[:, None] + p.to(p_dtype).float() @ v_t
        m = mn
    return acc / l.clamp(min=1e-30)[:, None]


def _decode_row(q_row, pos, kv, k_row, v_row, *, span, max_keys, c, p_dtype):
    """The decode entry's blocks of one row: ``q_row`` [H, D]; ``k_row``/
    ``v_row`` [S, Hkv, D]. Splits of ``span`` keys, 64-key tiles, warp w
    keys [16w, 16w + 16) of each with its own base-2 online softmax, the
    warps merged, then the live splits."""
    H, D = q_row.shape
    group = H // k_row.shape[1]
    keys = max(0, min(kv, pos + 1, max_keys))
    k_h = k_row.repeat_interleave(group, dim=1)
    v_h = v_row.repeat_interleave(group, dim=1)
    parts = []
    for s in range(max(1, -(-keys // span))):
        lo, hi = s * span, min(keys, (s + 1) * span)
        warps = []
        for w in range(4):
            m, l, acc = torch.full((H,), -1e30), torch.zeros(H), torch.zeros(H, D)
            for k0 in range(lo, hi, 64):
                first, end = k0 + 16 * w, min(k0 + 16 * w + 16, hi)
                if first >= end:
                    continue
                idx = torch.arange(first, end)
                sc = torch.einsum("hd,nhd->hn", q_row, k_h[idx]) * c
                mn = torch.maximum(m, sc.max(-1).values)
                corr = torch.exp2(m - mn)
                p = torch.exp2(sc - mn[:, None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + torch.einsum("hn,nhd->hd", p.to(p_dtype).float(),
                                                         v_h[idx])
                m = mn
            warps.append((m, l, acc))
        m_star = torch.stack([x[0] for x in warps]).max(0).values
        f = [torch.exp2(x[0] - m_star) for x in warps]
        parts.append((m_star, sum(x[1] * fw for x, fw in zip(warps, f)),
                      sum(x[2] * fw[:, None] for x, fw in zip(warps, f))))
    m_star = torch.stack([x[0] for x in parts]).max(0).values
    f = [torch.exp2(x[0] - m_star) for x in parts]
    l_tot = sum(x[1] * fs for x, fs in zip(parts, f))
    a_tot = sum(x[2] * fs[:, None] for x, fs in zip(parts, f))
    return a_tot / l_tot.clamp(min=1e-30)[:, None]


def emulate_pair(q, k_all, v_all, pt, plan: rpa.RaggedPlan, *, page_size: int, n_sm: int,
                 scale: float, p_dtype, tiles: int = 1):
    """Both entries of the pair over one round, at fp32: ``q`` [T, H, D];
    ``k_all``/``v_all`` [R, max_pages * page_size, Hkv, D] (each row's
    gathered pages, compacted coordinates); the prefill entry at ``tiles``
    tiles a block, each tile walking the keys of the block's last. Every
    token starts as NaN, so one no entry writes shows."""
    T, H, D = q.shape
    R, S, n_kv, _ = k_all.shape
    group = H // n_kv
    c = scale * LOG2E
    out = torch.full_like(q, math.nan)
    q_len, q_start = plan.q_len.tolist(), plan.q_start.tolist()
    kv_len, tok_pos = plan.kv_len.tolist(), plan.tok_pos
    blocks, pads = prefill_blocks(plan, R, tiles)
    for s, n in pads:
        out[s:s + n] = 0.0
    for r, taken in blocks:
        last = int(tok_pos[taken[-1][0] + taken[-1][1] - 1])
        for s, n in taken:
            for g in range(n_kv):
                # the tile's 64 rows: token i of the tile, head g * group + j
                rows_q = q[s:s + n, g * group:(g + 1) * group].reshape(-1, D)
                pos = tok_pos[s:s + n].repeat_interleave(group)
                o = _prefill_tile(rows_q, pos, kv_len[r], k_all[r, :, g], v_all[r, :, g], pt[r],
                                  page_size, c, p_dtype, last)
                out[s:s + n, g * group:(g + 1) * group] = o.reshape(n, group, D)
    mp = pt.shape[1]
    _splits, pps = pa.decode_split(R, n_kv, mp, page_size, n_sm)
    for r in range(R):
        if q_len[r] != 1:
            continue
        t = q_start[r]
        out[t] = _decode_row(q[t], int(tok_pos[t]), kv_len[r], k_all[r], v_all[r],
                             span=pps * page_size, max_keys=mp * page_size, c=c,
                             p_dtype=p_dtype)
    return out


# rows (q_len, pos0, kv_len) in absolute coordinates, padded length, per-row
# kv_gap: the timed round cut to a few rows (two chunks, decode rows over
# several tiles, padding), a 17-token row beside rows spanning several
# splits, kv_gap rows (chunk and decode), padding rows (no tokens) and a
# decode row with kv_len 0
CASES = [
    ("timed_round_cut", [(40, 0, 40), (40, 100, 140), (1, 300, 301), (1, 1000, 1001),
                         (1, 63, 64)], 96, None),
    ("row17_and_splits", [(17, 50, 67), (1, 1200, 1201), (1, 5, 6), (1, 700, 701)], 24, None),
    ("kv_gap_rows", [(24, 300, 324), (1, 740, 741), (1, 40, 41)], 32, [128, 256, 0]),
    ("padding_and_empty", [(20, 10, 30), (0, 0, 0), (1, 0, 0), (1, 90, 91), (0, 0, 0)], 40,
     None),
]


def _inputs(case, page_size: int, rng):
    _name, rows, T, gaps = case
    H, n_kv, D = 8, 2, 128
    comp = [kv - (gaps[r] if gaps else 0) for r, (_q, _p, kv) in enumerate(rows)]
    mp = math.ceil((max(comp) + 64) / page_size) + 1  # a trash-page tail on every row
    n_pages = len(rows) * mp + 1
    pt = np.zeros((len(rows), mp), np.int32)
    ids = rng.permutation(np.arange(1, n_pages))
    for r, n in enumerate(comp):
        k = math.ceil(n / page_size)
        pt[r, :k] = ids[r * mp:r * mp + k]
    shape = (2, n_pages, page_size, n_kv * D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tok_row, tok_pos = [], []
    for r, (q_len, p0, _kv) in enumerate(rows):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row += [len(rows)] * (T - n_real)
    tok_pos += [0] * (T - n_real)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    kv_len = np.asarray([kv for _q, _p, kv in rows], np.int32)
    gap = None if gaps is None else np.asarray(gaps, np.int32)
    return (q, k, v, pt, np.asarray(tok_row, np.int32), np.asarray(tok_pos, np.int32), kv_len,
            gap, n_kv, n_real)


def _poisoned(k, v, pt, comp, page_size: int, n_kv: int, layer: int):
    """Each row's gathered K/V with the trash page and every row at or past
    its (compacted) kv_len set to NaN: only rows the kernels may read stay
    finite."""
    k_p, v_p = k.copy(), v.copy()
    k_p[:, 0] = np.nan
    v_p[:, 0] = np.nan
    for r, n in enumerate(comp):
        for p in range(pt.shape[1]):
            lo = max(0, n - p * page_size)
            if pt[r, p] and lo < page_size:
                k_p[:, pt[r, p], lo:] = np.nan
                v_p[:, pt[r, p], lo:] = np.nan
    k_all, v_all = gather_kv(torch.from_numpy(k_p), torch.from_numpy(v_p), torch.from_numpy(pt),
                             page_size, layer, n_kv)
    return k_all.float(), v_all.float()


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("page_size", [64, 128])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_pair_matches_jax(case, page_size, tiles):
    rng = np.random.default_rng(31)
    q, k, v, pt, tok_row, tok_pos, kv_len, gap, n_kv, n_real = _inputs(case, page_size, rng)
    layer, D = 1, q.shape[-1]
    want = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt), jnp.asarray(tok_row),
        jnp.asarray(tok_pos), jnp.asarray(kv_len), jnp.asarray([layer], jnp.int32),
        page_size=page_size, n_kv=n_kv, interpret=True,
        kv_gap=None if gap is None else jnp.asarray(gap)), np.float32)
    plan = rpa.plan_ragged(torch.from_numpy(tok_row), torch.from_numpy(tok_pos),
                           torch.from_numpy(kv_len), group=q.shape[1] // n_kv,
                           kv_gap=None if gap is None else torch.from_numpy(gap))
    k_all, v_all = _poisoned(k, v, pt, plan.kv_len.tolist(), page_size, n_kv, layer)
    kw = dict(page_size=page_size, n_sm=N_SM, scale=D ** -0.5, tiles=tiles)
    got = emulate_pair(torch.from_numpy(q), k_all, v_all, pt, plan, p_dtype=torch.float32,
                       **kw).numpy()
    assert np.isfinite(got).all()  # every token written, nothing stale read
    assert np.all(got[n_real:] == 0)  # the padding suffix zeroed
    np.testing.assert_allclose(got[:n_real], want[:n_real], atol=1e-5, rtol=0)
    # P rounded to bf16, as both kernels round it: within 2^-9 max|v| of the fp32 result
    rounded = emulate_pair(torch.from_numpy(q), k_all, v_all, pt, plan, p_dtype=torch.bfloat16,
                           **kw).numpy()
    err = np.abs(rounded[:n_real] - want[:n_real]).max()
    assert 1e-5 < err <= 2.0 ** -9 * np.abs(v).max() + 1e-5  # the rounding does happen


def test_a_decode_row_spans_several_splits():
    """The emulation's case for the split merge: the 1,201-key row of
    ``row17_and_splits`` is cut over five splits of 256 keys on 132 SMs."""
    _name, rows, _T, _gaps = CASES[1]
    splits, pps = pa.decode_split(len(rows), 2, math.ceil((1201 + 64) / 64) + 1, 64, N_SM)
    assert pps * 64 == 256 and -(-1201 // (pps * 64)) == 5 <= splits


# --- the engine: descriptors once a round -------------------------------------------

ENGINE = dict(max_seqs=4, page_size=8, num_pages=40, max_seq_len=128, prefill_chunk=16,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0)


def _round_outputs(monkeypatch, per_layer: bool):
    """One ragged round of the tiny fp32 engine on the CPU (a chunk, a
    mid-prompt chunk, two decode rows, one with a bounded-KV gap) from a
    seeded state; ``per_layer`` hands each layer's call no plan, so it
    builds its own descriptors. Returns (emitted, row logits, plans built,
    attention calls)."""
    cfg = tllama.LlamaConfig(dtype=torch.float32)
    torch.manual_seed(0)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    eng = InferenceEngine(cfg, params, EngineConfig(**ENGINE), device="cpu")
    eng.set_page_table_rows({0: [1, 2, 3, 4], 1: [5, 6, 7, 8], 2: [9, 10, 11, 12],
                             3: [13, 14, 15]})
    rng = np.random.default_rng(9)
    eng.prefill_batch([(1, rng.integers(0, 256, 19).tolist()),
                       (3, rng.integers(0, 256, 9).tolist()),
                       (0, rng.integers(0, 256, 16).tolist())])
    eng.set_last_token(1, 17)
    eng.set_last_token(3, 42)
    eng.state.kv_gaps[1] = 8  # slot 1 walks its pages from the second on
    counts = {"plans": 0, "calls": 0}
    real_plan, real_attn = engine_mod.plan_ragged, engine_mod.ragged_paged_attention

    def counting_plan(*a, **k):
        counts["plans"] += 1
        return real_plan(*a, **k)

    def attention(*a, plan=None, **k):
        counts["calls"] += 1
        return real_attn(*a, plan=None if per_layer else plan, **k)

    monkeypatch.setattr(engine_mod, "plan_ragged", counting_plan)
    monkeypatch.setattr(engine_mod, "ragged_paged_attention", attention)
    R = ENGINE["max_seqs"]
    packed = rng.integers(0, 256, 32).tolist() + [0, 0]
    tok_row = [0] * 16 + [1] * 16 + [2, 3]
    T = eng.ragged_bucket(len(packed))
    packed += [0] * (T - len(packed))
    tok_row += [R] * (T - len(tok_row))
    em, _n, logits = eng.ragged_mixed(
        np.asarray(packed, np.int32), np.asarray(tok_row, np.int32),
        np.asarray([0, 2, 1, 3], np.int32), np.asarray([16, 0, 0, 0], np.int32),
        np.asarray([16, 16, 1, 1], np.int32), np.asarray([False, False, True, True]),
        np.asarray([True, False, True, True]), np.zeros(R, np.float32), np.ones(R, np.float32),
        np.zeros(R, np.int32))
    monkeypatch.undo()
    return em, logits, counts["plans"], counts["calls"]


def test_round_builds_its_descriptors_once_and_matches_per_layer(monkeypatch):
    em, logits, plans, calls = _round_outputs(monkeypatch, per_layer=False)
    em_l, logits_l, _plans, calls_l = _round_outputs(monkeypatch, per_layer=True)
    n_layers = tllama.LlamaConfig().n_layers
    assert plans == 1 and calls == calls_l == n_layers
    assert torch.equal(em, em_l) and torch.equal(logits, logits_l)
