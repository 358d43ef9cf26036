"""K7's Hopper backward (``csrc/flash_attention_bwd_sm90.cu``) on the CPU.

Two things are held here without a card. First, the pure functions around
it: ``flash_bwd_kernel_for`` sends the calls the Hopper forward takes —
Llama-3-8B's training step (S = 2048) and every causal call of 64-row query
tiles at head_dim 128 — to ``flash_attention_bwd_sm90``, and every other call
(``causal=False``, other head dims, groups that do not divide 64, fewer
rows, unaligned tensors) to the older ``flash_attention_bwd``; the kernel is
registered; CPU tensors are refused. The dK/dV blocks (key tiles j and
n - 1 - j) and the dQ blocks (one or two query tiles, ``query_tiles_per_block``,
counted from the end) cover every tile exactly once, and at the training
shape every dK/dV block streams as many query tiles, half to each consumer.

Second, the kernel's arithmetic: a torch emulation of its partition — the
pre-pass's per-tile base-2 lse and delta (+inf and 0 past Sq or where lse is
-inf), 64-row query tiles packing the group's heads token-major, 64-key
tiles, Q/dO/K/V read as per-sequence 4D boxes (rows past Sq or Sk zero, as
TMA fills them; every other row of the emulated tensors NaN but the
sequence's own rows below kv_len for K and V), the paired dK/dV blocks
whose two consumers take the streamed query tiles in turn and add their
sums in a fixed order, the dQ blocks walking their last row's keys with K's
rows past kv_len zeroed, P^T and dS rounded to the working dtype before
their products, masks only in tiles that cross kv_len or the diagonal —
held against ``jax.grad`` of the JAX ``mha_reference`` (the gradient the
JAX package's train step takes) at fp32 with rounding off, and against the
port's plain ``flash_attention_bwd_ref`` at bf16.

Tolerances: fp32 with rounding off, ``atol = rtol = 1e-5`` (the same math
as the reference in another order: a base-2 exponential of a rescaled
score, partial sums added in another order; the JAX tests' and
``test_torch_flash.py``'s backward tolerance). bf16 inputs with the
kernel's rounding points against the plain backward: per tensor
``||got - want|| / ||want|| <= 1e-2`` and per row ``max|got - want| <= 2^-5
* max(max|want row|, 2^-10 * max|want|)``, ``GRAD_REL_TOL`` and
``GRAD_ROW_TOL`` of ``chip_smoke.py``, the limits the card's checks hold
the kernel to (dS rounded to bf16 moves each product by up to 2^-9 of
itself; tests/test_torch_k7_rounding.py). ``tests/test_torch_cuda.py``
holds the kernel itself against the plain version on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.ops.refs import mha_reference as jax_mha  # noqa: E402
from finchat_tpu_torch.models.llama import PRESETS  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops import paged_attention as pa  # noqa: E402
from finchat_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
    flash_bwd_kernel_for,
    flash_kernel_for,
    prepare_flash_bwd,
)

torch.set_float32_matmul_precision("highest")

NAME = "flash_attention_bwd_sm90"
OLD = "flash_attention_bwd"
LOG2E = 1.4426950408889634
GRAD_REL_TOL, GRAD_ROW_TOL, GRAD_ROW_FLOOR = 1e-2, 2.0 ** -5, 2.0 ** -10
_8B = PRESETS["llama3-8b"]
_GROUP = _8B.n_heads // _8B.n_kv_heads


# --- routing -------------------------------------------------------------------

def test_the_training_shape_reaches_the_kernel():
    assert _8B.head_dim == 128
    assert flash_bwd_kernel_for(True, _GROUP, _8B.head_dim, 2048, True) == NAME


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 12, 64, 128])
@pytest.mark.parametrize("Sq", [1, 8, 15, 16, 100, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_the_backward_follows_the_forward(causal, Sq, group, head_dim, aligned):
    """Every call whose forward is the Hopper entry has the Hopper backward,
    and no other: the two rules agree over a grid of calls."""
    fwd = flash_kernel_for(causal, group, head_dim, Sq, aligned)
    want = NAME if fwd == "flash_attention_sm90" else OLD
    assert flash_bwd_kernel_for(causal, group, head_dim, Sq, aligned) == want


@pytest.mark.parametrize("Sq", [16, 17, 100, 512, 4096])
def test_forward_hopper_calls_reach_the_kernel(Sq):
    assert flash_bwd_kernel_for(True, _GROUP, 128, Sq, True) == NAME


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32, 64])
def test_every_group_dividing_64_reaches_the_kernel(group):
    assert flash_bwd_kernel_for(True, group, 128, 2048, True) == NAME


@pytest.mark.parametrize("Sq", [16, 2048])
def test_non_causal_calls_keep_the_pr3_backward(Sq):
    assert flash_bwd_kernel_for(False, _GROUP, 128, Sq, True) == OLD


@pytest.mark.parametrize("head_dim", [64, 96, 256])
def test_other_head_dims_keep_the_pr3_backward(head_dim):
    assert flash_bwd_kernel_for(True, _GROUP, head_dim, 2048, True) == OLD


@pytest.mark.parametrize("group", [3, 5, 6, 12, 128])
def test_groups_not_dividing_64_keep_the_pr3_backward(group):
    assert flash_bwd_kernel_for(True, group, 128, 2048, True) == OLD


@pytest.mark.parametrize("Sq", [1, 8, 15])
def test_rows_under_64_keep_the_pr3_backward(Sq):
    assert flash_bwd_kernel_for(True, _GROUP, 128, Sq, True) == OLD


def test_unaligned_tensors_keep_the_pr3_backward():
    assert flash_bwd_kernel_for(True, _GROUP, 128, 2048, False) == OLD


def test_the_kernel_is_registered():
    assert NAME in kernels.KERNELS and NAME in kernels.LAUNCHES
    src, sym, argtypes = kernels.KERNELS[NAME]
    assert (src, sym) == ("flash_attention_bwd_sm90.cu", "flash_attention_bwd_bf16_sm90")
    assert src in kernels.SOURCES
    # the older backward's arguments, then the tile tokens and the dQ tiles a block
    old = kernels.KERNELS[OLD][2]
    assert argtypes == old[:-2] + [kernels._I] * 2 + old[-2:]


def test_prepare_refuses_cpu_tensors():
    q = torch.zeros((1, 32, 8, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 32, 2, 128), dtype=torch.bfloat16)
    i32 = torch.zeros(1, dtype=torch.int32)
    lse = torch.zeros((1, 8, 32))
    for kernel in (None, NAME, OLD):
        with pytest.raises(ValueError, match="CUDA"):
            prepare_flash_bwd(q, k, k, q, lse, q, i32, i32 + 32, causal=True, scale=1.0,
                              kernel=kernel)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_bwd(q, k, k, q, lse, q, i32, i32 + 32, causal=True, scale=1.0,
                                kernel=kernel)


# --- the blocks -------------------------------------------------------------------

def dkdv_blocks(n_kt: int) -> list[list[int]]:
    """The key tiles of each dK/dV block of one sequence and KV head, in the
    kernel's order of blockIdx.x: block x takes pair p = grid.x - 1 - x,
    the tiles p and n_kt - 1 - p (one tile where they meet)."""
    grid_x = (n_kt + 1) // 2
    blocks = []
    for x in range(grid_x):
        p = grid_x - 1 - x
        blocks.append([p] if p == n_kt - 1 - p else [p, n_kt - 1 - p])
    return blocks


def walk_begin(k0: int, kv_len: int, q_off: int, bq: int, n_qt: int) -> int:
    """The first query tile a key tile at k0 streams: the tile of the first
    position at or past k0 (none where its keys are all at or past kv_len)."""
    return n_qt if k0 >= kv_len else max(0, k0 - q_off) // bq


def dq_blocks(n_qt: int, tiles: int) -> list[list[int]]:
    """The query tiles of each dQ block, in the kernel's order of blockIdx.x:
    block x starts at tile (grid.x - 1 - x) * tiles."""
    grid_x = -(-n_qt // tiles)
    return [[t for t in range((grid_x - 1 - x) * tiles, (grid_x - x) * tiles) if t < n_qt]
            for x in range(grid_x)]


@pytest.mark.parametrize("n_kt", [1, 2, 3, 4, 7, 24, 32])
def test_dkdv_blocks_cover_every_key_tile_once(n_kt):
    blocks = dkdv_blocks(n_kt)
    assert sorted(j for block in blocks for j in block) == list(range(n_kt))
    assert all(1 <= len(block) <= 2 for block in blocks)


_BLOCK_CALLS = [(B, Sq, group, n_kv, n_sm)
                for B in (1, 4) for Sq in (64, 100, 512, 2048)
                for group, n_kv in ((1, 2), (4, 8), (8, 2)) for n_sm in (1, 132)]


@pytest.mark.parametrize("call", _BLOCK_CALLS, ids=["B{}_S{}_g{}_kv{}_sm{}".format(*c)
                                                    for c in _BLOCK_CALLS])
def test_dq_blocks_cover_every_query_tile_once(call):
    B, Sq, group, n_kv, n_sm = call
    bq = pa.tile_tokens(group, Sq)
    tiles = pa.query_tiles_per_block(B, Sq, group, n_kv, n_sm)
    n_qt = -(-Sq // bq)
    blocks = dq_blocks(n_qt, tiles)
    assert sorted(t for block in blocks for t in block) == list(range(n_qt))
    assert all(block for block in blocks)
    assert blocks[0][0] == max(block[0] for block in blocks)  # heaviest first


def test_training_shape_dkdv_blocks_are_equal():
    """B=1, S=2048: 32 key tiles a KV head, 16 pairs x 8 KV heads = 128
    blocks (one wave on 132 SMs), each streaming 132 of the 16-token query
    tiles, 66 to each consumer."""
    S, bq = 2048, 64 // _GROUP
    n_qt, blocks = S // bq, dkdv_blocks(S // 64)
    assert len(blocks) * _8B.n_kv_heads == 128
    for block in blocks:
        stream = [t for j in block for t in range(walk_begin(64 * j, S, 0, bq, n_qt), n_qt)]
        assert len(stream) == 132
        assert len(stream[0::2]) == len(stream[1::2]) == 66


# --- the kernel's partition, emulated --------------------------------------------

def tma_rows(x, b: int, row0: int, n_rows: int):
    """Rows [row0, row0 + n_rows) of sequence b of x [B, S, heads, D], as one
    per-sequence 4D box reads them: rows past S are zeros."""
    S = x.shape[1]
    box = torch.zeros((n_rows,) + tuple(x.shape[2:]))
    n = max(0, min(n_rows, S - row0))
    box[:n] = x[b, row0:row0 + n]
    return box


def emulate_prepass(out, dout, lse, group: int, bq: int):
    """``[B, Hkv, n_qt, 2, 64]``: per query tile, in its row order (row r:
    token r // group, head r % group), lse * log2 e (+inf past Sq or where
    lse is -inf) and delta = rowsum(dout * out) (0 past Sq)."""
    B, Sq, H, _D = out.shape
    n_kv, n_qt = H // group, -(-Sq // bq)
    ld = torch.zeros((B, n_kv, n_qt, 2, 64))
    ld[:, :, :, 0] = math.inf
    delta = (dout.float() * out.float()).sum(-1)  # [B, Sq, H]
    l2 = torch.where(torch.isneginf(lse), torch.tensor(math.inf), lse * LOG2E)  # [B, H, Sq]
    for t in range(n_qt):
        for r in range(64):
            tok, heads = t * bq + r // group, [g * group + r % group for g in range(n_kv)]
            if tok < Sq:
                ld[:, :, t, 0, r] = l2[:, heads, tok]
                ld[:, :, t, 1, r] = delta[:, tok, heads]
    return ld


def emulate_bwd_sm90(q, k, v, out, lse, dout, q_offset, kv_len, *, tiles: int, scale: float,
                     p_dtype):
    """The kernel's arithmetic in torch at fp32: ``(dq, dk, dv)``. ``q`` and
    ``dout`` [B, Sq, H, D], ``k``/``v`` [B, Sk, Hkv, D] (values of the working
    dtype, as fp32), ``out`` and ``lse`` the forward's. The K/V rows each
    sequence reads are its own below kv_len: every other row is NaN."""
    B, Sq, H, D = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    group, bq = H // n_kv, 64 // (H // n_kv)
    n_qt, n_kt = -(-Sq // bq), -(-Sk // 64)
    c2 = scale * LOG2E
    ld = emulate_prepass(out, dout, lse, group, bq)
    dq = torch.full((B, Sq, H, D), math.nan)
    dk = torch.full((B, Sk, n_kv, D), math.nan)
    dv = torch.full((B, Sk, n_kv, D), math.nan)
    nan = torch.tensor(math.nan)
    for b in range(B):
        kl, qo = min(int(kv_len[b]), Sk), int(q_offset[b])
        seen_k, seen_v = (torch.where((torch.arange(Sk) < kl)[None, :, None, None], x, nan)
                          for x in (k, v))

        def q_tile(x, t, g):  # a query tile's 64 rows, token-major: row r = i * group + hh
            return tma_rows(x, b, t * bq, bq)[:, g * group:(g + 1) * group].reshape(64, D)

        for g in range(n_kv):
            # dK/dV: pairs of key tiles, the two consumers taking the stream in turn
            for block in dkdv_blocks(n_kt):
                it = 0
                for j in block:
                    k0 = 64 * j
                    k_t, v_t = (tma_rows(x, b, k0, 64)[:, g] for x in (seen_k, seen_v))
                    sums = [[torch.zeros(64, D), torch.zeros(64, D)] for _ in range(2)]
                    keys = torch.arange(k0, k0 + 64)
                    for t in range(walk_begin(k0, kl, qo, bq, n_qt), n_qt):
                        dk_c, dv_c = sums[it % 2]
                        it += 1
                        q_t, do_t = q_tile(q, t, g), q_tile(dout, t, g)
                        l2, dl = ld[b, g, t, 0], ld[b, g, t, 1]
                        p = torch.exp2(k_t @ q_t.T * c2 - l2[None, :])
                        if k0 + 63 > qo + t * bq or k0 + 64 > kl:
                            pos = qo + t * bq + torch.arange(64) // group
                            ok = (keys[:, None] < kl) & (keys[:, None] <= pos[None, :])
                            p = torch.where(ok, p, 0.0)
                            ds = torch.where(p != 0, p * (v_t @ do_t.T - dl[None, :]), 0.0)
                        else:
                            ds = p * (v_t @ do_t.T - dl[None, :])
                        dv_c += p.to(p_dtype).float() @ do_t
                        dk_c += ds.to(p_dtype).float() @ q_t
                    n = min(64, Sk - k0)
                    dv[b, k0:k0 + n, g] = (sums[0][1] + sums[1][1])[:n]
                    dk[b, k0:k0 + n, g] = ((sums[1][0] + sums[0][0]) * scale)[:n]
            # dQ: blocks of query tiles walking their last row's keys
            for block in dq_blocks(n_qt, tiles):
                block_keys = min(kl, qo + min(Sq, (block[-1] + 1) * bq))
                for t in block:
                    q_t, do_t = q_tile(q, t, g), q_tile(dout, t, g)
                    l2, dl = ld[b, g, t, 0], ld[b, g, t, 1]
                    pos = qo + t * bq + torch.arange(64) // group
                    acc = torch.zeros(64, D)
                    for kt in range(-(-max(block_keys, 0) // 64)):
                        k0 = 64 * kt
                        keys = torch.arange(k0, k0 + 64)
                        k_t, v_t = (tma_rows(x, b, k0, 64)[:, g] for x in (seen_k, seen_v))
                        p = torch.exp2(q_t @ k_t.T * c2 - l2[:, None])
                        ds = p * (do_t @ v_t.T - dl[:, None])
                        if k0 + 63 > qo + t * bq or k0 + 64 > kl:
                            ok = (keys[None, :] < kl) & (keys[None, :] <= pos[:, None])
                            ds = torch.where(ok, ds, 0.0)
                            k_t = torch.where((keys < kl)[:, None], k_t, 0.0)  # the K tail zeroed
                        acc += ds.to(p_dtype).float() @ k_t
                    for r in range(64):
                        tok = t * bq + r // group
                        if tok < Sq:
                            dq[b, tok, g * group + r % group] = acc[r] * scale
    return dq, dk, dv


# (name, B, Sq, Sk, H, Hkv, q_offsets, kv_lens): q_offset != 0 with kv_len
# under Sk; Sk and Sq off the 64-key and 64-row tiles (a box running past a
# sequence's end); a kv_len-0 sequence between two others (its rows without
# keys: no gradient); partial last query tiles; B > 1; groups of 1 and 8
CASES = [
    ("q_offset_kv_len", 2, 64, 256, 8, 2, [32, 100], [96, 164]),
    ("partial_empty", 3, 100, 100, 8, 2, [0, 0, 0], [100, 0, 77]),
    ("offset_tile_edges", 2, 70, 200, 8, 2, [63, 130], [133, 190]),
    ("group8", 2, 40, 130, 16, 2, [90, 0], [130, 40]),
    ("mha_group1", 1, 130, 130, 2, 2, [0], [130]),
]


def _inputs(case, rng):
    _name, B, Sq, Sk, H, Hkv, q_off, kv_len = case
    q, do = (rng.standard_normal((B, Sq, H, 128)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Hkv, 128)).astype(np.float32) for _ in range(2))
    return q, k, v, do, np.asarray(q_off, np.int32), np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_kernel_matches_jax_grad_fp32(case, tiles):
    """Rounding off: the emulation's gradients against ``jax.grad`` of the JAX
    ``mha_reference`` (1e-5) on every sequence with keys; a kv_len-0
    sequence gets zeros, as the plain backward gives it."""
    q, k, v, do, q_off, kv_len = _inputs(case, np.random.default_rng(41))

    def loss(q_, k_, v_):
        out = jax_mha(q_, k_, v_, causal=True, q_offset=jnp.asarray(q_off),
                      kv_len=jnp.asarray(kv_len))
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_ref(tq, tk, tv, q_offset=torch.from_numpy(q_off),
                                   kv_len=torch.from_numpy(kv_len), causal=True)
    got = emulate_bwd_sm90(tq, tk, tv, out, lse, tdo, q_off, kv_len, tiles=tiles,
                           scale=128 ** -0.5, p_dtype=torch.float32)
    live = kv_len > 0
    for g, w in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[live], np.asarray(w)[live], atol=1e-5, rtol=1e-5)
        assert np.all(g[~live] == 0)


def _grad_close(got, want) -> tuple[float, float]:
    """(relative norm error, worst row error over its limit)."""
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    diff = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp(min=GRAD_ROW_FLOOR * want.abs().max().item())
    return rel, (diff / (GRAD_ROW_TOL * scale)).max().item()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_kernel_matches_plain_backward_bf16(case):
    """bf16 inputs, the kernel's rounding points (P^T and dS to bf16 before
    their products, bf16 gradients) against ``flash_attention_bwd_ref`` on
    the same bf16 inputs and the forward's out and lse, within the card's
    limits."""
    arrays = _inputs(case, np.random.default_rng(42))
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrays[:4])
    q_off, kv_len = (torch.from_numpy(a) for a in arrays[4:])
    B, Sq, H, D = q.shape
    out, lse = flash_attention_ref(q, k, v, q_offset=q_off, kv_len=kv_len, causal=True)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, q_offset=q_off, kv_len=kv_len)
    tiles = pa.query_tiles_per_block(B, Sq, H // k.shape[2], k.shape[2], 1)
    got = emulate_bwd_sm90(q.float(), k.float(), v.float(), out, lse, do.float(), q_off, kv_len,
                           tiles=tiles, scale=D ** -0.5, p_dtype=torch.bfloat16)
    live = kv_len > 0
    for g, w in zip(got, want):
        g = g.bfloat16()  # the kernel's bf16 gradients
        assert bool(torch.isfinite(g.float()).all())
        rel, row = _grad_close(g[live], w[live])
        assert rel <= GRAD_REL_TOL and row <= 1.0, (rel, row)
        assert bool((g[~live] == 0).all())


def test_emulated_rounding_does_happen():
    """The bf16 rounding points move the result (the bf16 test above would
    otherwise not exercise them), and by far less than the card's limit."""
    arrays = _inputs(CASES[0], np.random.default_rng(43))
    q, k, v, do = (torch.from_numpy(a) for a in arrays[:4])
    q_off, kv_len = (torch.from_numpy(a) for a in arrays[4:])
    out, lse = flash_attention_ref(q, k, v, q_offset=q_off, kv_len=kv_len, causal=True)
    kw = dict(tiles=2, scale=128 ** -0.5)
    exact = emulate_bwd_sm90(q, k, v, out, lse, do, q_off, kv_len, p_dtype=torch.float32, **kw)
    rounded = emulate_bwd_sm90(q, k, v, out, lse, do, q_off, kv_len, p_dtype=torch.bfloat16,
                               **kw)
    for r, e in zip(rounded, exact):
        rel, row = _grad_close(r, e)
        assert 1e-5 < rel <= GRAD_REL_TOL / 2 and row <= 0.5
