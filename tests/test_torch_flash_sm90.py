"""K7's Hopper forward (the contiguous entry of ``csrc/attention_bf16_sm90.cu``) on the CPU.

Two things are held here without a card. First, the pure functions around
it: ``flash_kernel_for`` sends causal calls at head_dim 128 whose query
tiles hold 64 rows — Llama-3-8B's training step (S = 2048) and its one-shot
forward at any prompt of a tile or more — to ``flash_attention_sm90``, and
every other call (``causal=False``, other head dims, groups that do not
divide 64, fewer rows, unaligned tensors) to the older kernel
``flash_attention``; no length of K is excluded. The entry's blocks (one or
two query tiles each, ``query_tiles_per_block``, counted from the sequence's
end) cover every query tile exactly once. Second, the entry's arithmetic: a
torch emulation of its partition — blocks of 64-row query tiles of one
sequence and KV head walking the keys of their longest tile in 128-key
tiles fetched as 64-key boxes from K/V viewed as [B * Sk, Hkv * 128] (boxes
past the block's keys never fetched, rows past the whole tensor zero as TMA
fills them, kv_len cut at Sk), V's rows at or past kv_len zeroed, the
online softmax in base 2 with P rounded to the value dtype, and the
log-sum-exp from the base-2 state — against the JAX ``flash_attention`` in
interpret mode, as the JAX package's own tests run it here, and its
log-sum-exp against the port's plain ``flash_attention_ref``. The emulation
of sequence b reads a copy of K/V in which every row but sequence b's rows
below its kv_len is NaN — the rows at or past kv_len and every row of the
next sequence, where a box that starts near Sk runs on — so a stray read
shows as a NaN.

Tolerances: fp32 inputs with P kept in fp32, ``atol=1e-5`` for the output
(the same math as the reference in another order) and for the log-sum-exp.
fp32 inputs with P rounded to bf16, as the kernel does: each probability
moves by at most 2^-9 of itself while the denominator keeps the unrounded
sum, so an output moves by at most 2^-9 * max|v|; held within that plus
1e-5. bf16 inputs against the JAX kernel at bf16: per output row
``max|got - want| <= min(2e-2, 2^-6 * max|want|)``, the card's tolerance
(two bf16 ulps). ``tests/test_torch_cuda.py`` holds the kernel itself
against the plain version on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from finchat_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from finchat_tpu_torch.models.llama import PRESETS  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops import paged_attention as pa  # noqa: E402
from finchat_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_ref,
    flash_kernel_for,
    prepare_flash,
)

torch.set_float32_matmul_precision("highest")

NAME = "flash_attention_sm90"
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_8B = PRESETS["llama3-8b"]
_GROUP = _8B.n_heads // _8B.n_kv_heads


# --- routing -------------------------------------------------------------------

def test_the_training_shape_reaches_the_entry():
    """Llama-3-8B's training step: 32 heads over 8 KV heads, head_dim 128,
    S = 2048, causal."""
    assert _8B.head_dim == 128
    assert flash_kernel_for(True, _GROUP, _8B.head_dim, 2048, True) == NAME


@pytest.mark.parametrize("Sq", [16, 17, 100, 512, 4096, 8192])
def test_one_shot_prompts_reach_the_entry(Sq):
    """The one-shot forward (``forward_full``) of a prompt of a 16-token
    tile or more."""
    assert flash_kernel_for(True, _GROUP, _8B.head_dim, Sq, True) == NAME


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32, 64])
def test_every_group_dividing_64_reaches_the_entry(group):
    assert flash_kernel_for(True, group, 128, 2048, True) == NAME


@pytest.mark.parametrize("Sq", [1, 8, 15])
def test_rows_under_64_keep_the_pr3_kernel(Sq):
    """Fewer than 16 tokens give Llama-3's group of 4 fewer than 64 rows."""
    assert flash_kernel_for(True, _GROUP, 128, Sq, True) == "flash_attention"


@pytest.mark.parametrize("Sq", [16, 2048])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_non_causal_calls_keep_the_pr3_kernel(group, Sq):
    assert flash_kernel_for(False, group, 128, Sq, True) == "flash_attention"


@pytest.mark.parametrize("group", [3, 5, 6, 12, 128])
def test_groups_not_dividing_64_keep_the_pr3_kernel(group):
    assert flash_kernel_for(True, group, 128, 2048, True) == "flash_attention"


@pytest.mark.parametrize("head_dim", [64, 96, 256])
def test_other_head_dims_keep_the_pr3_kernel(head_dim):
    assert flash_kernel_for(True, _GROUP, head_dim, 2048, True) == "flash_attention"


def test_unaligned_tensors_keep_the_pr3_kernel():
    assert flash_kernel_for(True, _GROUP, 128, 2048, False) == "flash_attention"


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_route_by_head_dim_and_group(preset):
    c = PRESETS[preset]
    group = c.n_heads // c.n_kv_heads
    want = NAME if c.head_dim == 128 and 64 % group == 0 else "flash_attention"
    assert flash_kernel_for(True, group, c.head_dim, 2048, True) == want


def test_the_entry_is_registered():
    assert NAME in kernels.KERNELS and NAME in kernels.LAUNCHES
    src, sym, argtypes = kernels.KERNELS[NAME]
    assert (src, sym) == ("attention_bf16_sm90.cu", "flash_attention_bf16_sm90")
    assert src in kernels.SOURCES
    # the older forward's arguments, then the tile tokens and the tiles a block
    old = kernels.KERNELS["flash_attention"][2]
    assert argtypes == old[:-2] + [kernels._I] * 2 + old[-2:]


def test_prepare_refuses_cpu_tensors():
    q = torch.zeros((1, 32, 8, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 32, 2, 128), dtype=torch.bfloat16)
    i32 = torch.zeros(1, dtype=torch.int32)
    for kernel in (None, NAME, "flash_attention"):
        with pytest.raises(ValueError, match="CUDA"):
            prepare_flash(q, k, k, i32, i32 + 32, causal=True, scale=1.0, kernel=kernel)


# --- the entry's blocks ---------------------------------------------------------

def entry_blocks(Sq: int, bq: int, tiles: int) -> list[list[list[int]]]:
    """The query tokens of each block of one sequence and KV head, in the
    kernel's order of blockIdx.x: block x starts at token (grid.x - 1 - x) *
    tiles * bq and holds ``tiles`` tiles of up to bq tokens (a tile past Sq
    holds none)."""
    grid_x = math.ceil(Sq / (tiles * bq))
    blocks = []
    for x in range(grid_x):
        c0 = (grid_x - 1 - x) * tiles * bq
        blocks.append([list(range(c0 + w * bq, min(c0 + (w + 1) * bq, Sq)))
                       for w in range(tiles)])
    return blocks


_BLOCK_CALLS = [(B, Sq, group, n_kv, n_sm)
                for B in (1, 4) for Sq in (64, 100, 512, 2048)
                for group, n_kv in ((1, 2), (4, 8), (8, 2)) for n_sm in (1, 132)]


@pytest.mark.parametrize("call", _BLOCK_CALLS, ids=["B{}_S{}_g{}_kv{}_sm{}".format(*c)
                                                    for c in _BLOCK_CALLS])
def test_blocks_cover_every_query_tile_once(call):
    B, Sq, group, n_kv, n_sm = call
    bq = pa.tile_tokens(group, Sq)
    assert group * bq == 64
    tiles = pa.query_tiles_per_block(B, Sq, group, n_kv, n_sm)
    assert 1 <= tiles <= pa.SM90_MAX_TILES
    blocks = entry_blocks(Sq, bq, tiles)
    tokens = sorted(t for block in blocks for tile in block for t in tile)
    assert tokens == list(range(Sq))
    assert all(block[0] for block in blocks)  # no block without a tile
    # the first blocks issued hold the last tokens, which see the most keys
    assert blocks[0][0][0] == max(block[0][0] for block in blocks)


def test_training_step_blocks():
    """B=1, S=2048 on 132 SMs: 128 tiles of 16 tokens a KV head, two a
    block, 512 blocks."""
    tiles = pa.query_tiles_per_block(1, 2048, _GROUP, _8B.n_kv_heads, 132)
    assert tiles == 2
    assert len(entry_blocks(2048, 16, tiles)) * _8B.n_kv_heads == 512


# --- the entry's partition, emulated ----------------------------------------------

def emulate_contiguous_entry(q, k, v, q_offset, kv_len, *, tiles: int, scale: float, p_dtype):
    """The contiguous entry's arithmetic in torch at fp32: ``(out, lse)``.
    ``q`` [B, Sq, H, D], ``k``/``v`` [B, Sk, Hkv, D] (values of the working
    dtype, as fp32). Per sequence b (kv_len cut at Sk) and KV head g: the
    blocks of ``entry_blocks``; a block's keys are those of its longest tile
    (min(Sk, kv_len, largest position + 1)), walked in 128-key tiles of two
    64-key boxes at rows b * Sk + key of K/V viewed as [B * Sk, Hkv, D], a
    box fetched only if it holds one of those keys, rows past B * Sk zero
    (TMA's fill); V's rows at or past kv_len, and those of a box not
    fetched, zero. The rows this sequence may read are its own below
    kv_len: every other row reads NaN. Each query tile walks every tile of
    its block (keys past its rows' positions masked) with an online softmax
    in base 2 over raw scores (running maximum m, p = 2^(s c - m c), c =
    scale * log2 e), P rounded to ``p_dtype`` for the PV product, the
    denominator summed unrounded; out = acc / max(l, 1e-30), lse = ln 2 *
    (m c + log2 l), -inf where l is 0."""
    B, Sq, H, D = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    group = H // n_kv
    bq = 64 // group
    c = scale * LOG2E
    out = torch.full_like(q, math.nan)
    lse = torch.full((B, H, Sq), math.nan)
    nan = torch.tensor(math.nan)
    for b in range(B):
        kl, qo = min(int(kv_len[b]), Sk), int(q_offset[b])
        seen_k = torch.full((B * Sk + 128, n_kv, D), math.nan)
        seen_v = seen_k.clone()
        seen_k[B * Sk:] = 0
        seen_v[B * Sk:] = 0
        seen_k[b * Sk:b * Sk + kl] = k[b, :kl]
        seen_v[b * Sk:b * Sk + kl] = v[b, :kl]
        for g in range(n_kv):
            for toks in entry_blocks(Sq, bq, tiles):
                block_keys = max([min(Sk, kl, qo + tok[-1] + 1) for tok in toks if tok] + [0])
                boxes = [1 + (block_keys - 128 * t > 64)
                         for t in range(math.ceil(block_keys / 128))]
                for tok in toks:
                    if not tok:
                        continue
                    rows = q[b, tok, g * group:(g + 1) * group].transpose(0, 1).reshape(-1, D)
                    pos = torch.tensor([qo + i for i in tok]).repeat(group)
                    m = torch.full((rows.shape[0],), -1e30)
                    l = torch.zeros(rows.shape[0])
                    acc = torch.zeros(rows.shape[0], D)
                    for t, nb in enumerate(boxes):
                        keys = torch.arange(128 * t, 128 * t + 128)
                        fetched = keys < 128 * t + 64 * nb
                        k_t = torch.where(fetched[:, None], seen_k[b * Sk + keys, g], nan)
                        v_t = torch.where((fetched & (keys < kl))[:, None],
                                          seen_v[b * Sk + keys, g], torch.zeros(()))
                        s = rows @ k_t.T
                        ok = (keys[None, :] < kl) & (keys[None, :] <= pos[:, None])
                        s = torch.where(ok, s, torch.tensor(-math.inf))
                        mn = torch.maximum(m, s.max(-1).values)
                        corr = torch.exp2((m - mn) * c)
                        p = torch.exp2(s * c - (mn * c)[:, None])
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + p.to(p_dtype).float() @ v_t
                        m = mn
                    o = acc / l.clamp(min=1e-30)[:, None]  # rows: head-major, then token
                    out[b, tok, g * group:(g + 1) * group] = (
                        o.reshape(group, len(tok), D).transpose(0, 1))
                    row_lse = torch.where(l > 0, LN2 * (m * c + torch.log2(l)),
                                          torch.tensor(-math.inf))
                    lse[b, g * group:(g + 1) * group, tok] = row_lse.reshape(group, len(tok))
    return out, lse


# (name, B, Sq, Sk, H, Hkv, q_offsets, kv_lens): q_offset != 0 with kv_len
# under Sk; Sk off the 64-key box, so sequence 0's last box runs into
# sequence 1's rows (kv_len 0: its rows without keys, zeros and lse -inf)
# and sequence 2's past the tensor; partial last query tiles; B > 1; a
# group of 8
CASES = [
    ("q_offset_kv_len", 2, 64, 256, 8, 2, [32, 100], [96, 164]),
    ("spill_partial_empty", 3, 100, 100, 8, 2, [0, 0, 0], [100, 0, 77]),
    ("offset_tile_edges", 2, 70, 200, 8, 2, [63, 130], [133, 190]),
    ("group8", 2, 40, 130, 16, 2, [90, 0], [130, 40]),
]


def _inputs(case, rng):
    _name, B, Sq, Sk, H, Hkv, q_off, kv_len = case
    q = rng.standard_normal((B, Sq, H, 128)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, 128)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, 128)).astype(np.float32)
    return q, k, v, np.asarray(q_off, np.int32), np.asarray(kv_len, np.int32)


def _jax_out(q, k, v, q_off, kv_len, dtype):
    to_j = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return np.asarray(jax_flash(to_j(q), to_j(k), to_j(v), q_offset=jnp.asarray(q_off),
                                kv_len=jnp.asarray(kv_len), causal=True, interpret=True),
                      np.float32)


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_entry_matches_jax_fp32(case, tiles):
    rng = np.random.default_rng(31)
    q, k, v, q_off, kv_len = _inputs(case, rng)
    D = q.shape[-1]
    want = _jax_out(q, k, v, q_off, kv_len, jnp.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _plain, want_lse = flash_attention_ref(tq, tk, tv, q_offset=torch.from_numpy(q_off),
                                           kv_len=torch.from_numpy(kv_len), causal=True)
    kw = dict(tiles=tiles, scale=D ** -0.5)
    got, lse = emulate_contiguous_entry(tq, tk, tv, q_off, kv_len, p_dtype=torch.float32, **kw)
    got, lse = got.numpy(), lse.numpy()
    live = kv_len > 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got[~live] == 0) and np.all(want[~live] == 0)
    assert np.isfinite(lse[live]).all() and np.all(np.isneginf(lse[~live]))
    np.testing.assert_allclose(lse[live], want_lse.numpy()[live], atol=1e-5, rtol=0)
    # P rounded to bf16, as the kernel rounds it: within 2^-9 max|v| of the
    # fp32 result; the log-sum-exp keeps the unrounded sum
    rounded, lse_r = emulate_contiguous_entry(tq, tk, tv, q_off, kv_len, p_dtype=torch.bfloat16,
                                              **kw)
    bound = 2.0 ** -9 * np.abs(v).max() + 1e-5
    assert np.abs(rounded.numpy() - want).max() <= bound
    assert np.abs(rounded.numpy() - want).max() > 1e-5  # the rounding does happen
    assert torch.equal(lse_r, torch.from_numpy(lse))


def _rows_close(got: np.ndarray, want: np.ndarray) -> float:
    """Worst per-row error over its limit min(2e-2, 2^-6 * max|want row|)."""
    diff = np.abs(got - want).max(-1)
    limit = np.minimum(2e-2, 2.0 ** -6 * np.abs(want).max(-1))
    return float((diff / np.maximum(limit, 1e-30)).max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_entry_matches_jax_bf16(case):
    rng = np.random.default_rng(32)
    q, k, v, q_off, kv_len = (torch.from_numpy(a) for a in _inputs(case, rng))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    want = _jax_out(*(t.float().numpy() for t in (q, k, v)), q_off.numpy(), kv_len.numpy(),
                    jnp.bfloat16)
    tiles = pa.query_tiles_per_block(B, Sq, H // Hkv, Hkv, 1)
    got, _lse = emulate_contiguous_entry(q.float(), k.float(), v.float(), q_off, kv_len,
                                         tiles=tiles, scale=D ** -0.5, p_dtype=torch.bfloat16)
    got = got.bfloat16().float().numpy()  # the kernel's bf16 output
    live = kv_len.numpy() > 0
    assert _rows_close(got[live], want[live]) <= 1.0
    assert np.all(got[~live] == 0) and np.all(want[~live] == 0)
