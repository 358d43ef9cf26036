"""The Hopper bf16 prefill attention body (``csrc/attention_bf16_sm90.cu``) on the CPU.

Two things are held here without a card. First, the pure functions around
it: ``attention_kernel_for`` sends every bf16 paged call of 64-row blocks
over pages of whole 64-key tiles with no split (every prefill chunk at page
128) to ``paged_attention_sm90``, and every other bf16 call to the kernel
it reached before — decode to the decode body, fewer rows, pages of part
tiles and splits to the older body; a bf16 ragged round of 64-row tiles
over pages of whole 64-key tiles to the pair of Hopper ragged entries
(``ragged_kernels_for``), every other ragged round to K3;
``query_tiles_per_block`` gives each block of the body at least one and at
most two query tiles, never more than the chunk has, one only where the
call's one-tile blocks fit in a wave, the blocks together cover every
query tile exactly once, and a 4 x 512 chunk still fills a wave of 132
SMs. Second, the body's arithmetic: a torch emulation of its
partition — blocks of ``tiles`` 64-row query tiles of one sequence and KV
head walking the keys of their longest tile in 128-key tiles fetched as
64-key boxes (boxes past kv_len and past the block's largest position never
fetched), V's rows of the last tile at or past kv_len zeroed, the per-tile
online softmax in base 2 with P rounded to the value dtype before the PV
product — against the JAX
``paged_flash_attention`` in interpret mode, as the JAX package's own tests
run it here, and against the port's plain version. The emulation reads a
copy of the cache with the trash page and every row at or past kv_len set
to NaN, and asserts that no tile it fetches lies on the trash page: a stray
read shows as a NaN.

Tolerances: fp32 inputs with P kept in fp32 (the value dtype), ``atol=1e-5``
— the same math as the reference in another order (a line-for-line port of
``mha_reference`` differs by ~4e-7 on such shapes). fp32 inputs with P
rounded to bf16, as the kernel does: each probability moves by at most
2^-9 of itself while the denominator keeps the unrounded sum, so an output
moves by at most 2^-9 * max|v|; held within that plus 1e-5. bf16 inputs
against the JAX kernel at bf16 (which rounds P at its own running maximum):
per output row ``max|got - want| <= min(2e-2, 2^-6 * max|want|)``, the
card's tolerance (two bf16 ulps). ``tests/test_torch_cuda.py`` holds the
kernel itself against the plain version on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from finchat_tpu.ops.paged_attention import paged_flash_attention as jax_paged  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import gather_kv  # noqa: E402
from finchat_tpu_torch.models.llama import PRESETS  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops import paged_attention as pa  # noqa: E402

torch.set_float32_matmul_precision("highest")

_C = PRESETS["llama3-8b"]
_GROUP = _C.n_heads // _C.n_kv_heads
N_SM = 132  # an H100 SXM
LOG2E = 1.4426950408889634
NAME = "paged_attention_sm90"


def _route(C: int, page_size: int = 128, group: int = _GROUP, max_pages: int = 64,
           kind: str = "paged_attention") -> str:
    """The kernel a paged call of C query tokens a sequence reaches."""
    rows = group * pa.tile_tokens(group, C)
    splits, _pps = pa.decode_splits(C, max_pages)
    return pa.attention_kernel_for(kind, rows, page_size, splits, decode=C == 1)


# --- routing -------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [64, 128, 256])
@pytest.mark.parametrize("C", [16, 40, 100, 512, 2048])
def test_bf16_prefill_reaches_the_hopper_body(C, page_size):
    assert _route(C, page_size) == NAME


@pytest.mark.parametrize("group", [2, 4, 8, 16])
def test_every_group_of_64_rows_reaches_the_hopper_body(group):
    assert _route(512, group=group) == NAME


@pytest.mark.parametrize("page_size", [64, 128, 256])
def test_bf16_decode_keeps_the_decode_body(page_size):
    assert _route(1, page_size) == "paged_attention_decode_sm90"


@pytest.mark.parametrize("C", [2, 8, 15])
def test_rows_under_64_keep_the_older_body(C):
    """Fewer than 16 tokens give Llama-3's group of 4 fewer than 64 rows."""
    assert _route(C) == "paged_attention"


@pytest.mark.parametrize("page_size", [8, 16, 32, 96])
def test_pages_of_part_tiles_keep_the_older_body(page_size):
    for C in (1, 40, 512):
        assert _route(C, page_size) == "paged_attention"


@pytest.mark.parametrize("splits", [2, 16])
def test_split_calls_keep_the_older_body(splits):
    assert pa.attention_kernel_for("paged_attention", 64, 128, splits) == "paged_attention"


@pytest.mark.parametrize("rows", [4, 16, 63, 64])
@pytest.mark.parametrize("page_size", [16, 64, 128])
def test_bf16_ragged_rounds_keep_k3(rows, page_size):
    """A bf16 round of 64-row tiles over pages of whole 64-key tiles is two
    launches — its prefill tiles through the bf16 prefill body's ragged
    entry, its one-token rows through the decode body's — and every other
    bf16 round keeps K3, which is what the single-kernel rule answers."""
    got = pa.ragged_kernels_for("ragged_paged_attention", rows, page_size, _GROUP)
    if rows == 64 and page_size % 64 == 0:
        assert got == ("ragged_paged_attention_sm90", "ragged_paged_attention_decode_sm90")
    else:
        assert got == ("ragged_paged_attention",)
    for decode in (False, True):
        assert pa.attention_kernel_for("ragged_paged_attention", rows, page_size, 1,
                                       decode=decode) == "ragged_paged_attention"


def test_the_hopper_body_is_registered():
    assert NAME in kernels.KERNELS and NAME in kernels.LAUNCHES
    src, sym, argtypes = kernels.KERNELS[NAME]
    assert (src, sym) == ("attention_bf16_sm90.cu", "paged_attention_bf16_sm90")
    assert src in kernels.SOURCES
    # the older body's arguments, then the query tiles a block before scale and stream
    old = kernels.KERNELS["paged_attention"][2]
    assert argtypes == old[:-2] + [kernels._I] + old[-2:]


def test_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 32, 8, 128), dtype=torch.bfloat16)
    kp = torch.zeros((1, 4, 64, 2 * 128), dtype=torch.bfloat16)
    pt = torch.ones((1, 2), dtype=torch.int32)
    i32 = torch.zeros(1, dtype=torch.int32)
    kw = dict(page_size=64, n_kv=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_flash_attention(q, kp, kp, pt, i32, i32 + 32, 0, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.prepare_paged(NAME, q, kp, kp, pt, i32, i32 + 32, 0, route=False, **kw)


# --- query tiles a block ------------------------------------------------------------

_TILE_CALLS = [(B, C, group, n_kv, n_sm)
               for B in (1, 2, 4, 8) for C in (16, 64, 100, 512, 2048)
               for group, n_kv in ((2, 2), (4, 8)) for n_sm in (1, 132)]


@pytest.mark.parametrize("call", _TILE_CALLS, ids=["B{}_C{}_g{}_kv{}_sm{}".format(*c)
                                                   for c in _TILE_CALLS])
def test_query_tiles_cover_every_tile_once(call):
    B, C, group, n_kv, n_sm = call
    tiles = pa.query_tiles_per_block(B, C, group, n_kv, n_sm)
    n_tiles = math.ceil(C / pa.tile_tokens(group, C))
    assert 1 <= tiles <= min(pa.SM90_MAX_TILES, n_tiles)
    blocks = math.ceil(n_tiles / tiles)  # the kernel's grid.x
    covered = [t for j in range(blocks) for t in range(j * tiles, min((j + 1) * tiles, n_tiles))]
    assert covered == list(range(n_tiles))
    assert (blocks - 1) * tiles < n_tiles  # no block without a tile
    # one tile a block only where the one-tile blocks fit in one wave; else
    # as many as the chunk has, up to two, which never takes more waves
    waves = lambda t: math.ceil(B * n_kv * math.ceil(n_tiles / t) / n_sm)  # noqa: E731
    if B * n_kv * n_tiles <= n_sm:
        assert tiles == 1
    else:
        assert tiles == min(pa.SM90_MAX_TILES, n_tiles)
        assert waves(tiles) <= waves(1)


def test_serving_chunk_fills_a_wave_with_two_tiles_a_block():
    """Llama-3-8B's 4 x 512 chunk: two query tiles a block, 512 blocks for
    132 SMs (wherever the chunk sits: the rule does not read q_offset)."""
    B, C = 4, 512
    tiles = pa.query_tiles_per_block(B, C, _GROUP, _C.n_kv_heads, N_SM)
    assert tiles == 2
    assert _route(C) == NAME
    n_tiles = C // pa.tile_tokens(_GROUP, C)
    assert B * _C.n_kv_heads * (n_tiles // tiles) >= N_SM


# Llama-3-8B chunks on 132 SMs and the tiles a block that won when the body
# was timed at one and at two on the card (tools/attention_bf16_diag.py):
# a lone 512-token chunk and the serving 4 x 512 take two, short final
# chunks (their one-tile blocks under a wave) one
_TIMED_CHUNKS = [(1, 512, 2), (4, 512, 2), (1, 64, 1), (1, 128, 1)]


@pytest.mark.parametrize("B,C,want", _TIMED_CHUNKS,
                         ids=[f"{B}x{C}" for B, C, _ in _TIMED_CHUNKS])
def test_query_tiles_at_the_timed_chunks(B, C, want):
    assert pa.query_tiles_per_block(B, C, _GROUP, _C.n_kv_heads, N_SM) == want


def test_query_tiles_refuse_empty_calls():
    with pytest.raises(ValueError):
        pa.query_tiles_per_block(0, 512, 4, 8, 132)


# --- the body's partition, emulated ---------------------------------------------------

def emulate_prefill_body(q, k_all, v_all, page_table, q_offset, kv_len, *, page_size: int,
                         tiles: int, scale: float, p_dtype):
    """The Hopper bf16 body's arithmetic in torch at fp32. ``q`` [B, C, H, D]
    (values of the working dtype, as fp32); ``k_all``/``v_all`` [B, max_pages
    * page_size, Hkv, D] (each sequence's gathered pages). Per sequence b and
    KV head g: query tiles of bq = 64 / group tokens, ``tiles`` consecutive
    ones a block; the block's keys are those of its longest tile (min(max_pages
    * page_size, kv_len, largest position + 1)), walked in 128-key tiles of two
    64-key boxes, a box fetched only if it holds one of those keys and never
    from the trash page; in the last tile V's rows at or past kv_len, and
    those of a box not fetched, are zero. Each query tile walks every tile of
    its block (keys past its rows' positions masked) with an online softmax in
    base 2 over raw scores (running maximum m, p = 2^(s c - m c), c = scale *
    log2 e), P rounded to ``p_dtype`` for the PV product, the denominator
    summed unrounded. Rows without a key are zeros; padding tokens of the
    last query tile are never written (left zero here)."""
    B, C, H, D = q.shape
    n_kv = k_all.shape[2]
    group = H // n_kv
    bq = 64 // group
    n_qt = math.ceil(C / bq)
    span = k_all.shape[1]
    c = scale * LOG2E
    out = torch.zeros_like(q)
    nan = torch.tensor(math.nan)
    for b in range(B):
        kl, qo = int(kv_len[b]), int(q_offset[b])
        for g in range(n_kv):
            for j in range(math.ceil(n_qt / tiles)):
                toks = [list(range(t0, min(t0 + bq, C)))
                        for t0 in ((j * tiles + w) * bq for w in range(tiles))]
                block_keys = max([min(span, kl, qo + tok[-1] + 1) for tok in toks if tok] + [0])
                n_tiles = math.ceil(block_keys / 128)
                # the block's fetches: 64-key boxes holding a key it needs
                boxes = [1 + (block_keys - 128 * t > 64) for t in range(n_tiles)]
                for t, nb in enumerate(boxes):
                    for h in range(nb):
                        page = int(page_table[b, (128 * t + 64 * h) // page_size])
                        assert page != 0, "a trash-page fetch"
                for tok in toks:
                    if not tok:
                        continue
                    rows = q[b, tok, g * group:(g + 1) * group].reshape(-1, D)  # [tok x group, D]
                    pos = torch.tensor([qo + i for i in tok]).repeat_interleave(group)
                    m = torch.full((rows.shape[0],), -1e30)
                    l = torch.zeros(rows.shape[0])
                    acc = torch.zeros(rows.shape[0], D)
                    for t, nb in enumerate(boxes):
                        k0 = 128 * t
                        keys = torch.arange(k0, k0 + 128)
                        fetched = keys < k0 + 64 * nb
                        k_t = torch.full((128, D), math.nan)
                        v_t = torch.full((128, D), math.nan)
                        n_in = min(128, span - k0)
                        k_t[:n_in] = k_all[b, k0:k0 + n_in, g]
                        v_t[:n_in] = v_all[b, k0:k0 + n_in, g]
                        k_t = torch.where(fetched[:, None], k_t, nan)  # an unfetched box: stale
                        v_t = torch.where((fetched & (keys < kl))[:, None], v_t, torch.zeros(()))
                        s = rows @ k_t.T
                        ok = (keys[None, :] < kl) & (keys[None, :] <= pos[:, None])
                        s = torch.where(ok, s, torch.tensor(-math.inf))
                        mn = torch.maximum(m, s.max(-1).values)
                        corr = torch.exp2((m - mn) * c)
                        p = torch.exp2(s * c - (mn * c)[:, None])
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + p.to(p_dtype).float() @ v_t
                        m = mn
                    o = acc / l.clamp(min=1e-30)[:, None]
                    out[b, tok, g * group:(g + 1) * group] = o.reshape(len(tok), group, D)
    return out


# (name, C, q_offsets, kv_lens): B = 3-4, C of 64-192 (C = 100 ends on a
# partial 16-token query tile), and the edges of the body: q_offset 0, a
# 64-key tile edge and +-1, kv_len below q_offset + C (the chunk's padding
# tokens), a sequence with kv_len 0; the page table's tail is the trash
# page in every case
CASES = [
    ("q0", 192, [0, 0, 0], [192, 150, 192]),
    ("tile_edges", 64, [63, 64, 65, 0], [127, 128, 129, 64]),
    ("padding_and_empty", 100, [30, 0, 200], [90, 0, 257]),
]


def _inputs(case, page_size: int, rng):
    _name, C, q_off, kv_len = case
    B, H, n_kv, D = len(kv_len), 8, 2, 128
    mp = math.ceil((max(kv_len) + 64) / page_size) + 1  # a trash-page tail on every row
    n_pages = B * mp + 1
    pt = np.zeros((B, mp), np.int32)
    ids = rng.permutation(np.arange(1, n_pages))
    for b, n in enumerate(kv_len):
        k = math.ceil(n / page_size)
        pt[b, :k] = ids[b * mp:b * mp + k]
    shape = (2, n_pages, page_size, n_kv * D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    return (q, k, v, pt, np.asarray(q_off, np.int32), np.asarray(kv_len, np.int32), n_kv)


def _poisoned(k, v, pt, kv_len, page_size: int, n_kv: int, layer: int):
    """Each sequence's gathered K/V with the trash page and every row at or
    past kv_len set to NaN: only rows the body may read stay finite."""
    k_p, v_p = k.copy(), v.copy()
    k_p[:, 0] = np.nan
    v_p[:, 0] = np.nan
    for b, n in enumerate(kv_len):
        for p in range(pt.shape[1]):
            lo = max(0, n - p * page_size)
            if pt[b, p] and lo < page_size:
                k_p[:, pt[b, p], lo:] = np.nan
                v_p[:, pt[b, p], lo:] = np.nan
    k_all, v_all = gather_kv(torch.from_numpy(k_p), torch.from_numpy(v_p), torch.from_numpy(pt),
                             page_size, layer, n_kv)
    return k_all.float(), v_all.float()


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("page_size", [64, 128])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_partition_matches_jax_fp32(case, page_size, tiles):
    rng = np.random.default_rng(21)
    q, k, v, pt, q_off, kv_len, n_kv = _inputs(case, page_size, rng)
    layer, D = 1, q.shape[-1]
    want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
                                jnp.asarray(q_off), jnp.asarray(kv_len),
                                jnp.asarray([layer], jnp.int32), page_size=page_size, n_kv=n_kv,
                                interpret=True), np.float32)
    plain = pa.paged_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, pt, q_off, kv_len)),
                                   layer, page_size=page_size, n_kv=n_kv).numpy()
    k_all, v_all = _poisoned(k, v, pt, kv_len, page_size, n_kv, layer)
    kw = dict(page_size=page_size, tiles=tiles, scale=D ** -0.5)
    got = emulate_prefill_body(torch.from_numpy(q), k_all, v_all, pt, q_off, kv_len,
                               p_dtype=torch.float32, **kw).numpy()
    live = kv_len > 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[live], plain[live], atol=1e-5, rtol=0)
    assert np.all(got[~live] == 0) and np.all(want[~live] == 0)
    # P rounded to bf16, as the kernel rounds it: within 2^-9 max|v| of the fp32 result
    rounded = emulate_prefill_body(torch.from_numpy(q), k_all, v_all, pt, q_off, kv_len,
                                   p_dtype=torch.bfloat16, **kw).numpy()
    bound = 2.0 ** -9 * np.abs(v).max() + 1e-5
    assert np.abs(rounded - want).max() <= bound
    assert np.abs(rounded - want).max() > 1e-5  # the rounding does happen


def _rows_close(got: np.ndarray, want: np.ndarray) -> float:
    """Worst per-row error over its limit min(2e-2, 2^-6 * max|want row|)."""
    diff = np.abs(got - want).max(-1)
    limit = np.minimum(2e-2, 2.0 ** -6 * np.abs(want).max(-1))
    return float((diff / np.maximum(limit, 1e-30)).max())


@pytest.mark.parametrize("page_size", [64, 128])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_partition_matches_jax_bf16(case, page_size):
    rng = np.random.default_rng(22)
    q, k, v, pt, q_off, kv_len, n_kv = _inputs(case, page_size, rng)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    layer, D = 1, q.shape[-1]
    to_j = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa: E731
    want = np.asarray(jax_paged(to_j(q), to_j(k), to_j(v), jnp.asarray(pt), jnp.asarray(q_off),
                                jnp.asarray(kv_len), jnp.asarray([layer], jnp.int32),
                                page_size=page_size, n_kv=n_kv, interpret=True), np.float32)
    k_all, v_all = _poisoned(k.float().numpy(), v.float().numpy(), pt, kv_len, page_size, n_kv,
                             layer)
    tiles = pa.query_tiles_per_block(len(kv_len), q.shape[1], q.shape[2] // n_kv, n_kv, 1)
    got = emulate_prefill_body(q.float(), k_all, v_all, pt, q_off, kv_len, page_size=page_size,
                               tiles=tiles, scale=D ** -0.5, p_dtype=torch.bfloat16)
    got = got.bfloat16().float().numpy()  # the kernel's bf16 output
    live = kv_len > 0
    assert _rows_close(got[live], want[live]) <= 1.0
    assert np.all(got[~live] == 0) and np.all(want[~live] == 0)
