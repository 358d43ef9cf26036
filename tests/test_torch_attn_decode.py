"""The Hopper decode attention body (``csrc/attention_decode_sm90.cu``) on the CPU.

Two things are held here without a card. First, the pure functions around
it: ``attention_kernel_for`` sends every paged decode call (one query token
a sequence, a group of at most 16 query heads) over pages of whole 64-key
tiles to the decode body, over a bf16 or an int8 cache, and every other call
to the kernel it reached before; ``decode_split`` cuts each sequence's pages
into splits that cover the page-table row exactly once, sized for the card's
SMs. Second, the body's arithmetic: a torch emulation of its partition at
fp32 — the splits of ``decode_split``, each split's 64-key tiles, warp w's 16
keys of every tile with its own online softmax in base 2, the merge of the 4
warps, then the merge of the live splits (or the one split's own output) —
against the JAX ``paged_flash_attention`` / ``paged_flash_attention_q8`` in
interpret mode, as the JAX package's own tests run them here, and against
the port's plain versions.

Tolerance: fp32 throughout, ``atol=1e-5``: the same math as the reference in
another order (the partition changes only where the sums are taken; a
line-for-line port of ``mha_reference`` differs by ~4e-7 on such shapes).
The int8 cache is dequantized to fp32 on both sides, as the plain version
does at the query's dtype. Rows without a key are zeros in the emulation and
in the JAX kernel. ``tests/test_torch_cuda.py`` holds the kernel itself
against the plain versions on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from finchat_tpu.ops.paged_attention import paged_flash_attention as jax_paged  # noqa: E402
from finchat_tpu.ops.paged_attention import (  # noqa: E402
    paged_flash_attention_q8 as jax_paged_q8,
)
from finchat_tpu_torch.engine.kv_cache import gather_kv, gather_kv_q8, scale_rows  # noqa: E402
from finchat_tpu_torch.models.llama import PRESETS  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops import paged_attention as pa  # noqa: E402

torch.set_float32_matmul_precision("highest")

_C = PRESETS["llama3-8b"]
N_SM = 132  # an H100 SXM
LOG2E = 1.4426950408889634
KINDS = ("paged_attention", "paged_attention_q8")


# --- routing -------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("page_size", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_decode_reaches_the_decode_body(kind, page_size, group):
    for splits in (1, 16):
        assert pa.attention_kernel_for(kind, group, page_size, splits, decode=True) == \
            f"{kind}_decode_sm90"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("page_size", [8, 16, 32, 96])
def test_decode_over_pages_of_part_tiles_keeps_the_older_body(kind, page_size):
    assert pa.attention_kernel_for(kind, 4, page_size, 4, decode=True) == kind


@pytest.mark.parametrize("kind", KINDS)
def test_decode_of_groups_past_16_rows_keeps_the_older_body(kind):
    assert pa.attention_kernel_for(kind, 32, 128, 4, decode=True) == kind


@pytest.mark.parametrize("kind", ["ragged_paged_attention", "ragged_paged_attention_q8"])
@pytest.mark.parametrize("rows", [4, 64])
def test_ragged_calls_never_reach_the_decode_body(kind, rows):
    want = f"{kind}_sm90" if kind.endswith("_q8") and rows == 64 else kind
    assert pa.attention_kernel_for(kind, rows, 128, 1, decode=True) == want


@pytest.mark.parametrize("C", [1, 2, 16, 512])
def test_serving_shapes_route(C):
    """The llama3-8b engine's calls at page 128: decode to the decode body
    on both caches, prefill chunks to the Hopper prefill body of their cache
    (bf16 or int8) once a block holds 64 rows, and to the older body below
    that."""
    group = _C.n_heads // _C.n_kv_heads
    rows = group * pa.tile_tokens(group, C)
    splits = pa.decode_splits(C, 64)[0]
    got = {kind: pa.attention_kernel_for(kind, rows, 128, splits, decode=C == 1)
           for kind in KINDS}
    if C == 1:
        assert got == {kind: f"{kind}_decode_sm90" for kind in KINDS}
    else:
        assert got == {kind: f"{kind}_sm90" if rows == 64 else kind for kind in KINDS}


def test_decode_bodies_are_registered():
    for kind in KINDS:
        name = f"{kind}_decode_sm90"
        assert name in kernels.KERNELS and name in kernels.LAUNCHES
        assert kernels.KERNELS[name][0] == "attention_decode_sm90.cu"
        # the decode body takes the older body's arguments
        assert kernels.KERNELS[name][2] == kernels.KERNELS[kind][2]
    assert "attention_decode_sm90.cu" in kernels.SOURCES


def test_decode_wrappers_refuse_cpu_tensors():
    H, n_kv, ps = 8, 2, 64
    q = torch.zeros((2, 1, H, 128), dtype=torch.bfloat16)
    kp = torch.zeros((1, 6, ps, n_kv * 128), dtype=torch.bfloat16)
    k8 = kp.to(torch.int8)
    sc = torch.ones((1, 6, scale_rows(n_kv), ps))
    pt = torch.ones((2, 3), dtype=torch.int32)
    i32 = torch.ones(2, dtype=torch.int32)
    kw = dict(page_size=ps, n_kv=n_kv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_flash_attention(q, kp, kp, pt, i32, i32, 0, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_flash_attention_q8(q, k8, k8, sc, sc, pt, i32, i32, 0, **kw)
    for name, cache in (("paged_attention_decode_sm90", {}),
                        ("paged_attention_q8_decode_sm90", dict(k_scales=sc, v_scales=sc))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            pa.prepare_paged(name, q, kp, kp, pt, i32, i32, 0, **kw, **cache, route=False)


# --- the split -------------------------------------------------------------------

_SPLIT_CALLS = [(B, n_kv, mp, ps, n_sm)
                for B, n_kv in ((1, 1), (3, 2), (8, 8), (64, 8), (256, 8))
                for mp, ps in ((1, 128), (5, 64), (12, 64), (64, 128), (128, 128), (40, 16))
                for n_sm in (1, 8, 132)]


@pytest.mark.parametrize("call", _SPLIT_CALLS, ids=["B{}_kv{}_mp{}_ps{}_sm{}".format(*c)
                                                    for c in _SPLIT_CALLS])
def test_split_covers_every_page_once(call):
    B, n_kv, mp, ps, n_sm = call
    splits, pps = pa.decode_split(B, n_kv, mp, ps, n_sm)
    assert 1 <= pps <= mp and splits >= 1
    pages = [p for s in range(splits) for p in range(s * pps, min((s + 1) * pps, mp))]
    assert pages == list(range(mp))  # every page once, in order, none past max_pages
    assert (splits - 1) * pps < mp  # no split without a page
    # at least DECODE_MIN_TILES tiles a split unless the row is shorter
    assert pps * ps >= min(mp * ps, pa.DECODE_MIN_TILES * pa.DECODE_KEYS)
    # no more pages a split than the aim asks (DECODE_BLOCKS_PER_SM blocks an
    # SM were every row full), unless a split is at its least
    want = math.ceil(pa.DECODE_BLOCKS_PER_SM * n_sm / (B * n_kv))
    least = math.ceil(pa.DECODE_MIN_TILES * pa.DECODE_KEYS / ps)
    assert pps <= max(least, math.ceil(mp / want))


def _live_blocks(kv_lens, n_kv: int, mp: int, ps: int, n_sm: int) -> int:
    _splits, pps = pa.decode_split(len(kv_lens), n_kv, mp, ps, n_sm)
    return sum(n_kv * max(1, -(-n // (pps * ps))) for n in kv_lens)


@pytest.mark.parametrize("case", ["b64_1to4k", "b8_5236"])
def test_split_gives_two_waves_at_the_serving_shapes(case):
    """Blocks holding a live key, Llama-3-8B at page 128 and 64 pages a
    sequence: at least two waves on 132 SMs."""
    lens = (list(np.random.default_rng(3).integers(1, 4097, 64)) if case == "b64_1to4k"
            else [5236] * 8)
    assert _live_blocks(lens, _C.n_kv_heads, 64, 128, N_SM) >= 2 * N_SM


def test_split_refuses_empty_calls():
    with pytest.raises(ValueError):
        pa.decode_split(0, 8, 64, 128, 132)


# --- the body's partition, emulated at fp32 ------------------------------------

def emulate_decode_body(q, k_all, v_all, q_offset, kv_len, *, page_size: int, max_pages: int,
                        splits: int, pps: int, scale: float):
    """The decode body's arithmetic in torch at fp32. ``q`` [B, H, D];
    ``k_all``/``v_all`` [B, max_pages * page_size, Hkv, D] (each sequence's
    gathered pages). Per sequence b: its keys are those below kv_len, at
    most its own position and inside its row; split s takes keys [s * span,
    (s + 1) * span) of them (span = pps * page_size) in 64-key tiles, warp w
    keys [16w, 16w + 16) of every tile, each warp an online softmax in base
    2 over its keys; the block merges its 4 warps, and a sequence whose keys
    span several splits merges its live splits' (m, l, acc)."""
    B, H, D = q.shape
    group = H // k_all.shape[2]
    span = pps * page_size
    c = scale * LOG2E
    out = torch.zeros_like(q)
    for b in range(B):
        keys = max(0, min(int(kv_len[b]), int(q_offset[b]) + 1, max_pages * page_size))
        live = max(1, -(-keys // span))
        assert live <= splits
        k_h = k_all[b].repeat_interleave(group, dim=1)  # [S, H, D]
        v_h = v_all[b].repeat_interleave(group, dim=1)
        parts = []
        for s in range(live):
            lo, hi = s * span, min(keys, (s + 1) * span)
            warps = []
            for w in range(4):
                m = torch.full((H,), -1e30)
                l = torch.zeros(H)
                acc = torch.zeros(H, D)
                for k0 in range(lo, hi, 64):
                    first, end = k0 + 16 * w, min(k0 + 16 * w + 16, hi)
                    if first >= end:
                        continue
                    idx = torch.arange(first, end)
                    sc = torch.einsum("hd,nhd->hn", q[b], k_h[idx]) * c
                    mn = torch.maximum(m, sc.max(-1).values)
                    corr = torch.exp2(m - mn)
                    p = torch.exp2(sc - mn[:, None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + torch.einsum("hn,nhd->hd", p, v_h[idx])
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
        out[b] = a_tot / l_tot.clamp(min=1e-30)[:, None]
    return out


def _contexts(case: str, span: int) -> list[int]:
    if case == "tile_edges":
        return [0, 1, 63, 64, 65]
    return [span - 1, span, span + 1, 2 * span + 3, 17]


# (page_size, max_pages): 640 keys a row, two 256-key splits and a part
_GEOMETRY = [(16, 40), (64, 10)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("contexts", ["tile_edges", "split_edges"])
@pytest.mark.parametrize("geometry", _GEOMETRY, ids=[f"ps{p}" for p, _ in _GEOMETRY])
def test_emulated_partition_matches_jax(geometry, contexts, q8):
    ps, mp = geometry
    B, H, n_kv, D = 5, 8, 2, 128
    splits, pps = pa.decode_split(B, n_kv, mp, ps, N_SM)
    span = pps * ps
    assert splits > 1 and span == 256  # the cases cross split edges
    kv_len = np.asarray(_contexts(contexts, span), np.int32)
    q_offset = np.maximum(kv_len - 1, 0).astype(np.int32)
    q_offset[2] = min(q_offset[2], 40)  # a query behind its context (the causal bound)
    rng = np.random.default_rng(17 if q8 else 16)
    n_pages = B * mp + 1
    pt = np.zeros((B, mp), np.int32)  # the tail of every row is the trash page 0
    ids = rng.permutation(np.arange(1, n_pages))
    for b, n in enumerate(kv_len):
        pt[b, :-(-n // ps)] = ids[b * mp:b * mp + -(-n // ps)]
    shape = (2, n_pages, ps, n_kv * D)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    layer = 1
    if q8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        sshape = (2, n_pages, scale_rows(n_kv), ps)
        ks = (rng.random(sshape) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random(sshape) * 0.02 + 1e-3).astype(np.float32)
        k_all, v_all = gather_kv_q8(*(torch.from_numpy(a) for a in (k, v, ks, vs)),
                                    torch.from_numpy(pt), ps, layer, n_kv, dtype=torch.float32)
        want = jax_paged_q8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
                            jnp.asarray(vs), jnp.asarray(pt), jnp.asarray(q_offset),
                            jnp.asarray(kv_len), jnp.asarray([layer], jnp.int32), page_size=ps,
                            n_kv=n_kv, interpret=True)
        plain = pa.paged_attention_q8_ref(
            torch.from_numpy(q), *(torch.from_numpy(a) for a in (k, v, ks, vs, pt, q_offset,
                                                                  kv_len)),
            layer, page_size=ps, n_kv=n_kv)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        k_all, v_all = gather_kv(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pt),
                                 ps, layer, n_kv)
        want = jax_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
                         jnp.asarray(q_offset), jnp.asarray(kv_len),
                         jnp.asarray([layer], jnp.int32), page_size=ps, n_kv=n_kv,
                         interpret=True)
        plain = pa.paged_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, pt, q_offset,
                                                                        kv_len)),
                                       layer, page_size=ps, n_kv=n_kv)
    got = emulate_decode_body(torch.from_numpy(q[:, 0]), k_all.float(), v_all.float(), q_offset,
                              kv_len, page_size=ps, max_pages=mp, splits=splits, pps=pps,
                              scale=D ** -0.5)
    want = np.asarray(want, np.float32)[:, 0]
    live = kv_len > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[live], plain.numpy()[live, 0], atol=1e-5, rtol=0)
    assert np.all(got.numpy()[~live] == 0) and np.all(want[~live] == 0)
