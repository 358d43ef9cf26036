"""The port's attention and KV-append ops against the JAX package, on CPU.

The same seeded numpy inputs go through the JAX function and its port in
``finchat_tpu_torch/ops``. On CPU tensors ``ops/dispatch.py`` (the engine's
entry to the ops) runs each kernel's plain PyTorch version — the version the
CUDA kernel is held against on the card (``chip_smoke.py``,
tests/test_torch_cuda.py); the kernel wrappers refuse CPU tensors. The JAX kernels run
as the JAX package's own tests run them here: ``interpret=True``.

Tolerances and why:
- fp32, ``atol=1e-5``: the same math in another framework; the only
  difference is summation order (a line-for-line port of ``mha_reference``
  differs by ~4e-7 on these shapes).
- bf16, ``atol=2e-2``: bf16 outputs (8 mantissa bits) of an fp32 softmax;
  rounding points differ between the frameworks.
- the KV append is a copy: bit-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.kv_cache import gather_kv as jax_gather_kv  # noqa: E402
from finchat_tpu.ops.kv_append import paged_kv_append as jax_kv_append  # noqa: E402
from finchat_tpu.ops.paged_attention import paged_flash_attention as jax_paged  # noqa: E402
from finchat_tpu.ops.ragged_paged_attention import (  # noqa: E402
    ragged_flash_attention as jax_ragged,
    ragged_paged_attention_ref as jax_ragged_ref,
)
from finchat_tpu.ops.refs import mha_reference as jax_mha  # noqa: E402
from finchat_tpu_torch.ops.dispatch import (  # noqa: E402
    kv_append,
    paged_attention,
    ragged_paged_attention,
)
from finchat_tpu_torch.ops.kv_append import paged_kv_append  # noqa: E402
from finchat_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention_ref,
    paged_flash_attention,
)
from finchat_tpu_torch.ops.ragged_paged_attention import (  # noqa: E402
    ragged_flash_attention,
    ragged_paged_attention_ref,
    ragged_tiles,
)
from finchat_tpu_torch.ops.refs import mha_reference  # noqa: E402

torch.set_float32_matmul_precision("highest")

L, PS, NUM_PAGES, LAYER = 2, 8, 40, 1
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _t(x: np.ndarray, dtype: str):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _j(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pages(rng, n_kv: int, D: int):
    k = rng.standard_normal((L, NUM_PAGES, PS, n_kv * D)).astype(np.float32)
    v = rng.standard_normal((L, NUM_PAGES, PS, n_kv * D)).astype(np.float32)
    return k, v


def _page_table(rng, B: int, max_pages: int) -> np.ndarray:
    ids = rng.permutation(np.arange(1, NUM_PAGES))[: B * max_pages]
    return ids.reshape(B, max_pages).astype(np.int32)


@pytest.mark.parametrize("H,Hkv,Sq,causal_offset", [(4, 2, 5, 3), (4, 4, 1, 9), (8, 2, 7, 0)])
def test_mha_reference_fp32_matches_jax(H, Hkv, Sq, causal_offset):
    """Line-for-line port of refs.mha_reference, fp32, atol 1e-5."""
    rng = np.random.default_rng(0)
    B, Sk, D = 3, 16, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    q_off = np.asarray([causal_offset, 2, 0], np.int32)
    kv_len = np.asarray([Sk, 10, causal_offset + Sq], np.int32)
    got = mha_reference(_t(q, "float32"), _t(k, "float32"), _t(v, "float32"),
                        q_offset=torch.from_numpy(q_off), kv_len=torch.from_numpy(kv_len))
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


# (name, C, q_offset per seq, kv_len per seq, H, Hkv)
PAGED_CASES = [
    ("decode", 1, [5, 17, 30, 0], [6, 18, 31, 0], 4, 2),
    ("prefill_offset", 6, [8, 0, 19], [14, 6, 23], 4, 2),
    ("gqa_group2_kv0", 4, [0, 3, 12], [4, 0, 16], 4, 2),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_attention_plain_matches_jax(case, dtype):
    """K1 plain version vs the JAX kernel (interpret) on rows with keys, and
    vs the JAX reference branch (gather_kv + mha_reference) on every row —
    including kv_len == 0 rows, where both references average the gathered
    trash and the kernels write zeros."""
    _name, C, q_off, kv_len, H, Hkv = case
    rng = np.random.default_rng(1)
    D, B, max_pages = 16, len(q_off), 5
    k_np, v_np = _pages(rng, Hkv, D)
    pt = _page_table(rng, B, max_pages)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    q_off = np.asarray(q_off, np.int32)
    kv_len = np.asarray(kv_len, np.int32)

    got = paged_attention(
        _t(q, dtype), _t(k_np, dtype), _t(v_np, dtype), torch.from_numpy(pt),
        torch.from_numpy(q_off), torch.from_numpy(kv_len), LAYER, page_size=PS, n_kv=Hkv)
    kj, vj = _j(k_np, dtype), _j(v_np, dtype)
    want_kernel = jax_paged(
        _j(q, dtype), kj, vj, jnp.asarray(pt), jnp.asarray(q_off), jnp.asarray(kv_len),
        jnp.asarray([LAYER], jnp.int32), page_size=PS, n_kv=Hkv, interpret=True)
    k_all, v_all = jax_gather_kv(kj, vj, jnp.asarray(pt), PS, LAYER, Hkv)
    want_ref = jax_mha(_j(q, dtype), k_all, v_all, causal=True,
                       q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len))
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=tol, rtol=0)
    live = kv_len > 0
    np.testing.assert_allclose(_np(got)[live], _np(want_kernel)[live], atol=tol, rtol=0)
    # the JAX kernel writes zeros where there are no keys — as the CUDA kernel does
    assert np.all(_np(want_kernel)[~live] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_append_plain_bit_exact_vs_jax(dtype):
    """K2 plain version vs the JAX append kernel (interpret): bit-exact,
    including an n_valid == 0 lane whose write lands on trash page 0."""
    rng = np.random.default_rng(2)
    Hkv, D, B, max_pages = 2, 16, 5, 4
    HD = Hkv * D
    k_np, v_np = _pages(rng, Hkv, D)
    pt = _page_table(rng, B, max_pages)
    pos = np.asarray([0, 7, 13, 31, 250], np.int32)  # lane 4: invalid, pos past the row
    n_valid = np.asarray([1, 1, 1, 1, 0], np.int32)
    kv_new = rng.standard_normal((B, 1, 2 * HD)).astype(np.float32)

    kt, vt = _t(k_np, dtype), _t(v_np, dtype)
    kv_append(_t(kv_new, dtype), kt, vt, torch.from_numpy(pt), torch.from_numpy(pos),
              torch.from_numpy(n_valid), LAYER, page_size=PS)
    kj, vj = jax_kv_append(
        _j(kv_new, dtype), _j(k_np, dtype), _j(v_np, dtype), jnp.asarray(pt),
        jnp.asarray(pos), jnp.asarray(n_valid), jnp.asarray([LAYER], jnp.int32),
        page_size=PS, interpret=True)
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_array_equal(_np(vt), _np(vj))
    # the invalid lane's row landed in the trash page, at pos % page_size
    np.testing.assert_array_equal(_np(kt)[LAYER, 0, 250 % PS], _np(_t(kv_new, dtype))[4, 0, :HD])


def _ragged_inputs(rng, rows, Hkv, D, T_pad, H, gaps=None):
    """rows = [(q_len, pos0, kv_len)] -> packed q, descriptors, pages."""
    k_np, v_np = _pages(rng, Hkv, D)
    R, max_pages = len(rows), 6
    pt = _page_table(rng, R, max_pages)
    tok_row, tok_pos = [], []
    for r, (q_len, pos0, _kv) in enumerate(rows):
        tok_row += [r] * q_len
        tok_pos += list(range(pos0, pos0 + q_len))
    n_pad = T_pad - len(tok_row)
    tok_row += [R] * n_pad
    tok_pos += [0] * n_pad
    q = rng.standard_normal((T_pad, H, D)).astype(np.float32)
    kv_len = np.asarray([kv for _q, _p, kv in rows], np.int32)
    gap = None if gaps is None else np.asarray(gaps, np.int32)
    return (q, k_np, v_np, pt, np.asarray(tok_row, np.int32), np.asarray(tok_pos, np.int32),
            kv_len, gap)


# rows (q_len, pos0, kv_len), padded length, per-row kv_gap
RAGGED_CASES = [
    ("chunk_decode_padding", [(9, 4, 13), (1, 20, 21), (1, 7, 8), (1, 33, 34)], 16, None),
    ("gap_row", [(6, 40, 46), (1, 12, 13)], 12, [16, 0]),
    ("two_chunks", [(5, 0, 5), (7, 16, 23)], 12, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RAGGED_CASES, ids=[c[0] for c in RAGGED_CASES])
def test_ragged_attention_plain_matches_jax(case, dtype):
    """K3 plain version vs the JAX ragged kernel (interpret) on real tokens,
    and vs ragged_paged_attention_ref on every token (padding included):
    a chunk row beside decode rows with padding, and a kv_gap row (its
    kv_len and positions are absolute; the wrapper compacts them)."""
    _name, rows, T, gaps = case
    H, Hkv, D = 4, 2, 16
    rng = np.random.default_rng(3)
    q, k_np, v_np, pt, tok_row, tok_pos, kv_len, gap = _ragged_inputs(rng, rows, Hkv, D, T, H, gaps)
    gap_t = None if gap is None else torch.from_numpy(gap)
    gap_j = None if gap is None else jnp.asarray(gap)
    got = ragged_paged_attention(
        _t(q, dtype), _t(k_np, dtype), _t(v_np, dtype), torch.from_numpy(pt),
        torch.from_numpy(tok_row), torch.from_numpy(tok_pos), torch.from_numpy(kv_len),
        LAYER, page_size=PS, n_kv=Hkv, kv_gap=gap_t)
    args = (_j(q, dtype), _j(k_np, dtype), _j(v_np, dtype), jnp.asarray(pt),
            jnp.asarray(tok_row), jnp.asarray(tok_pos), jnp.asarray(kv_len),
            jnp.asarray([LAYER], jnp.int32))
    want_kernel = jax_ragged(*args, page_size=PS, n_kv=Hkv, interpret=True, kv_gap=gap_j)
    want_ref = jax_ragged_ref(*args, page_size=PS, n_kv=Hkv, kv_gap=gap_j)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=tol, rtol=0)
    real = tok_row < len(rows)
    np.testing.assert_allclose(_np(got)[real], _np(want_kernel)[real], atol=tol, rtol=0)


@pytest.mark.parametrize("bq", [1, 4, 16])
def test_ragged_tiles_cover_rows_and_padding(bq):
    """The kernel's tile descriptors: every real token is in exactly one
    tile of its own row, tiles never straddle rows, and the spare tiles
    cover the padding suffix exactly."""
    rng = np.random.default_rng(4)
    for trial in range(20):
        R = int(rng.integers(1, 9))
        lens = rng.integers(0, 40, size=R)
        T_real = int(lens.sum())
        T = T_real + int(rng.integers(0, 30))
        if T == 0:
            continue
        tok_row = np.concatenate([np.repeat(np.arange(R), lens), np.full(T - T_real, R)])
        tr, ts, tl, NT, qs, ql = ragged_tiles(torch.from_numpy(tok_row.astype(np.int32)), R, bq)
        tr, ts, tl = tr.numpy(), ts.numpy(), tl.numpy()
        assert NT == -(-T // bq) + R
        # each row's first packed token and token count
        assert ql.numpy().tolist() == lens.tolist()
        assert qs.numpy().tolist() == (np.cumsum(lens) - lens).tolist()
        cover = np.zeros(T, np.int32)
        for j in range(NT):
            for i in range(ts[j], ts[j] + tl[j]):
                cover[i] += 1
                assert tok_row[i] == tr[j], (trial, j, i)
            assert 0 <= tl[j] <= bq
        assert np.all(cover == 1), (trial, cover)


def test_ragged_tile_emulation_matches_plain():
    """Attention computed tile by tile from ``ragged_tiles`` (the kernel's
    decomposition, emulated with the plain math) equals the plain version
    on every real token."""
    H, Hkv, D = 4, 2, 16
    rng = np.random.default_rng(5)
    rows = [(11, 3, 14), (1, 9, 10), (4, 20, 24), (1, 0, 1)]
    q, k_np, v_np, pt, tok_row, tok_pos, kv_len, _gap = _ragged_inputs(rng, rows, Hkv, D, 24, H)
    args = (_t(q, "float32"), _t(k_np, "float32"), _t(v_np, "float32"), torch.from_numpy(pt),
            torch.from_numpy(tok_row), torch.from_numpy(tok_pos), torch.from_numpy(kv_len))
    want = ragged_paged_attention_ref(*args, LAYER, page_size=PS, n_kv=Hkv)
    tr, ts, tl, NT, _q_start, _q_len = ragged_tiles(torch.from_numpy(tok_row), len(rows), 4)
    got = torch.zeros_like(want)
    for j in range(NT):
        r, s, n = int(tr[j]), int(ts[j]), int(tl[j])
        if r >= len(rows) or n == 0:
            continue
        got[s:s + n] = paged_attention_ref(
            args[0][None, s:s + n], args[1], args[2], args[3][r:r + 1],
            args[5][s:s + 1], args[6][r:r + 1], LAYER, page_size=PS, n_kv=Hkv)[0]
    real = tok_row < len(rows)
    np.testing.assert_allclose(got.numpy()[real], want.numpy()[real], atol=1e-5, rtol=0)



def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version itself: handed CPU
    tensors it raises (ops/dispatch.py is what routes them to the plain
    version), and it counts no launch."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    bf = dict(dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)
    pages = torch.zeros((1, 4, PS, 2 * 128), **bf)
    one = torch.ones(1, **i32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_attention(torch.zeros((1, 1, 4, 128), **bf), pages, pages,
                              torch.ones((1, 2), **i32), one - 1, one, 0, page_size=PS, n_kv=2)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kv_append(torch.zeros((1, 1, 4 * 128), **bf), pages, pages,
                        torch.ones((1, 2), **i32), one - 1, one, 0, page_size=PS)
    with pytest.raises(ValueError, match="CUDA"):
        ragged_flash_attention(torch.zeros((1, 4, 128), **bf), pages, pages,
                               torch.ones((1, 2), **i32), one - 1, one - 1, one, 0,
                               page_size=PS, n_kv=2)
    assert LAUNCHES == before
