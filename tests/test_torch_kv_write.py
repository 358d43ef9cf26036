"""The KV-row writer's plan and plain version against the JAX package, on CPU.

The writer (``ops/kv_append.py``: ``plan_kv_rows``, ``plan_kv_rows_ragged``,
``paged_kv_write``; the kernel ``csrc/kv_write_sm90.cu``) takes every cache
write of a serve: decode rows, prefill chunks and ragged rounds. Here:

- the plan's rows against the JAX package's own row math: its
  ``scatter_kv_chunk`` writes each token's id, and each id must sit at the
  row the plan names (padding lanes in the trash page 0 at ``pos %
  page_size``); the ragged plan, built with one table lookup a token,
  against the chunk plan over the gathered ``[T, max_pages]`` table;
- the plain ``kv_write`` against the JAX ``scatter_kv_chunk`` /
  ``scatter_kv_chunk_q8`` and against the JAX append kernels in interpret
  mode applied once per chunk position, as the JAX engine's
  ``inplace_append`` does;
- the engine's CPU prefill chunk, decode step and ragged round writing the
  same caches as the writes they replaced (the fused ``kv_append`` at
  decode, the chunk scatter elsewhere);
- the routing rule and the refusals of the card's wrapper.

Tolerances: everything bitwise, the trash page 0 excepted wherever several
padding lanes write one of its rows (the last writer is unspecified in both
packages; nothing reads that page). One exception, stated where it is used:
the JAX int8 append kernel's scales, jitted, within one fp32 ulp (XLA turns
its ``amax / 127.0`` into a multiply by the reciprocal; the true division is
the JAX package's definition, which the port keeps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine import kv_cache as jkv  # noqa: E402
from finchat_tpu.ops.kv_append import paged_kv_append as jax_append  # noqa: E402
from finchat_tpu.ops.kv_append import paged_kv_append_q8 as jax_append_q8  # noqa: E402
from finchat_tpu_torch.engine import engine as teng  # noqa: E402
from finchat_tpu_torch.engine import kv_cache as tkv  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops.dispatch import (  # noqa: E402
    kv_append,
    kv_write,
    paged_attention,
    ragged_paged_attention,
)
from finchat_tpu_torch.ops.kv_append import (  # noqa: E402
    append_kernel_for,
    paged_kv_write,
    plan_kv_rows,
    plan_kv_rows_ragged,
)
from finchat_tpu_torch.ops.ragged_paged_attention import plan_ragged  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402

I32 = torch.int32
L, LAYER = 2, 1


def _i32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int32))


def _lanes(C: int, PS: int, MP: int):
    """Four sequences' chunk of C tokens: one whose chunk crosses a page
    boundary, one half padding, one with n_valid 0 whose positions lie past
    its table row, one with a single real token at a page's last row."""
    start = np.asarray([PS - 3, 2 * PS + 1, MP * PS + 7, 3 * PS - 1], np.int32)
    n_valid = np.asarray([C, C // 2, 0, 1], np.int32)
    assert all(s + n <= MP * PS for s, n in zip(start, n_valid) if n)
    return start, n_valid


def _table(rng, B: int, MP: int) -> np.ndarray:
    return rng.permutation(np.arange(1, B * MP + 1))[: B * MP].reshape(B, MP).astype(np.int32)


@pytest.mark.parametrize("PS", [16, 128])
@pytest.mark.parametrize("C", [1, 5, 64])
def test_plan_kv_rows_matches_jax_row_math(C, PS):
    rng = np.random.default_rng(C * 1000 + PS)
    B = 4
    MP = -(-(2 * PS + 64) // PS) + 1  # every real position of _lanes inside the row
    P = B * MP + 1
    pt = _table(rng, B, MP)
    start, n_valid = _lanes(C, PS, MP)
    plan = plan_kv_rows(_i32(pt), _i32(start), _i32(n_valid), C, PS)
    rows = plan.rows.numpy()
    assert plan.rows.dtype == I32 and rows.shape == (B * C,) and plan.chunk == C
    # the JAX scatter writes token t's id t + 1 into its row
    ids = np.arange(1, B * C + 1, dtype=np.float32).reshape(B, C, 1, 1)
    new = jnp.asarray(np.broadcast_to(ids, (B, C, 1, 8)))
    zeros = jnp.zeros((1, P, PS, 8), jnp.float32)
    written, _ = jkv.scatter_kv_chunk(zeros, zeros, new, new, jnp.asarray(pt),
                                      jnp.asarray(start), jnp.asarray(n_valid), PS, 0)
    landed = np.asarray(written)[0, :, :, 0].reshape(-1)  # flat row -> id
    pos = start[:, None] + np.arange(C)[None, :]
    valid = (np.arange(C)[None, :] < n_valid[:, None]).reshape(-1)
    for t, (row, ok, p) in enumerate(zip(rows, valid, pos.reshape(-1))):
        if ok:
            assert row >= PS and landed[row] == t + 1, (t, row)
        else:  # the trash page, at pos % page_size; JAX's last writer is one of its lanes
            assert row == p % PS
            assert rows[int(landed[row]) - 1] == row and not valid[int(landed[row]) - 1]
    written_rows = np.nonzero(landed[PS:])[0] + PS
    np.testing.assert_array_equal(np.sort(written_rows), np.sort(rows[valid]))
    # ... and the port's chunk scatter computes the same rows
    phys, off = tkv._chunk_rows(_i32(pt), _i32(start), _i32(n_valid), C, PS)
    np.testing.assert_array_equal(rows, (phys * PS + off).numpy())


# a round: (q_len, first position) per row, on R table rows (the rest padding)
ROUND = [(9, 20), (1, 40), (5, 0), (1, 3)]


@pytest.mark.parametrize("PS", [16, 128])
def test_ragged_rows_without_the_gather_equal_the_gathered(PS):
    """The ragged plan looks each token's page up in its row's list; the
    chunk plan over ``page_rows[tok_row]`` (the [T, max_pages] gather the
    engine did before) gives the same rows, padding tokens in the trash
    page, and so does the ragged plan's compacted positions."""
    rng = np.random.default_rng(PS)
    R, MP, T = 6, 4, 24
    page_rows = _table(rng, R, MP)
    tok_row, tok_pos = [], []
    for r, (q_len, p0) in enumerate(ROUND):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row = _i32(tok_row + [R] * (T - n_real))
    tok_pos = _i32(tok_pos + [0] * (T - n_real))
    plan = plan_kv_rows_ragged(_i32(page_rows), tok_row, tok_pos, PS)
    valid = (tok_row < R).to(I32)
    gathered = _i32(page_rows)[tok_row.long().clamp(max=R - 1)]
    want = plan_kv_rows(gathered, tok_pos, valid, 1, PS)
    torch.testing.assert_close(plan.rows, want.rows, rtol=0, atol=0)
    assert plan.rows[n_real:].tolist() == [0] * (T - n_real)
    torch.testing.assert_close(plan.n_valid, valid, rtol=0, atol=0)
    kv_len = _i32([p0 + q for q, p0 in ROUND] + [0, 0])
    compact = plan_ragged(tok_row, tok_pos, kv_len, group=2, kv_gap=_i32([0] * R))
    again = plan_kv_rows_ragged(_i32(page_rows), tok_row, compact.tok_pos, PS)
    torch.testing.assert_close(again.rows, plan.rows, rtol=0, atol=0)


def test_plan_refuses_index_tensors_it_does_not_take():
    pt, one = _i32([[1, 2]]), _i32([0])
    with pytest.raises(ValueError, match="page_table must be an int32"):
        plan_kv_rows(pt.long(), one, one, 1, 16)
    with pytest.raises(ValueError, match="n_valid must be an int32"):
        plan_kv_rows(pt, one, one[None], 1, 16)
    with pytest.raises(ValueError, match="start_pos .* must have the table's 1 sequences"):
        plan_kv_rows(pt, _i32([0, 0]), _i32([0, 0]), 1, 16)
    with pytest.raises(ValueError, match="tok_pos"):
        plan_kv_rows_ragged(pt, one, _i32([0, 1]), 16)


def _cache(rng, cache: str, n_kv: int, D: int, P: int, PS: int):
    shape = (L, P, PS, n_kv * D)
    if cache == "int8":
        sshape = (L, P, tkv.scale_rows(n_kv), PS)
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                (rng.random(sshape) * 0.02 + 1e-3).astype(np.float32),
                (rng.random(sshape) * 0.02 + 1e-3).astype(np.float32))
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), None, None)


def _torch_cache(arrays, cache: str):
    dtype = torch.bfloat16 if cache == "bfloat16" else None
    out = []
    for a in arrays:
        t = None if a is None else torch.from_numpy(a.copy())
        out.append(t.to(dtype) if t is not None and dtype and t.is_floating_point() else t)
    return out


def _jax_cache(arrays, cache: str):
    dtype = jnp.bfloat16 if cache == "bfloat16" else None
    return [None if a is None else (jnp.asarray(a, dtype) if dtype else jnp.asarray(a))
            for a in arrays]


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


# (cache, K/V rows' dtype)
WRITES = [("float32", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32"),
          ("int8", "bfloat16")]


@pytest.mark.parametrize("cache,rows_dtype", WRITES)
def test_kv_write_plain_matches_jax_scatter(cache, rows_dtype):
    """A 5-token chunk of three sequences (padding lanes, a chunk across a
    page boundary) through the plain ``kv_write`` against the JAX scatter:
    pages, and scale planes for the int8 cache, bit-exact but the trash
    page."""
    rng = np.random.default_rng(3)
    n_kv, D, B, C, MP, PS, P = 2, 16, 3, 5, 4, 8, 16
    arrays = _cache(rng, cache, n_kv, D, P, PS)
    pt = _table(rng, B, MP)
    start, n_valid = np.asarray([0, 6, 13], np.int32), np.asarray([5, 2, 5], np.int32)
    k_new = rng.standard_normal((B, C, n_kv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, C, n_kv, D)).astype(np.float32)
    got = _torch_cache(arrays, cache)
    tdt = getattr(torch, rows_dtype)
    plan = plan_kv_rows(_i32(pt), _i32(start), _i32(n_valid), C, PS)
    kv_write(plan, torch.from_numpy(k_new).to(tdt).reshape(B * C, -1),
             torch.from_numpy(v_new).to(tdt).reshape(B * C, -1), got[0], got[1], LAYER,
             n_kv=n_kv, k_scales=got[2], v_scales=got[3])
    jdt = getattr(jnp, rows_dtype)
    jk, jv = jnp.asarray(k_new, jdt), jnp.asarray(v_new, jdt)
    j = _jax_cache(arrays, cache)
    idx = (jnp.asarray(pt), jnp.asarray(start), jnp.asarray(n_valid), PS, LAYER)
    if cache == "int8":
        want = jkv.scatter_kv_chunk_q8(*j, jk, jv, *idx, n_kv)
    else:
        want = jkv.scatter_kv_chunk(j[0], j[1], jk, jv, *idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_as_np(g)[:, 1:], _as_np(w)[:, 1:])
    assert not np.array_equal(_as_np(got[0]), _as_np(_torch_cache(arrays, cache)[0]))


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_kv_write_matches_jax_append_kernel_per_position(cache):
    """A 3-token chunk written once against the JAX append kernel
    (interpret) run once per chunk position, token i valid iff i <
    n_valid, as the JAX engine's ``inplace_append`` does: pages bit-exact
    but the trash page, the int8 kernel's scales within one ulp (see the
    module note)."""
    rng = np.random.default_rng(5)
    n_kv, D, B, C, MP, PS, P = 2, 16, 4, 3, 4, 8, 18
    HD = n_kv * D
    arrays = _cache(rng, cache, n_kv, D, P, PS)
    pt = _table(rng, B, MP)
    start = np.asarray([6, 0, 21, 30], np.int32)  # lane 0 crosses a page; lane 3 past its row
    n_valid = np.asarray([3, 2, 1, 0], np.int32)
    k_new = rng.standard_normal((B, C, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, C, HD)).astype(np.float32)
    k_new[1, 0, :D] = 0.0  # an all-zero head: scale 1/127
    got = _torch_cache(arrays, cache)
    plan = plan_kv_rows(_i32(pt), _i32(start), _i32(n_valid), C, PS)
    bf = torch.bfloat16
    kv_write(plan, torch.from_numpy(k_new).to(bf).reshape(B * C, HD),
             torch.from_numpy(v_new).to(bf).reshape(B * C, HD), got[0], got[1], LAYER,
             n_kv=n_kv, k_scales=got[2], v_scales=got[3])
    j = _jax_cache(arrays, cache)
    layer = jnp.asarray([LAYER], jnp.int32)
    for i in range(C):
        kv_new = jnp.concatenate([jnp.asarray(k_new[:, i:i + 1], jnp.bfloat16),
                                  jnp.asarray(v_new[:, i:i + 1], jnp.bfloat16)], axis=-1)
        i_valid = jnp.asarray((i < n_valid).astype(np.int32))
        lane = (jnp.asarray(pt), jnp.asarray(start + i), i_valid, layer)
        if cache == "int8":
            j = jax_append_q8(kv_new, *j, *lane, page_size=PS, n_kv=n_kv, interpret=True)
        else:
            j = list(jax_append(kv_new, j[0], j[1], *lane, page_size=PS, interpret=True))
            j += [None, None]
    for g, w in zip(got[:2], j[:2]):
        np.testing.assert_array_equal(_as_np(g)[:, 1:], _as_np(w)[:, 1:])
    if cache == "int8":
        for g, w in zip(got[2:], j[2:]):
            np.testing.assert_array_max_ulp(_as_np(g)[:, 1:], _as_np(w)[:, 1:], maxulp=1)


# --- the engine: the CPU path writes what it wrote before ----------------------


def _old_paged_attention_fn(page_table, start_pos, n_valid, chunk, page_size, n_kv):
    """The callback as it was before the writer: the fused decode append
    at C == 1, the chunk scatter otherwise (``chunk`` unused)."""
    kv_len = (start_pos + n_valid).to(I32)
    lane_valid = (n_valid > 0).to(I32)

    def attention(q, k, v, cache, layer_idx):
        k_pages, v_pages, k_scales, v_scales = cache
        scales = dict(k_scales=k_scales, v_scales=v_scales)
        B, C = k.shape[:2]
        if C == 1:
            kv_new = torch.cat([k.reshape(B, 1, -1), v.reshape(B, 1, -1)], dim=-1)
            kv_append(kv_new, k_pages, v_pages, page_table, start_pos, lane_valid, layer_idx,
                      page_size=page_size, n_kv=n_kv, **scales)
        else:
            _old_scatter(cache, k, v, page_table, start_pos, n_valid, page_size, layer_idx, n_kv)
        return paged_attention(q, k_pages, v_pages, page_table, start_pos, kv_len, layer_idx,
                               page_size=page_size, n_kv=n_kv, **scales), cache

    return attention


def _old_scatter(cache, k, v, page_table, start_pos, n_valid, page_size, layer, n_kv):
    k_pages, v_pages, k_scales, v_scales = cache
    if k_pages.dtype == torch.int8:
        tkv.scatter_kv_chunk_q8(k_pages, v_pages, k_scales, v_scales, k, v, page_table,
                                start_pos, n_valid, page_size, layer, n_kv)
    else:
        tkv.scatter_kv_chunk(k_pages, v_pages, k, v, page_table, start_pos, n_valid, page_size,
                             layer)


def _old_ragged_attention_fn(page_rows, tok_row, tok_pos, row_kv_len, page_size, n_kv, group,
                             row_gap):
    """The ragged callback as it was: the chunk scatter over the gathered
    [T, max_pages] table, each token a (B=T, C=1) row."""
    R = page_rows.shape[0]
    pt_tok = page_rows[tok_row.long().clamp(max=R - 1)]
    n_valid_tok = (tok_row < R).to(I32)
    plan = plan_ragged(tok_row, tok_pos, row_kv_len, group=group, kv_gap=row_gap)

    def attention(q, k, v, cache, layer_idx):
        k_pages, v_pages, k_scales, v_scales = cache
        T = k.shape[1]
        _old_scatter(cache, k.reshape(T, 1, n_kv, -1), v.reshape(T, 1, n_kv, -1), pt_tok,
                     plan.tok_pos, n_valid_tok, page_size, layer_idx, n_kv)
        out = ragged_paged_attention(q[0], k_pages, v_pages, page_rows, tok_row, tok_pos,
                                     row_kv_len, layer_idx, page_size=page_size, n_kv=n_kv,
                                     kv_gap=row_gap, k_scales=k_scales, v_scales=v_scales,
                                     plan=plan)
        return out[None], cache

    return attention


ENGINE = dict(max_seqs=4, page_size=8, num_pages=40, max_seq_len=128, prefill_chunk=16,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0)


def _serve_steps(engine):
    """A batched prefill (a chunk with padding lanes), two decode steps with
    an inactive slot, and a ragged round with padding tokens; returns the
    logits each step gave."""
    rng = np.random.default_rng(17)
    engine.set_page_table_rows({0: [1, 2, 3, 4], 1: [5, 6, 7, 8], 2: [9, 10, 11, 12],
                                3: [13, 14, 15]})
    out = list(engine.prefill_batch([(0, rng.integers(0, 256, 21).tolist()),
                                     (2, rng.integers(0, 256, 9).tolist())]))
    for slot in (0, 2):
        engine.set_last_token(slot, 7 + slot)
    B = ENGINE["max_seqs"]
    active = np.asarray([True, False, True, False])
    temp, top_p, top_k = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for _ in range(2):
        out.append(engine.decode(active, temp, top_p, top_k, return_logits=True)[1])
    R = B
    packed = rng.integers(0, 256, 12).tolist() + [0, 0]
    tok_row = [1] * 12 + [0, 2]
    T = engine.ragged_bucket(len(packed))
    args = [np.asarray(packed + [0] * (T - len(packed)), np.int32),
            np.asarray(tok_row + [R] * (T - len(tok_row)), np.int32),
            np.asarray([1, 0, 2, 3], np.int32), np.asarray([0, 0, 0, 0], np.int32),
            np.asarray([12, 1, 1, 0], np.int32), np.asarray([False, True, True, False]),
            np.asarray([False, True, True, False])]
    out.append(engine.ragged_mixed(*args, temp, top_p, top_k)[2])
    return out


@pytest.mark.parametrize("dtype,kv_quant", [("float32", ""), ("bfloat16", ""),
                                            ("float32", "int8")])
def test_engine_cpu_steps_write_the_caches_they_wrote_before(monkeypatch, dtype, kv_quant):
    """The engine's CPU prefill chunk, decode steps and ragged round,
    through the planned ``kv_write``, against the same steps through the
    writes they replaced: every cache tensor (trash page included) and
    every logit bitwise equal."""
    import dataclasses

    config = dataclasses.replace(tllama.PRESETS["tiny"], dtype=getattr(torch, dtype))
    gen = torch.Generator().manual_seed(23)
    params = tllama.init_params(config, gen, "cpu")
    ecfg = EngineConfig(**ENGINE, kv_quant=kv_quant)
    new = teng.InferenceEngine(config, params, ecfg, device="cpu")
    got = _serve_steps(new)
    monkeypatch.setattr(teng, "_paged_attention_fn", _old_paged_attention_fn)
    monkeypatch.setattr(teng, "_ragged_attention_fn", _old_ragged_attention_fn)
    old = teng.InferenceEngine(config, params, ecfg, device="cpu")
    want = _serve_steps(old)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    names = ("k_pages", "v_pages") + (("k_scales", "v_scales") if kv_quant else ())
    for name in names:
        assert torch.equal(getattr(new.state, name), getattr(old.state, name)), name
    assert bool(new.state.k_pages[:, 1:].any())


# --- routing and refusals -------------------------------------------------------


def test_append_kernel_for_names_one_body_per_cache():
    assert append_kernel_for(torch.bfloat16, 8, 128) == "kv_append_sm90"
    for hd in (8, 64, 128, 136, 256):
        assert append_kernel_for(torch.int8, 8, hd) == "kv_append_q8_sm90"
    for dtype, hd, match in ((torch.int8, 264, "head_dim <= 256"),
                             (torch.int8, 12, "multiple of 8"),
                             (torch.bfloat16, 4, "multiple of 8"),
                             (torch.float32, 128, "bf16 or int8 cache")):
        with pytest.raises(ValueError, match=match):
            append_kernel_for(dtype, 2, hd)
    for name in ("kv_append_sm90", "kv_append_q8_sm90"):
        assert kernels.KERNELS[name][0] == "kv_write_sm90.cu"


def test_kv_write_wrapper_refuses_cpu_tensors():
    """The writer's wrapper never runs its plain version: handed CPU
    tensors it raises, naming the tensor, and counts no launch."""
    before = dict(kernels.LAUNCHES)
    pages = torch.zeros((1, 4, 8, 2 * 128), dtype=torch.bfloat16)
    rows = torch.zeros(2, dtype=I32)
    k = torch.zeros((2, 2 * 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows is a CPU tensor"):
        paged_kv_write(rows, k, k, pages, pages, 0)
    assert kernels.LAUNCHES == before
