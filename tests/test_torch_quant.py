"""The port's quantized serving plane against the JAX package, on CPU.

Int8/int4 weights (``models/quant.py``), the fused dequant matmul's plain
version (``ops/quant_matmul.py``), the int8 KV cache (``engine/kv_cache.py``),
the quantizing decode append and the int8-KV paged and ragged attention
(``ops/kv_append.py``, ``ops/paged_attention.py``,
``ops/ragged_paged_attention.py``), and the engine and scheduler serving
with ``quant`` + ``kv_quant="int8"``. The same seeded numpy inputs go
through both packages; the JAX kernels run as the JAX package's own tests
run them here (``interpret=True``), and its reference branches as its CPU
serving path does.

Tolerances and why:
- quantizers, int4 packing and unpacking, dequantization, KV-row
  quantization, the quantizing scatter, the int8 gather and the quantizing
  append: BITWISE. They are elementwise (abs, max, a true division,
  round-half-even, clip, casts), so the frameworks agree exactly.
- quant matmul and int8-KV attention at fp32, ``atol=1e-4``: the operands
  are bit-equal dequantized values; the products differ only in summation
  order (an fp32 matmul of width 128-256 differs by ~1e-5 between the
  frameworks here).
- engine: teacher-forced greedy tokens equal wherever the JAX top-2 logit
  margin exceeds 1e-3; logits within 1e-2 as a guard against gross error
  (a KV element that lands within ~1e-6 of a rounding boundary can move
  one int8 step, ~1% of its head's largest value, in one framework only).
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine import kv_cache as jkv  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.engine import commit_first_token as jax_commit  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models import quant as jquant  # noqa: E402
from finchat_tpu.ops import quant_matmul as jqmm  # noqa: E402
from finchat_tpu.ops.dispatch import paged_attention as jax_paged_dispatch  # noqa: E402
from finchat_tpu.ops.kv_append import paged_kv_append_q8 as jax_append_q8  # noqa: E402
from finchat_tpu.ops.paged_attention import paged_flash_attention_q8 as jax_paged_q8  # noqa: E402
from finchat_tpu.ops.ragged_paged_attention import (  # noqa: E402
    ragged_flash_attention_q8 as jax_ragged_q8,
    ragged_paged_attention_ref as jax_ragged_ref,
)
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine import kv_cache as tkv  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models import quant as tquant  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.ops import quant_matmul as tqmm  # noqa: E402
from finchat_tpu_torch.ops.dispatch import (  # noqa: E402
    kv_append,
    paged_attention,
    quant_matmul,
    ragged_paged_attention,
)
from finchat_tpu_torch.ops.kv_append import paged_kv_append_q8  # noqa: E402
from finchat_tpu_torch.ops.paged_attention import paged_flash_attention_q8  # noqa: E402
from finchat_tpu_torch.ops.ragged_paged_attention import ragged_flash_attention_q8  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

ATOL = 1e-4
L, PS, NUM_PAGES, LAYER = 2, 8, 40, 1


def _t(x: np.ndarray, dtype: str = "float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _j(x: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(x, getattr(jnp, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _weights(rng, shape, dtype):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., 3] = 0.0  # an all-zero column: scale falls back to 1/127 (1/7)
    return w


# --- weights -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bitwise_matches_jax(dtype):
    rng = np.random.default_rng(0)
    w = _weights(rng, (3, 64, 40), dtype)
    got, want = tquant.quantize(_t(w, dtype)), jquant.quantize(_j(w, dtype))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(_np(tquant.dequantize(got, getattr(torch, dtype))),
                                  _np(jquant.dequantize(want, getattr(jnp, dtype))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [0, 8])
def test_quantize_int4_bitwise_matches_jax(group, dtype):
    """Nibble packing (low nibble = row 2i, high = 2i+1), per-group scales
    and the dequantized weight, bit for bit."""
    rng = np.random.default_rng(1)
    w = _weights(rng, (2, 64, 40), dtype)
    got = tquant.quantize_int4(_t(w, dtype), group)
    want = jquant.quantize_int4(_j(w, dtype), group)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_np(tquant.dequantize(got, getattr(torch, dtype))),
                                  _np(jquant.dequantize(want, getattr(jnp, dtype))))


def test_unpack_int4_bitwise_matches_jax():
    """Every byte value: the low nibble and the high nibble sign-extend as
    JAX's arithmetic ``<< 4 >> 4`` / ``>> 4`` pair does."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    got = tquant._unpack_int4(torch.from_numpy(packed)).numpy()
    want = np.asarray(jquant._unpack_int4(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, want)
    assert got.min() == -8 and got.max() == 7


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 0), ("int4", 8)])
def test_quantize_stacked_bitwise_matches_jax(mode, group):
    rng = np.random.default_rng(2)
    w = _weights(rng, (3, 32, 24), "bfloat16")
    got = tquant.quantize_stacked(_t(w, "bfloat16"), mode=mode, group_size=group)
    want = jquant.quantize_stacked(_j(w, "bfloat16"), mode=mode, group_size=group)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    # and equal to whole-leaf quantization
    whole = (tquant.quantize_int4(_t(w, "bfloat16"), group) if mode == "int4"
             else tquant.quantize(_t(w, "bfloat16")))
    assert torch.equal(got.q, whole.q) and torch.equal(got.scale, whole.scale)


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 8)])
def test_quantize_llama_params_matches_jax_and_converts(mode, group):
    """The whole tiny tree: JAX's quantized tree converts bit for bit into
    the port's classes, equals the port quantizing the converted float
    tree, and quantizing again changes nothing (idempotent)."""
    jcfg = jllama.PRESETS["tiny"]
    jparams = jllama.init_params(jcfg, jax.random.key(3))
    jq = jax.device_get(jquant.quantize_llama_params(jparams, mode=mode, group_size=group))
    converted = params_from_numpy(jq, "cpu")
    mine = tquant.quantize_llama_params(params_from_numpy(jax.device_get(jparams), "cpu"),
                                        mode=mode, group_size=group)
    cls = tquant.Q4Tensor if mode == "int4" else tquant.QTensor
    for name in ("attn_q", "attn_o", "mlp_down"):
        a, b = converted["layers"][name], mine["layers"][name]
        assert isinstance(a, cls) and isinstance(b, cls)
        assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    assert isinstance(mine["lm_head"], cls)
    assert torch.equal(mine["lm_head"].q, converted["lm_head"].q)
    assert mine["embed"].dtype == torch.bfloat16  # the gather table stays
    again = tquant.quantize_llama_params(mine, mode=mode, group_size=group)
    assert again["layers"]["attn_q"] is mine["layers"]["attn_q"]


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 8)])
def test_init_quantized_params_equals_quantized_init(mode, group):
    """Made leaf by leaf, quantized before the next leaf exists: the same
    tree as quantizing a whole ``init_params`` tree on the same seed."""
    cfg = tllama.PRESETS["tiny"]
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    got = tquant.init_quantized_params(cfg, g1, "cpu", mode=mode, group_size=group)
    want = tquant.quantize_llama_params(tllama.init_params(cfg, g2, "cpu"), mode=mode,
                                        group_size=group)
    for name in tquant.QUANT_LAYER_LEAVES:
        assert torch.equal(got["layers"][name].q, want["layers"][name].q)
        assert torch.equal(got["layers"][name].scale, want["layers"][name].scale)
    assert torch.equal(got["embed"], want["embed"])
    assert torch.equal(got["lm_head"].q, want["lm_head"].q)


def test_validate_quant_mode():
    tquant.validate_quant_mode("")
    tquant.validate_quant_mode("int4")
    with pytest.raises(ValueError, match="unknown quant mode"):
        tquant.validate_quant_mode("fp4")


# --- quant matmul ------------------------------------------------------------

# (M, K, N, mode, group): ragged M and N (260, the tiny vocabulary), groups
QMM_CASES = [
    (5, 128, 260, "int8", 0),
    (16, 256, 128, "int8", 0),
    (5, 128, 260, "int4", 0),
    (7, 256, 96, "int4", 8),
]


def _qmm_inputs(M, K, N, mode, group, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = _weights(rng, (K, N), "float32")
    if mode == "int4":
        return x, jquant.quantize_int4(jnp.asarray(w), group), tquant.quantize_int4(_t(w), group)
    return x, jquant.quantize(jnp.asarray(w)), tquant.quantize(_t(w))


@pytest.mark.parametrize("case", QMM_CASES, ids=[f"{c[3]}_g{c[4]}_{c[0]}x{c[1]}x{c[2]}"
                                                  for c in QMM_CASES])
def test_quant_matmul_plain_matches_jax(case):
    """``quant_matmul_ref`` (the dispatcher's CPU route) against the JAX
    reference and the JAX Pallas kernel in interpret mode, at fp32."""
    M, K, N, mode, group = case
    x, jw, tw = _qmm_inputs(M, K, N, mode, group)
    got = quant_matmul(_t(x), tw).numpy()
    want_ref = np.asarray(jqmm.quant_matmul_ref(jnp.asarray(x), jw))
    if mode == "int4":
        want_kernel = jqmm.quant_matmul_int4(jnp.asarray(x), jw.q, jw.scale, interpret=True)
    else:
        want_kernel = jqmm.quant_matmul_int8(jnp.asarray(x), jw.q, jw.scale, interpret=True)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=ATOL, rtol=0)
    # dense() routes a quantized leaf through the same dispatch
    np.testing.assert_array_equal(tquant.dense(_t(x), tw).numpy(), got)


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 8)])
def test_quant_matmul_fp32_head_matches_jax(mode, group):
    """The lm_head case: bf16 activations, dequantized bf16 weight, fp32
    output (JAX ``preferred_element_type=float32``), leading batch dims."""
    M, K, N = 6, 128, 260
    x, jw, tw = _qmm_inputs(M, K, N, mode, group, seed=6)
    x3 = x.reshape(2, 3, K)
    got = quant_matmul(_t(x3, "bfloat16"), tw, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 3, N)
    want = jqmm.quant_matmul_ref(_j(x3, "bfloat16"), jw, preferred_element_type=jnp.float32)
    kernel = (jqmm.quant_matmul_int4 if mode == "int4" else jqmm.quant_matmul_int8)(
        _j(x3, "bfloat16"), jw.q, jw.scale, interpret=True, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL, rtol=0)


# --- int8 KV cache -----------------------------------------------------------

def test_quantize_kv_rows_bitwise_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 3, 4 * 16)).astype(np.float32)
    x[0, 0, :16] = 0.0  # an all-zero head: scale 1/127, q all 0
    for dtype in ("float32", "bfloat16"):
        q_t, s_t = tkv.quantize_kv_rows(_t(x, dtype), 4)
        q_j, s_j = jkv.quantize_kv_rows(_j(x, dtype), 4)
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def _q8_cache(rng, n_kv: int, D: int):
    """An int8 cache with random rows and positive scales (JAX layout)."""
    shape = (L, NUM_PAGES, PS, n_kv * D)
    sshape = (L, NUM_PAGES, tkv.scale_rows(n_kv), PS)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = (rng.random(sshape) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random(sshape) * 0.02 + 1e-3).astype(np.float32)
    return k, v, ks, vs


def _page_table(rng, B: int, max_pages: int) -> np.ndarray:
    ids = rng.permutation(np.arange(1, NUM_PAGES))[: B * max_pages]
    return ids.reshape(B, max_pages).astype(np.int32)


def test_cache_create_and_page_bytes_match_jax():
    jcfg = jllama.PRESETS["tiny"]
    tcfg = tllama.PRESETS["tiny"]
    for kv_quant in ("", "int8"):
        c = tkv.PagedKVCache.create(tcfg, 10, PS, "cpu", kv_quant=kv_quant)
        per = tkv.page_hbm_bytes(tcfg, PS, kv_quant)
        assert per == jkv.page_hbm_bytes(jcfg, PS, kv_quant)
        tensors = [c.k_pages, c.v_pages] + ([c.k_scales, c.v_scales] if kv_quant else [])
        assert sum(t.numel() * t.element_size() for t in tensors) == 10 * per
    assert tuple(c.k_scales.shape) == (tcfg.n_layers, 10, 8, PS)  # heads padded to 8 rows
    with pytest.raises(ValueError, match="kv_quant"):
        tkv.PagedKVCache.create(tcfg, 10, PS, "cpu", kv_quant="int4")


def test_scatter_and_gather_q8_bitwise_match_jax():
    """The quantizing chunk scatter (pages and scale planes, padding lanes
    to the trash page) and the dequantizing gather, against JAX's."""
    rng = np.random.default_rng(8)
    n_kv, D, B, C, MP = 2, 16, 3, 6, 4
    k, v, ks, vs = _q8_cache(rng, n_kv, D)
    pt = _page_table(rng, B, MP)
    k_new = rng.standard_normal((B, C, n_kv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, C, n_kv, D)).astype(np.float32)
    start = np.asarray([0, 5, 19], np.int32)
    n_valid = np.asarray([6, 3, 6], np.int32)
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (k, v, ks, vs))
    tkv.scatter_kv_chunk_q8(tk, tv, tks, tvs, _t(k_new), _t(v_new), torch.from_numpy(pt),
                            torch.from_numpy(start), torch.from_numpy(n_valid), PS, LAYER, n_kv)
    jk, jv, jks, jvs = jkv.scatter_kv_chunk_q8(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(pt), jnp.asarray(start), jnp.asarray(n_valid), PS,
        LAYER, n_kv)
    # page 0 takes the padding lanes' writes in an unspecified order
    for got, want in ((tk, jk), (tv, jv), (tks, jks), (tvs, jvs)):
        np.testing.assert_array_equal(got.numpy()[:, 1:], np.asarray(want)[:, 1:])
    assert not np.array_equal(tk.numpy(), k)  # something was written
    for dtype in ("float32", "bfloat16"):
        got = tkv.gather_kv_q8(tk, tv, tks, tvs, torch.from_numpy(pt), PS, LAYER, n_kv,
                               dtype=getattr(torch, dtype))
        want = jkv.gather_kv_q8(jk, jv, jks, jvs, jnp.asarray(pt), PS, LAYER, n_kv,
                                dtype=getattr(jnp, dtype))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_append_q8_plain_bit_exact_vs_jax(dtype):
    """K5's plain version, through the dispatcher, vs the JAX package's
    quantizing write of one row per sequence (``scatter_kv_chunk_q8`` with
    C = 1, the write its reference backend serves decode with): pages and
    scale planes bit-exact, the invalid lane's row and scales in the trash
    page. Against the JAX append kernel (interpret) the pages are bit-exact
    too, and its scales within one fp32 ulp: jitted, XLA turns the
    kernel's ``amax / 127.0`` into a multiply by the reciprocal, which
    rounds differently for some amax (the true division is the JAX
    package's definition, models/quant.py; the CUDA kernel keeps it)."""
    rng = np.random.default_rng(9)
    n_kv, D, B, MP = 2, 16, 5, 4
    HD = n_kv * D
    k, v, ks, vs = _q8_cache(rng, n_kv, D)
    pt = _page_table(rng, B, MP)
    pos = np.asarray([0, 7, 13, 31, 250], np.int32)  # lane 4: invalid, pos past its row
    n_valid = np.asarray([1, 1, 1, 1, 0], np.int32)
    kv_new = rng.standard_normal((B, 1, 2 * HD)).astype(np.float32)
    kv_new[1, 0, :D] = 0.0  # an all-zero head
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (k, v, ks, vs))
    kv_append(_t(kv_new, dtype), tk, tv, torch.from_numpy(pt), torch.from_numpy(pos),
              torch.from_numpy(n_valid), LAYER, page_size=PS, n_kv=n_kv, k_scales=tks,
              v_scales=tvs)
    rows = _j(kv_new, dtype)
    want = jkv.scatter_kv_chunk_q8(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
        rows[:, :, :HD].reshape(B, 1, n_kv, D), rows[:, :, HD:].reshape(B, 1, n_kv, D),
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(n_valid), PS, LAYER, n_kv)
    for got, w in zip((tk, tv, tks, tvs), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    kernel = jax_append_q8(
        rows, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(n_valid), jnp.asarray([LAYER], jnp.int32),
        page_size=PS, n_kv=n_kv, interpret=True)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kernel[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(kernel[1]))
    np.testing.assert_array_max_ulp(tks.numpy(), np.asarray(kernel[2]), maxulp=1)
    np.testing.assert_array_max_ulp(tvs.numpy(), np.asarray(kernel[3]), maxulp=1)
    q_row, s_row = tkv.quantize_kv_rows(_t(kv_new, dtype)[4, 0, :HD], n_kv)
    np.testing.assert_array_equal(tk.numpy()[LAYER, 0, 250 % PS], q_row.numpy())
    np.testing.assert_array_equal(tks.numpy()[LAYER, 0, :n_kv, 250 % PS], s_row.numpy())


# (name, C, q_offset per seq, kv_len per seq, H, Hkv)
PAGED_CASES = [
    ("decode", 1, [5, 17, 30, 0], [6, 18, 31, 0], 4, 2),
    ("prefill_offset", 6, [8, 0, 19], [14, 6, 23], 4, 2),
    ("gqa_group4", 4, [0, 3, 12], [4, 7, 16], 8, 2),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_attention_q8_plain_matches_jax(case):
    """K4's plain version vs the JAX int8 kernel (interpret) on rows with
    keys, and vs the JAX reference dispatch on every row, at fp32."""
    _name, C, q_off, kv_len, H, Hkv = case
    rng = np.random.default_rng(10)
    D, B, MP = 16, len(q_off), 5
    k, v, ks, vs = _q8_cache(rng, Hkv, D)
    pt = _page_table(rng, B, MP)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    q_off, kv_len = np.asarray(q_off, np.int32), np.asarray(kv_len, np.int32)
    got = _np(paged_attention(
        _t(q), *(torch.from_numpy(a) for a in (k, v)), torch.from_numpy(pt),
        torch.from_numpy(q_off), torch.from_numpy(kv_len), LAYER, page_size=PS, n_kv=Hkv,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs)))
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_kernel = _np(jax_paged_q8(
        *jargs, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pt), jnp.asarray(q_off),
        jnp.asarray(kv_len), jnp.asarray([LAYER], jnp.int32), page_size=PS, n_kv=Hkv,
        interpret=True))
    want_ref = _np(jax_paged_dispatch(
        *jargs, jnp.asarray(pt), jnp.asarray(q_off), jnp.asarray(kv_len),
        jnp.asarray([LAYER], jnp.int32), page_size=PS, n_kv=Hkv, backend="ref",
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    live = kv_len > 0
    np.testing.assert_allclose(got[live], want_kernel[live], atol=ATOL, rtol=0)


# rows (q_len, pos0, kv_len), padded length, per-row kv_gap
RAGGED_CASES = [
    ("chunk_decode_padding", [(9, 4, 13), (1, 20, 21), (1, 7, 8), (1, 33, 34)], 16, None),
    ("gap_row", [(6, 40, 46), (1, 12, 13)], 12, [16, 0]),
]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=[c[0] for c in RAGGED_CASES])
def test_ragged_attention_q8_plain_matches_jax(case):
    """K6's plain version vs the JAX int8 ragged kernel (interpret) on real
    tokens and vs the JAX reference on every token, kv_gap zero and not."""
    _name, rows, T, gaps = case
    H, Hkv, D, MP = 4, 2, 16, 6
    rng = np.random.default_rng(11)
    k, v, ks, vs = _q8_cache(rng, Hkv, D)
    pt = _page_table(rng, len(rows), MP)
    tok_row, tok_pos = [], []
    for r, (q_len, p0, _kv) in enumerate(rows):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row = np.asarray(tok_row + [len(rows)] * (T - n_real), np.int32)
    tok_pos = np.asarray(tok_pos + [0] * (T - n_real), np.int32)
    kv_len = np.asarray([kv for _q, _p, kv in rows], np.int32)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    gap_t = None if gaps is None else torch.tensor(gaps, dtype=torch.int32)
    gap_j = None if gaps is None else jnp.asarray(gaps, jnp.int32)
    got = _np(ragged_paged_attention(
        _t(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pt),
        torch.from_numpy(tok_row), torch.from_numpy(tok_pos), torch.from_numpy(kv_len), LAYER,
        page_size=PS, n_kv=Hkv, kv_gap=gap_t, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs)))
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdesc = (jnp.asarray(pt), jnp.asarray(tok_row), jnp.asarray(tok_pos), jnp.asarray(kv_len),
             jnp.asarray([LAYER], jnp.int32))
    want_kernel = _np(jax_ragged_q8(*jargs, jnp.asarray(ks), jnp.asarray(vs), *jdesc,
                                    page_size=PS, n_kv=Hkv, interpret=True, kv_gap=gap_j))
    want_ref = _np(jax_ragged_ref(*jargs, *jdesc, page_size=PS, n_kv=Hkv,
                                  k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
                                  kv_gap=gap_j))
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:n_real], want_kernel[:n_real], atol=ATOL, rtol=0)


def test_quantized_kernel_wrappers_refuse_cpu_tensors():
    """The new kernel wrappers never run their plain version themselves:
    handed CPU tensors they raise and count no launch."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    i32 = dict(dtype=torch.int32)
    pages = torch.zeros((1, 4, PS, 2 * 128), dtype=torch.int8)
    scales = torch.ones((1, 4, 8, PS))
    one = torch.ones(1, **i32)
    q = torch.zeros((1, 1, 4, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_attention_q8(q, pages, pages, scales, scales, torch.ones((1, 2), **i32),
                                 one - 1, one, 0, page_size=PS, n_kv=2)
    with pytest.raises(ValueError, match="CUDA"):
        ragged_flash_attention_q8(q[0], pages, pages, scales, scales, torch.ones((1, 2), **i32),
                                  one - 1, one - 1, one, 0, page_size=PS, n_kv=2)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kv_append_q8(torch.zeros((1, 1, 4 * 128), dtype=torch.bfloat16), pages, pages,
                           scales, scales, torch.ones((1, 2), **i32), one - 1, one, 0,
                           page_size=PS, n_kv=2)
    w = tquant.quantize(torch.randn(128, 32))
    w4 = tquant.quantize_int4(torch.randn(128, 32))
    x = torch.zeros((2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tqmm.quant_matmul_int8(x, w.q, w.scale)
    with pytest.raises(ValueError, match="CUDA"):
        tqmm.quant_matmul_int4(x, w4.q, w4.scale)
    assert LAUNCHES == before


# --- engine and scheduler ----------------------------------------------------

MARGIN = 1e-3
LOGIT_GUARD = 1e-2
ENGINE = dict(max_seqs=4, page_size=8, num_pages=40, max_seq_len=128, prefill_chunk=16,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0,
              kv_quant="int8")


def _engines(mode: str, group: int):
    """A JAX engine (reference attention and quant-matmul backends) and the
    port's engine on the converted quantized tree, ``tiny`` at fp32."""
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(12))
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), attn_backend="ref", quant=mode,
                   quant_group=group, qm_backend="ref")
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    tparams = params_from_numpy(jax.device_get(je.params), "cpu")
    te = InferenceEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu", quant=mode,
                         quant_group=group)
    return je, te


def _assert_step(logits_t, logits_j, tok_t: int, tok_j: int) -> None:
    logits_j = np.asarray(logits_j)
    np.testing.assert_allclose(np.asarray(logits_t), logits_j, atol=LOGIT_GUARD, rtol=0)
    top2 = np.sort(logits_j)[-2:]
    if top2[1] - top2[0] > MARGIN:
        assert tok_t == tok_j, (tok_t, tok_j, top2)


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 8)])
def test_quantized_engine_matches_jax(mode, group):
    """quant weights + int8 KV through the port's engine against JAX's:
    a batched prefill that crosses pages (37 and 20 tokens over chunks of
    16, pages of 8), commit, 6 teacher-forced decodes, then one packed
    ragged round (a completing prefill chunk, a mid-prompt chunk and two
    decode rows). Greedy tokens agree wherever the JAX margin exceeds 1e-3,
    and the int8 pages and scale planes the steps wrote agree."""
    je, te = _engines(mode, group)
    assert te.quant_label == je.quant_label == f"{mode}+kv8"
    assert te.state.k_pages.dtype == torch.int8 and te.state.k_scales.dtype == torch.float32
    rng = np.random.default_rng(13)
    prompts = {0: rng.integers(0, 256, 37).tolist(), 2: rng.integers(0, 256, 20).tolist()}
    tables = {0: list(range(1, 8)), 1: list(range(8, 12)), 2: list(range(12, 17)),
              3: list(range(17, 21))}
    je.set_page_table_rows(tables)
    te.set_page_table_rows(tables)
    items = list(prompts.items())
    lj, lt = je.prefill_batch(items), te.prefill_batch(items)
    for (slot, _ids), logits_t, logits_j in zip(items, lt, lj):
        je.state, tok_j = jax_commit(je.state, jnp.int32(slot), logits_j, jnp.float32(0.0),
                                     jnp.float32(1.0), jnp.int32(0))
        tok_t = te.commit_first_token(slot, logits_t, 0.0, 1.0, 0)
        _assert_step(logits_t.numpy(), logits_j, int(tok_t), int(tok_j))
        te.set_last_token(slot, int(tok_j))
    B = ENGINE["max_seqs"]
    active = np.zeros(B, bool)
    active[list(prompts)] = True
    temp, top_p, top_k = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for _step in range(6):
        toks_j, logits_j = je.decode(jnp.asarray(active), jnp.asarray(temp), jnp.asarray(top_p),
                                     jnp.asarray(top_k), return_logits=True)
        toks_t, logits_t = te.decode(active, temp, top_p, top_k, return_logits=True)
        toks_j, logits_j = np.asarray(toks_j), np.asarray(logits_j)
        for slot in prompts:
            _assert_step(logits_t[slot].numpy(), logits_j[slot], int(toks_t[slot]),
                         int(toks_j[slot]))
            te.set_last_token(slot, int(toks_j[slot]))  # teacher forcing

    # one ragged round: slot 1 completes a 16-token prompt, slot 3 runs a
    # mid-prompt chunk, slots 0 and 2 decode from the device
    R = B
    p1, p3 = rng.integers(0, 256, 16).tolist(), rng.integers(0, 256, 30).tolist()
    packed = p1 + p3[:16] + [0, 0]
    tok_row = [0] * 16 + [1] * 16 + [2, 3]
    T = te.ragged_bucket(len(packed))
    packed += [0] * (T - len(packed))
    tok_row += [R] * (T - len(tok_row))
    row_slot = np.asarray([1, 3, 0, 2], np.int32)
    row_start = np.zeros(R, np.int32)
    row_len = np.asarray([16, 16, 1, 1], np.int32)
    row_dev = np.asarray([False, False, True, True])
    row_arm = np.asarray([True, False, True, True])
    args = [np.asarray(packed, np.int32), np.asarray(tok_row, np.int32), row_slot, row_start,
            row_len, row_dev, row_arm]
    em_j, n_j, logits_j, _blk = je.ragged_mixed(
        *[jnp.asarray(a) for a in args], jnp.zeros(R, jnp.int32), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(top_k), jnp.zeros(R, bool), jnp.zeros(R, jnp.float32),
        jnp.ones(R, jnp.float32), jnp.zeros(R, jnp.int32), -1)
    em_t, n_t, logits_t = te.ragged_mixed(*args, temp, top_p, top_k)
    em_j, logits_j = np.asarray(em_j), np.asarray(logits_j)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    for r in range(4):
        _assert_step(logits_t[r].numpy(), logits_j[r], int(em_t[r, 0]), int(em_j[r, 0]))
    np.testing.assert_array_equal(te.state.context_lens.numpy(),
                                  np.asarray(je.state.context_lens))
    pages = sum(tables.values(), [])
    for name in ("k_pages", "v_pages"):
        got = getattr(te.state, name)[:, pages].numpy().astype(np.int32)
        want = np.asarray(getattr(je.state, name))[:, pages].astype(np.int32)
        assert np.abs(got - want).max() <= 1, name  # a rounding-boundary flip at most
        assert np.mean(got != want) < 1e-3, name
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(getattr(te.state, name)[:, pages].numpy(),
                                   np.asarray(getattr(je.state, name))[:, pages],
                                   rtol=1e-4, atol=0, err_msg=name)


def test_quantized_scheduler_serves_and_sets_gauges():
    """The scheduler accepts ``kv_quant="int8"`` with int8 weights, serves
    three greedy requests to completion (the third admitted while the first
    decodes, so a packed ragged round runs over the int8 cache), frees every
    page, and reads 8 weight bits / 8 KV bits on its gauges."""
    tcfg = tllama.LlamaConfig(dtype=torch.float32)
    params = tquant.init_quantized_params(tcfg, torch.Generator().manual_seed(14), "cpu")
    cfg = EngineConfig(**{**ENGINE, "max_seq_len": 96})
    engine = InferenceEngine(tcfg, params, cfg, device="cpu", quant="int8")
    sched = ContinuousBatchingScheduler(engine, eos_id=258)
    assert sched.quant_label == "int8+kv8"
    assert METRICS.get("finchat_quant_weight_bits") == 8
    assert METRICS.get("finchat_quant_kv_bits") == 8
    mixed0 = METRICS.get("finchat_mixed_dispatches_total")
    rng = np.random.default_rng(15)

    async def drive():
        await sched.start()
        sp = SamplingParams(temperature=0.0, max_new_tokens=6)
        handles = [await sched.submit(f"q{i}", rng.integers(0, 256, n).tolist(), sp)
                   for i, n in enumerate((21, 9))]
        while not sched.decoding:
            await asyncio.sleep(0.001)
        handles.append(await sched.submit("q2", rng.integers(0, 256, 40).tolist(), sp))
        done = []
        for h in handles:
            while True:
                ev = await asyncio.wait_for(h.events.get(), timeout=60)
                if ev["type"] != "token":
                    done.append(ev)
                    break
        await sched.stop()
        return handles, done

    handles, done = asyncio.run(drive())
    assert all(ev["type"] == "done" for ev in done), done
    assert all(h.generated > 0 for h in handles)
    assert METRICS.get("finchat_mixed_dispatches_total") > mixed0, "no ragged round ran"
    assert sched.allocator.used_count == 0
    sched.allocator.check_invariants()
    # a bf16 engine's scheduler reads 16 / 16
    bf = InferenceEngine(tllama.LlamaConfig(), tllama.init_params(
        tllama.LlamaConfig(), torch.Generator().manual_seed(1), "cpu"),
        dataclasses.replace(cfg, kv_quant=""), device="cpu")
    ContinuousBatchingScheduler(bf, eos_id=258)
    assert METRICS.get("finchat_quant_weight_bits") == 16
    assert METRICS.get("finchat_quant_kv_bits") == 16
