"""Which hand-written kernel serves an attention call over the int8 KV cache.

``ops/paged_attention.attention_kernel_for`` is a pure function of the
call's block shape: the Hopper decode body (``paged_attention_q8_decode_sm90``,
and ``paged_attention_decode_sm90`` over a bf16 cache) for every paged call
of one query token over pages of whole 64-key tiles; the Hopper int8 body
(``paged_attention_q8_sm90``, ``ragged_paged_attention_q8_sm90``: an
asynchronous ring of raw int8 tiles, one dequantization per tile) for blocks
of 64 query rows over pages of whole 64-key tiles with no page split; the
older body (``paged_attention_q8``, ``ragged_paged_attention_q8``) for
every other int8 call. A bf16 paged call of the same blocks goes to the
Hopper bf16 body (``paged_attention_sm90``), a bf16 ragged round to K3.
These tests pin that rule at the ``llama3-8b`` serving shapes — prefill
chunks, decode batches, ragged rounds — and at its edges
(tests/test_torch_attn_decode.py holds the decode rule in full,
tests/test_torch_attn_bf16.py the bf16 prefill rule). No card is needed:
only the choice is tested here, and the exact conversion the new body
applies to each stored byte; ``tests/test_torch_cuda.py`` holds both bodies
against the plain versions on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finchat_tpu_torch.engine.kv_cache import scale_rows  # noqa: E402
from finchat_tpu_torch.models.llama import PRESETS  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops import paged_attention as pa  # noqa: E402
from finchat_tpu_torch.ops import ragged_paged_attention as rpa  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402

_C = PRESETS["llama3-8b"]
_GROUP = _C.n_heads // _C.n_kv_heads
_PS = EngineConfig().page_size
_MP = 64  # pages per sequence in the served cases (8k tokens at page 128)


def _paged_route(kind: str, C: int, group: int = _GROUP, page_size: int = _PS,
                 max_pages: int = _MP) -> str:
    """The kernel a paged call of C query tokens per sequence reaches."""
    rows = group * pa.tile_tokens(group, C)
    splits, _pps = pa.decode_splits(C, max_pages)
    return pa.attention_kernel_for(kind, rows, page_size, splits, decode=C == 1)


@pytest.mark.parametrize("C", [512, 256, 100, 17, 16])
@pytest.mark.parametrize("max_pages", [1, 8, _MP])
def test_prefill_chunks_go_to_the_hopper_body(C, max_pages):
    assert _paged_route("paged_attention_q8", C, max_pages=max_pages) == \
        "paged_attention_q8_sm90"


@pytest.mark.parametrize("max_pages", [1, 4, 5, _MP])
def test_decode_stays_on_the_older_body(max_pages):
    """Decode stays on the older body only over pages that are not a whole
    number of 64-key tiles; over the serving page of 128 (and 64, 256) every
    decode call reaches the Hopper decode body, over either cache."""
    for kind in ("paged_attention_q8", "paged_attention"):
        for ps in (8, 16, 32, 96):
            assert _paged_route(kind, 1, page_size=ps, max_pages=max_pages) == kind
        for ps in (64, _PS, 256):
            assert _paged_route(kind, 1, page_size=ps, max_pages=max_pages) == \
                f"{kind}_decode_sm90"


@pytest.mark.parametrize("C", [2, 8, 15])
def test_short_chunks_stay_on_the_older_body(C):
    """Fewer than 16 tokens give Llama-3's group of 4 fewer than 64 rows."""
    assert _paged_route("paged_attention_q8", C) == "paged_attention_q8"


@pytest.mark.parametrize("group", [2, 4, 8])
def test_ragged_rounds_go_to_the_hopper_body(group):
    rows = group * pa.tile_tokens(group, 64)  # the ragged wrapper's tiles
    assert pa.attention_kernel_for("ragged_paged_attention_q8", rows, _PS, 1) == \
        "ragged_paged_attention_q8_sm90"


@pytest.mark.parametrize("page_size", [8, 16, 32, 96])
def test_small_or_odd_pages_stay_on_the_older_body(page_size):
    for kind, C in (("paged_attention_q8", 512), ("ragged_paged_attention_q8", 64)):
        assert _paged_route(kind, C, page_size=page_size) == kind


# (rows, page_size, splits): the Hopper body exactly when rows == 64, the
# page holds whole 64-key tiles and nothing is split
_EDGES = [(rows, ps, splits) for rows in (63, 64) for ps in (64, 96, 128)
          for splits in (1, 2)]


@pytest.mark.parametrize("case", _EDGES, ids=[f"rows{r}_ps{p}_splits{s}" for r, p, s in _EDGES])
def test_routing_edges(case):
    rows, ps, splits = case
    hopper = rows == 64 and ps % 64 == 0 and splits == 1
    for kind in ("paged_attention_q8", "ragged_paged_attention_q8"):
        want = f"{kind}_sm90" if hopper else kind
        assert pa.attention_kernel_for(kind, rows, ps, splits) == want


@pytest.mark.parametrize("kind", ["paged_attention", "ragged_paged_attention"])
def test_bf16_calls_keep_their_kernel(kind):
    """A bf16 call keeps its kernel — ragged rounds of any row count, and
    paged calls of other than 64 rows or with splits — except a paged call
    of 64-row blocks over whole 64-key tiles with no split, which reaches
    the Hopper bf16 body, and a paged decode call over whole 64-key tiles,
    which reaches the Hopper decode body."""
    for rows in (8, 16, 63, 64):
        for splits in (1, 2):
            hopper = kind == "paged_attention" and rows == 64 and splits == 1
            want = "paged_attention_sm90" if hopper else kind
            assert pa.attention_kernel_for(kind, rows, 128, splits) == want
            # pages of part tiles: the older body, whatever the rows
            assert pa.attention_kernel_for(kind, rows, 96, splits) == kind
    want = "paged_attention_decode_sm90" if kind == "paged_attention" else kind
    assert pa.attention_kernel_for(kind, 4, 128, 16, decode=True) == want
    assert pa.attention_kernel_for(kind, 4, 16, 16, decode=True) == kind


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown"):
        pa.attention_kernel_for("paged_attention_q4", 64, 128, 1)


def test_both_bodies_of_each_call_are_registered():
    for kind in ("paged_attention_q8", "ragged_paged_attention_q8", "paged_attention"):
        for name in (kind, f"{kind}_sm90"):
            assert name in kernels.KERNELS and name in kernels.LAUNCHES
        new, old = kernels.KERNELS[f"{kind}_sm90"][2], kernels.KERNELS[kind][2]
        if kind.endswith("_q8"):  # the int8 body takes the older one's arguments
            assert new == old
            assert kernels.KERNELS[f"{kind}_sm90"][0] == "attention_q8_sm90.cu"
        else:  # ... the bf16 body those and its query tiles a block
            assert new == old[:-2] + [kernels._I] + old[-2:]
            assert kernels.KERNELS[f"{kind}_sm90"][0] == "attention_bf16_sm90.cu"
    assert {"attention_q8_sm90.cu", "attention_bf16_sm90.cu"} <= set(kernels.SOURCES)


def _q8_call(T: int = 32, n_kv: int = 2, ps: int = 64, pages: int = 4):
    """CPU tensors of an int8-cache call whose blocks the Hopper body takes."""
    H = 4 * n_kv
    q = torch.zeros((1, T, H, 128), dtype=torch.bfloat16)
    kp = torch.zeros((1, pages, ps, n_kv * 128), dtype=torch.int8)
    ks = torch.ones((1, pages, scale_rows(n_kv), ps))
    pt = torch.ones((1, 2), dtype=torch.int32)
    i32 = torch.zeros(1, dtype=torch.int32)
    return q, kp, ks, pt, i32


def test_wrappers_refuse_cpu_tensors_before_routing():
    q, kp, ks, pt, i32 = _q8_call()
    kw = dict(page_size=64, n_kv=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_flash_attention_q8(q, kp, kp, ks, ks, pt, i32, i32 + 32, 0, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.prepare_paged("paged_attention_q8_sm90", q, kp, kp, pt, i32, i32 + 32, 0,
                         k_scales=ks, v_scales=ks, route=False, **kw)
    tok = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rpa.ragged_flash_attention_q8(q[0], kp, kp, ks, ks, pt, tok, tok, i32 + 32, 0, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rpa.prepare_ragged("ragged_paged_attention_q8_sm90", q[0], kp, kp, pt, tok, tok,
                           i32 + 32, 0, k_scales=ks, v_scales=ks, route=False, **kw)


# --- the conversion: one byte permute per stored value --------------------------

_MAGIC = np.uint32(0x4B000000)  # 2^23 as an fp32 bit pattern
_BIAS = np.float32(2.0 ** 23 + 128.0)


def _byte_perm(x: np.ndarray, y: np.uint32, selector: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, s)``: byte n of the result is byte
    ``s >> 4n & 7`` of the eight bytes y:x (x's bytes 0-3, y's 4-7)."""
    pool = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    pool += [np.uint32((int(y) >> (8 * i)) & 0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= np.asarray(pool[(selector >> (4 * n)) & 7], np.uint32) << np.uint32(8 * n)
    return out


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 bits, round to nearest even (finite inputs)."""
    b = x.astype(np.float32).view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)
            ).astype(np.uint16)


def _kernel_dequant(q8: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The Hopper body's conversion of int8 values packed four to a word:
    flip the sign bit, put byte j under the exponent of 2^23, subtract
    2^23 + 128, multiply by the key's fp32 scale, round to bf16."""
    words = (q8.astype(np.int8).view(np.uint8).reshape(-1, 4).astype(np.uint32)
             << (np.arange(4, dtype=np.uint32) * np.uint32(8))).sum(1).astype(np.uint32)
    words ^= np.uint32(0x80808080)
    vals = np.stack([_byte_perm(words, _MAGIC, 0x7540 + j).view(np.float32) - _BIAS
                     for j in range(4)], axis=1).reshape(q8.shape)
    return _bf16_rne(vals.astype(np.float32) * scale[:, None])


def test_byte_permute_reads_every_int8_value_exactly():
    q8 = np.arange(-128, 128, dtype=np.int8)
    words = q8.view(np.uint8).reshape(-1, 4).astype(np.uint32)
    packed = (words << (np.arange(4, dtype=np.uint32) * np.uint32(8))).sum(1).astype(np.uint32)
    packed ^= np.uint32(0x80808080)
    for j in range(4):
        got = _byte_perm(packed, _MAGIC, 0x7540 + j).view(np.float32) - _BIAS
        np.testing.assert_array_equal(got, q8[j::4].astype(np.float32))


@pytest.mark.parametrize("scales", ["kv_cache", "powers_of_two", "wide"])
def test_dequantization_equals_bf16_of_the_fp32_product(scales):
    """Every int8 value times a spread of scales converts to exactly
    ``bf16(float(q8) * scale)``, the reference's cast point (the plain
    version's ``(q8.float() * scale).to(bfloat16)``)."""
    rng = np.random.default_rng(0)
    if scales == "kv_cache":  # amax / 127 of bf16 activations
        sc = (rng.random(512, dtype=np.float32) * 8 + 1e-3) / np.float32(127)
    elif scales == "powers_of_two":
        sc = np.float32(2.0) ** np.arange(-40, 40, dtype=np.float32)
    else:
        sc = np.exp(rng.uniform(-60, 60, 512)).astype(np.float32)
    sc = np.concatenate([sc, np.float32([1 / 127])]).astype(np.float32)
    q8 = np.tile(np.arange(-128, 128, dtype=np.int8), (sc.size, 1))
    got = _kernel_dequant(q8, sc)
    want = (torch.from_numpy(q8).float() * torch.from_numpy(sc)[:, None]).to(torch.bfloat16)
    np.testing.assert_array_equal(got, want.view(torch.int16).numpy().view(np.uint16))
