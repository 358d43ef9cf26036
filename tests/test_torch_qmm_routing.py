"""Which hand-written kernel serves a fused dequant matmul call, and how the
decode body splits K.

``ops/quant_matmul.kernel_for`` is a pure function of the call. Where the
operands are ones TMA can read (K % 8 == 0, N % 16 == 0, 16-byte aligned,
int4 groups of a multiple of 8 rows), at most 64 rows go to the decode body
(``quant_matmul_{int8,int4}_decode_sm90``) with bf16 or fp32 output, more
rows with bf16 output to the Hopper kernel (``quant_matmul_{int8,int4}_sm90``,
TMA + ``wgmma``); every other call goes to v2 (``quant_matmul_{int8,int4}``).
These tests pin that rule over the ``llama3-8b`` serving shapes — its seven
per-layer weights at prefill chunks and decode batches, and its fp32-logit
head — and over the edge cases the card tests also drive.

``decode_split`` cuts K for the decode body: the tests hold that its splits
cover every K tile exactly once, in whole tiles and whole int4 groups, and
give at least one block per SM of an H100 (132) at every llama3-8b decode
shape. Then a torch emulation of the plan — per-split fp32 partials of
``x @ bf16(q * scale)`` summed in split order, rounded once — is held
against the JAX package's ``quant_matmul_int8`` / ``quant_matmul_int4`` in
interpret mode at small widths, as the JAX package's own tests run them
here, within the card tests' limit for a bf16 output row (2^-7 of the row's
largest value: both round an fp32 sum of the same exact products to bf16).
No card is needed: ``tests/test_torch_cuda.py`` holds the kernels
themselves against the plain version on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from finchat_tpu.models import quant as jquant  # noqa: E402
from finchat_tpu.ops import quant_matmul as jqmm  # noqa: E402
from finchat_tpu_torch.models import quant as tquant  # noqa: E402
from finchat_tpu_torch.models.llama import PRESETS  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops.quant_matmul import (  # noqa: E402
    DECODE_BLOCK_N,
    DECODE_TILE_K,
    decode_split,
    kernel_for,
    prepare,
    quant_matmul_int4,
    quant_matmul_int8,
    run_kernel,
)

N_SM = 132  # an H100 SXM

_C = PRESETS["llama3-8b"]
# the seven matmuls of a layer, [K, N]
_WEIGHTS = {
    "attn_q": (_C.dim, _C.n_heads * _C.head_dim),
    "attn_k": (_C.dim, _C.n_kv_heads * _C.head_dim),
    "attn_v": (_C.dim, _C.n_kv_heads * _C.head_dim),
    "attn_o": (_C.n_heads * _C.head_dim, _C.dim),
    "mlp_gate": (_C.dim, _C.hidden_dim),
    "mlp_up": (_C.dim, _C.hidden_dim),
    "mlp_down": (_C.hidden_dim, _C.dim),
}
# a 4 x 512 prefill chunk, the ragged round of two 512-token rows and 60
# decode rows, one 512-token chunk, the smallest call past decode
_PREFILL_ROWS = (2048, 1084, 512, 65)
# decode batches up to the 64 slots
_DECODE_ROWS = (1, 8, 64)
# (mode, group rows): int8 per column; int4 per column and per group of 128
_MODES = (("int8", None), ("int4", None), ("int4", 128))


def _group(K: int, group: int | None) -> int:
    return group or K


@pytest.mark.parametrize("weight", sorted(_WEIGHTS))
@pytest.mark.parametrize("mode,group", _MODES)
@pytest.mark.parametrize("M", _PREFILL_ROWS)
def test_prefill_shapes_go_to_the_hopper_kernel(weight, mode, group, M):
    K, N = _WEIGHTS[weight]
    assert kernel_for(mode, M, K, N, _group(K, group), out_f32=False) == \
        f"quant_matmul_{mode}_sm90"


@pytest.mark.parametrize("weight", sorted(_WEIGHTS))
@pytest.mark.parametrize("mode,group", _MODES)
@pytest.mark.parametrize("M", _DECODE_ROWS)
def test_decode_shapes_stay_on_v2(weight, mode, group, M):
    """Decode batches (at most 64 rows) go to the decode body, not v2."""
    K, N = _WEIGHTS[weight]
    assert kernel_for(mode, M, K, N, _group(K, group), out_f32=False) == \
        f"quant_matmul_{mode}_decode_sm90"


@pytest.mark.parametrize("mode,group", _MODES)
@pytest.mark.parametrize("M", _PREFILL_ROWS + _DECODE_ROWS)
def test_fp32_head_stays_on_v2(mode, group, M):
    """The fp32-logit head: the decode body at most 64 rows (decode, and a
    prefill chunk's last rows), v2 past them (the Hopper kernel writes bf16
    only)."""
    K, N = _C.dim, _C.vocab_size
    want = f"quant_matmul_{mode}_decode_sm90" if M <= 64 else f"quant_matmul_{mode}"
    assert kernel_for(mode, M, K, N, _group(K, group), out_f32=True) == want


@pytest.mark.parametrize("M", (1, 4, 8, 64))
def test_mixtral_head_goes_to_the_decode_body(M):
    """``mixtral-8x7b``'s int8 head (vocab 32,000, fp32 logits) at the
    calls its serve makes (a decode batch, a prefill chunk's or a ragged
    round's last rows: at most 64): the decode body, never v2."""
    c = PRESETS["mixtral-8x7b"]
    assert kernel_for("int8", M, c.dim, c.vocab_size, c.dim, out_f32=True) == \
        "quant_matmul_int8_decode_sm90"


# (M, K, N, group rows, aligned, kernel for bf16 output): the edges of the
# rule — "decode" (at most 64 rows), "sm90" (more), "" for v2; with fp32
# output the decode body keeps its calls, and v2 takes the Hopper kernel's
_EDGES = [
    (64, 4096, 4096, 4096, True, "decode"),   # the last decode row count
    (65, 4096, 4096, 4096, True, "sm90"),     # the first prefill row count
    (130, 512, 260, 512, True, ""),           # N = 260: weight rows not 16-byte multiples
    (130, 512, 1040, 512, True, "sm90"),      # N a multiple of 16, not of 128
    (130, 200, 256, 200, True, "sm90"),       # K a multiple of 8, not of the 64-row tile
    (130, 196, 256, 196, True, ""),           # K not a multiple of 8: x rows unaligned
    (300, 512, 384, 512, False, ""),          # an operand off a 16-byte boundary
    (300, 512, 384, 8, True, "sm90"),         # int4 groups of 8 rows
    (300, 512, 384, 4, True, ""),             # int4 groups of 4: a 16-byte chunk spans two
    (2048, 4096, 0, 4096, True, ""),          # an empty weight
    (1, 4096, 1024, 4096, True, "decode"),    # one row
    (4, 1056, 1040, 32, True, "decode"),      # K off the tile, N off the block, int4 g32
    (64, 196, 256, 196, True, ""),            # decode rows, K not a multiple of 8
    (64, 512, 260, 512, True, ""),            # decode rows, N = 260
    (8, 512, 384, 512, False, ""),            # decode rows, an operand off a boundary
    (8, 512, 384, 4, True, ""),               # decode rows, int4 groups of 4
]


@pytest.mark.parametrize("case", _EDGES, ids=[f"M{c[0]}_K{c[1]}_N{c[2]}_g{c[3]}_a{int(c[4])}"
                                              for c in _EDGES])
def test_routing_edges(case):
    M, K, N, group, aligned, kind = case
    suffix = {"decode": "_decode_sm90", "sm90": "_sm90", "": ""}
    for mode in ("int8", "int4"):
        assert kernel_for(mode, M, K, N, group, out_f32=False, aligned=aligned) == \
            f"quant_matmul_{mode}{suffix[kind]}"
        f32_kind = kind if kind == "decode" else ""
        assert kernel_for(mode, M, K, N, group, out_f32=True, aligned=aligned) == \
            f"quant_matmul_{mode}{suffix[f32_kind]}"


def test_both_kernels_of_each_mode_are_registered():
    for mode in ("int8", "int4"):
        for name in (f"quant_matmul_{mode}", f"quant_matmul_{mode}_sm90",
                     f"quant_matmul_{mode}_decode_sm90"):
            assert name in kernels.KERNELS and name in kernels.LAUNCHES
    assert kernels.KERNELS["quant_matmul_int8_sm90"][0] == "quant_matmul_sm90.cu"
    assert kernels.KERNELS["quant_matmul_int4_decode_sm90"][0] == "quant_matmul_decode_sm90.cu"
    assert {"quant_matmul_sm90.cu", "quant_matmul_decode_sm90.cu"} <= set(kernels.SOURCES)


def test_wrappers_refuse_cpu_tensors_before_routing():
    x = torch.zeros((128, 64), dtype=torch.bfloat16)
    q = torch.zeros((64, 128), dtype=torch.int8)
    for fn, scale in ((quant_matmul_int8, torch.ones(128)),
                      (quant_matmul_int4, torch.ones((1, 128)))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x, q[:32] if fn is quant_matmul_int4 else q, scale)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_kernel("quant_matmul_int8_sm90", x, q, torch.ones(128))
    with pytest.raises(ValueError, match="CUDA tensors"):
        prepare("quant_matmul_int8_decode_sm90", x[:4], q, torch.ones(128))


# --- the decode body's split of K ------------------------------------------------

# every [K, N] a llama3-8b decode step multiplies, and the head
_DECODE_SHAPES = sorted(set(_WEIGHTS.values())) + [(_C.dim, _C.vocab_size)]


def _spans(K: int, N: int, group: int, n_sm: int = N_SM) -> list[tuple[int, int]]:
    splits, k_split = decode_split(K, N, group, n_sm)
    return [(s * k_split, min(K, (s + 1) * k_split)) for s in range(splits)]


# (K, N, group rows): the llama3-8b shapes per column and per group of
# 128, 32 and 8, and small or odd ones (a 16-column weight, K off the tile)
_SPLIT_CASES = [(K, N, g or K) for K, N in _DECODE_SHAPES for g in (None, 8, 32, 128)] + [
    (256, 16, 256), (256, 16, 8), (1056, 1040, 1056), (1056, 1040, 32), (64, 1024, 64),
    (14336, 1040, 14336), (14336, 1040, 128), (200, 128, 200), (200, 128, 8), (960, 256, 96)]


@pytest.mark.parametrize("K,N,group", _SPLIT_CASES, ids=[f"K{c[0]}_N{c[1]}_g{c[2]}"
                                                         for c in _SPLIT_CASES])
@pytest.mark.parametrize("n_sm", [1, 78, 132])
def test_decode_split_covers_every_tile_once_in_whole_groups(K, N, group, n_sm):
    splits, k_split = decode_split(K, N, group, n_sm)
    spans = _spans(K, N, group, n_sm)
    # contiguous, non-empty, from 0 to K: every k (so every K tile) once
    assert spans[0][0] == 0 and spans[-1][1] == K
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(splits - 1))
    # whole 64-row tiles, and whole groups where the scales have more than one
    assert k_split % DECODE_TILE_K == 0
    if group < K:
        assert k_split % group == 0
    # as even as whole units allow; one to two waves of blocks where some
    # split of whole units gives that, else the fewest splits past one wave
    # (all the units where K has too few); among those, the fewest units on
    # the busiest SM (waves x units a split), then the fewest splits
    unit = DECODE_TILE_K if group >= K else math.lcm(DECODE_TILE_K, group)
    n_units, col_blocks = -(-K // unit), -(-N // DECODE_BLOCK_N)
    per = k_split // unit
    assert per == -(-n_units // splits)
    counts = {-(-n_units // p) for p in range(1, n_units + 1)}
    lo, hi = -(-n_sm // col_blocks), max(1, 2 * n_sm // col_blocks)
    fit = [c for c in counts if lo <= c <= hi]
    if fit:
        assert splits in fit
        cost = {c: -(-col_blocks * c // n_sm) * -(-n_units // c) for c in fit}
        assert cost[splits] == min(cost.values())
        assert splits == min(c for c in fit if cost[c] == cost[splits])
    else:
        past = [c for c in counts if c >= lo]
        assert splits == (min(past) if past else n_units)
    if col_blocks * splits < n_sm:
        assert splits == n_units


@pytest.mark.parametrize("K,N", _DECODE_SHAPES)
@pytest.mark.parametrize("group", [None, 128])
def test_decode_split_fills_the_card_at_every_llama_decode_shape(K, N, group):
    splits, _ = decode_split(K, N, group or K, N_SM)
    assert -(-N // DECODE_BLOCK_N) * splits >= N_SM


def test_decode_split_plans_of_the_llama_layers():
    """The plans the card runs (132 SMs), as ``PERF.md`` cites them."""
    plans = {(K, N): decode_split(K, N, K, N_SM) for K, N in _DECODE_SHAPES}
    assert plans[(4096, 1024)] == (32, 128)
    assert plans[(4096, 4096)] == (8, 512)
    assert plans[(4096, 14336)] == (2, 2048)
    assert plans[(14336, 4096)] == (8, 1792)
    assert plans[(4096, _C.vocab_size)][0] == 1
    assert decode_split(4096, 1024, 128, N_SM) == (32, 128)


def test_decode_split_refuses_empty_calls():
    with pytest.raises(ValueError):
        decode_split(0, 1024, 64, N_SM)
    with pytest.raises(ValueError):
        decode_split(4096, 1024, 4096, 0)


# --- the plan, emulated, against the JAX kernels --------------------------------

def _emulate_decode(x: torch.Tensor, w, out_dtype, n_sm: int) -> torch.Tensor:
    """The decode body's arithmetic by its plan: each split's fp32 partial of
    x @ bf16(q * scale) over its K range, summed in split order, rounded to
    the output dtype once."""
    K = x.shape[-1]
    N = w.q.shape[1]
    group = K // w.scale.shape[0] if isinstance(w, tquant.Q4Tensor) else K
    w_deq = tquant.dequantize(w, torch.bfloat16).float()
    acc = None
    for k0, k1 in _spans(K, N, group, n_sm):
        part = x[:, k0:k1].float() @ w_deq[k0:k1]
        acc = part if acc is None else acc + part
    return acc.to(out_dtype)


# (M, K, N, mode, group, SMs): splits of whole tiles (K = 256 in 4 splits on
# 8 SMs), a split ending at K inside a tile (1056), groups of 8, 32 and 64
_EMULATED = [
    (5, 256, 128, "int8", 0, 8),
    (16, 1056, 144, "int8", 0, 40),
    (64, 512, 256, "int8", 0, 132),
    (7, 256, 96, "int4", 8, 8),
    (33, 1056, 128, "int4", 32, 132),
    (4, 512, 272, "int4", 64, 16),
    (8, 384, 128, "int4", 0, 16),
]


@pytest.mark.parametrize("case", _EMULATED, ids=[f"{c[3]}_g{c[4]}_{c[0]}x{c[1]}x{c[2]}_sm{c[5]}"
                                                 for c in _EMULATED])
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "fp32"])
def test_decode_plan_emulation_matches_jax_interpret(case, f32):
    M, K, N, mode, group, n_sm = case
    assert decode_split(K, N, group or K, n_sm)[0] > 1
    rng = np.random.default_rng(11)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x_t = torch.from_numpy(x).to(torch.bfloat16)
    x_j = jnp.asarray(x_t.float().numpy(), jnp.bfloat16)
    if mode == "int4":
        jw, tw = jquant.quantize_int4(jnp.asarray(w), group), tquant.quantize_int4(
            torch.from_numpy(w), group)
        kernel = jqmm.quant_matmul_int4
    else:
        jw, tw = jquant.quantize(jnp.asarray(w)), tquant.quantize(torch.from_numpy(w))
        kernel = jqmm.quant_matmul_int8
    out_t = torch.float32 if f32 else torch.bfloat16
    got = _emulate_decode(x_t, tw, out_t, n_sm).float().numpy()
    want = np.asarray(kernel(x_j, jw.q, jw.scale, interpret=True,
                             out_dtype=jnp.float32 if f32 else jnp.bfloat16)).astype(np.float32)
    diff = np.abs(got - want)
    if f32:
        w_deq = tquant.dequantize(tw, torch.bfloat16).float().numpy()
        limit = K * 2.0 ** -22 * (np.abs(x_t.float().numpy()) @ np.abs(w_deq))
    else:
        limit = 2.0 ** -7 * np.abs(want).max(-1, keepdims=True)
    assert (diff <= limit).all(), float((diff / np.maximum(limit, 1e-30)).max())
