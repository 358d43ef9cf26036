"""Which hand-written kernel serves a fused dequant matmul call.

``ops/quant_matmul.kernel_for`` is a pure function of the call: the Hopper
kernel (``quant_matmul_{int8,int4}_sm90``, TMA + ``wgmma``) for more than 64
rows with bf16 output and operands TMA can read, v2
(``quant_matmul_{int8,int4}``) for every other call. These tests pin that
rule over the ``llama3-8b`` serving shapes — its seven per-layer weights at
prefill chunks and decode batches, and its fp32-logit head — and over the
edge cases the card tests also drive. No card is needed: only the choice is
tested here; ``tests/test_torch_cuda.py`` holds both kernels against the
plain version on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from finchat_tpu_torch.models.llama import PRESETS  # noqa: E402
from finchat_tpu_torch.ops import kernels  # noqa: E402
from finchat_tpu_torch.ops.quant_matmul import (  # noqa: E402
    kernel_for,
    quant_matmul_int4,
    quant_matmul_int8,
    run_kernel,
)

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
    K, N = _WEIGHTS[weight]
    assert kernel_for(mode, M, K, N, _group(K, group), out_f32=False) == f"quant_matmul_{mode}"


@pytest.mark.parametrize("mode,group", _MODES)
@pytest.mark.parametrize("M", _PREFILL_ROWS + _DECODE_ROWS)
def test_fp32_head_stays_on_v2(mode, group, M):
    K, N = _C.dim, _C.vocab_size
    assert kernel_for(mode, M, K, N, _group(K, group), out_f32=True) == f"quant_matmul_{mode}"


# (M, K, N, group rows, aligned, Hopper kernel?): the edges of the rule
_EDGES = [
    (64, 4096, 4096, 4096, True, False),    # the last decode row count
    (65, 4096, 4096, 4096, True, True),     # the first prefill row count
    (130, 512, 260, 512, True, False),      # N = 260: weight rows not 16-byte multiples
    (130, 512, 1040, 512, True, True),      # N a multiple of 16, not of 128
    (130, 200, 256, 200, True, True),       # K a multiple of 8, not of the 64-row tile
    (130, 196, 256, 196, True, False),      # K not a multiple of 8: x rows unaligned
    (300, 512, 384, 512, False, False),     # an operand off a 16-byte boundary
    (300, 512, 384, 8, True, True),         # int4 groups of 8 rows
    (300, 512, 384, 4, True, False),        # int4 groups of 4: a 16-byte chunk spans two
    (2048, 4096, 0, 4096, True, False),     # an empty weight
]


@pytest.mark.parametrize("case", _EDGES, ids=[f"M{c[0]}_K{c[1]}_N{c[2]}_g{c[3]}_a{int(c[4])}"
                                              for c in _EDGES])
def test_routing_edges(case):
    M, K, N, group, aligned, hopper = case
    for mode in ("int8", "int4"):
        want = f"quant_matmul_{mode}_sm90" if hopper else f"quant_matmul_{mode}"
        assert kernel_for(mode, M, K, N, group, out_f32=False, aligned=aligned) == want
        assert kernel_for(mode, M, K, N, group, out_f32=True, aligned=aligned) == \
            f"quant_matmul_{mode}"


def test_both_kernels_of_each_mode_are_registered():
    for mode in ("int8", "int4"):
        for name in (f"quant_matmul_{mode}", f"quant_matmul_{mode}_sm90"):
            assert name in kernels.KERNELS and name in kernels.LAUNCHES
    assert kernels.KERNELS["quant_matmul_int8_sm90"][0] == "quant_matmul_sm90.cu"
    assert "quant_matmul_sm90.cu" in kernels.SOURCES


def test_wrappers_refuse_cpu_tensors_before_routing():
    x = torch.zeros((128, 64), dtype=torch.bfloat16)
    q = torch.zeros((64, 128), dtype=torch.int8)
    for fn, scale in ((quant_matmul_int8, torch.ones(128)),
                      (quant_matmul_int4, torch.ones((1, 128)))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x, q[:32] if fn is quant_matmul_int4 else q, scale)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_kernel("quant_matmul_int8_sm90", x, q, torch.ones(128))
