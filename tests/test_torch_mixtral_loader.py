"""The Mixtral branch of the port's HF loader (``checkpoints/hf_loader.py``)
against the JAX package's, on tests/test_mixtral_loader.py's fixture: a
seeded fp32 ``MixtralForCausalLM`` written by transformers in HF layout
(``config.json`` + ``model.safetensors``).

- Every port leaf is bit-equal to the JAX load, at fp32 and at bf16
  ``config.dtype``: the router ``[L, D, E]`` fp32 in both, the experts
  ``block_sparse_moe.experts.{e}.w1/w3/w2`` transposed and stacked to
  ``moe_gate``/``moe_up``/``moe_down`` ``[L, E, in, out]``.
- The int8 load (each expert leaf quantized one layer's ``[E, in, out]``
  slice at a time) is bit-equal to the JAX streamed int8 load, to the
  port's load-then-quantize, and at fp32 to the JAX load-then-quantize.
- Logits match transformers at the JAX test's tolerance and the JAX load's
  through the JAX ``forward_full`` at 1e-5.
- The mismatch errors carry the JAX loader's messages word for word: a
  dense config over the MoE checkpoint, another expert count or top-k, and
  an MoE config over a ``config.json`` without ``num_local_experts``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_mixtral_loader import HF_CFG, OUR_CFG  # noqa: E402
from test_torch_hf_loader import _bits, _flat, _from_jax  # noqa: E402

from finchat_tpu.checkpoints.hf_loader import load_llama_params as jax_load  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.quant import quantize_llama_params as jax_quantize  # noqa: E402
from finchat_tpu_torch.checkpoints.hf_loader import load_llama_params  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.quant import QTensor, quantize_llama_params  # noqa: E402

torch.set_float32_matmul_precision("highest")


def _tcfg(dtype: torch.dtype = torch.float32, **changes) -> tllama.LlamaConfig:
    fields = {f.name: getattr(OUR_CFG, f.name) for f in dataclasses.fields(OUR_CFG)
              if f.name != "dtype"}
    return tllama.LlamaConfig(**{**fields, **changes}, dtype=dtype)


def _jcfg(dtype=jnp.float32, **changes):
    return dataclasses.replace(OUR_CFG, dtype=dtype, **changes)


def assert_trees_bit_equal(got: dict, want: dict) -> None:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    for name in w:
        a, b = g[name], w[name]
        assert type(a) is type(b), name
        parts = ([("q", a.q, b.q), ("scale", a.scale, b.scale)] if isinstance(a, QTensor)
                 else [("", a, b)])
        for what, x, y in parts:
            assert x.dtype == y.dtype and x.shape == y.shape, (name, what, x.dtype, y.dtype)
            assert torch.equal(_bits(x), _bits(y)), (name, what)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, one_thread):
    """tests/test_mixtral_loader.py's fixture, as that file writes it."""
    from safetensors.numpy import save_file
    from transformers import MixtralConfig, MixtralForCausalLM

    path = tmp_path_factory.mktemp("mixtral_ckpt_port")
    torch.manual_seed(13)
    model = MixtralForCausalLM(MixtralConfig(**HF_CFG, attn_implementation="eager"))
    model.eval()
    tensors = {k: v.detach().to(torch.float32).numpy().copy()
               for k, v in model.state_dict().items()}
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(
        {**HF_CFG, "model_type": "mixtral", "architectures": ["MixtralForCausalLM"]}))
    return path, model, tensors


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaves_bit_equal_to_the_jax_load(checkpoint, dtype):
    path, _model, tensors = checkpoint
    got = load_llama_params(path, _tcfg(getattr(torch, dtype)), device="cpu")
    want = _from_jax(jax_load(str(path), _jcfg(getattr(jnp, dtype))))
    assert_trees_bit_equal(got, want)
    layers = got["layers"]
    assert layers["moe_gate"].shape == (2, 4, 64, 96)
    assert layers["moe_down"].shape == (2, 4, 96, 64)
    assert layers["router"].dtype == torch.float32 and layers["router"].shape == (2, 64, 4)
    assert not {"mlp_gate", "mlp_up", "mlp_down"} & set(layers)
    w1 = tensors["model.layers.1.block_sparse_moe.experts.3.w1.weight"]
    assert torch.equal(layers["moe_gate"][1, 3],
                       torch.from_numpy(w1).t().to(getattr(torch, dtype)))
    gate = tensors["model.layers.0.block_sparse_moe.gate.weight"]
    assert torch.equal(layers["router"][0], torch.from_numpy(gate).t())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_load_bit_equal_to_the_jax_streamed_load(checkpoint, dtype):
    path, _m, _t = checkpoint
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    streamed = load_llama_params(path, _tcfg(tdtype), device="cpu", quant="int8")
    layers = streamed["layers"]
    for name in ("attn_q", "moe_gate", "moe_up", "moe_down"):
        assert isinstance(layers[name], QTensor), name
    assert tuple(layers["moe_up"].scale.shape) == (2, 4, 96)
    assert layers["router"].dtype == torch.float32  # the router stays full precision
    assert_trees_bit_equal(streamed, _from_jax(jax_load(str(path), _jcfg(jdtype), quant="int8")))
    full = quantize_llama_params(load_llama_params(path, _tcfg(tdtype), device="cpu"))
    assert_trees_bit_equal(streamed, full)
    if dtype == "float32":
        assert_trees_bit_equal(streamed, _from_jax(jax_quantize(jax_load(str(path), _jcfg()))))


def test_logits_against_transformers_and_jax(checkpoint):
    path, model, _t = checkpoint
    params = load_llama_params(path, _tcfg(), device="cpu")
    ids = np.array([[5, 99, 23, 42, 7, 68, 11, 3]], np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
        ours, _ = tllama.forward(params, torch.from_numpy(ids), torch.arange(ids.shape[1])[None],
                                 config=_tcfg(), attention=tllama.dense_causal_attention)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-3, rtol=2e-3)
    jax_logits = np.asarray(jllama.forward_full(
        jax_load(str(path), _jcfg()), jnp.asarray(ids, jnp.int32), jnp.arange(ids.shape[1])[None],
        config=_jcfg(), attn_backend="ref"))
    np.testing.assert_allclose(ours.numpy(), jax_logits, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("changes,message", [
    (dict(n_experts=0), "checkpoint num_local_experts=4 != config 0; wrong preset?"),
    (dict(n_experts=8), "checkpoint num_local_experts=4 != config 8; wrong preset?"),
    (dict(top_k_experts=1), "checkpoint num_experts_per_tok=2 != config 1; wrong preset?"),
])
def test_mismatch_errors_carry_the_jax_messages(checkpoint, changes, message):
    path, _m, _t = checkpoint
    with pytest.raises(ValueError) as got:
        load_llama_params(path, _tcfg(**changes), device="cpu")
    with pytest.raises(ValueError) as want:
        jax_load(str(path), _jcfg(**changes))
    assert str(got.value) == str(want.value) == message


def test_moe_config_needs_num_local_experts(checkpoint, tmp_path):
    path, _m, _t = checkpoint
    shutil.copy(path / "model.safetensors", tmp_path / "model.safetensors")
    hf = {k: v for k, v in HF_CFG.items() if k != "num_local_experts"}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(ValueError) as got:
        load_llama_params(tmp_path, _tcfg(), device="cpu")
    with pytest.raises(ValueError) as want:
        jax_load(str(tmp_path), _jcfg())
    assert str(got.value) == str(want.value) == (
        "config expects an MoE checkpoint (n_experts=4) but config.json has no "
        "num_local_experts")
