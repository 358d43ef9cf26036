"""The port's HF Llama loader (``checkpoints/hf_loader.py``) against the JAX
package's on the same files.

The fixture is tests/test_hf_loader.py's: transformers writes a seeded fp32
``LlamaForCausalLM`` in HF layout (``config.json`` + ``model.safetensors``).
On it:

- every port leaf is bit-equal to the JAX load, at fp32 and at bf16
  ``config.dtype``;
- logits match transformers at the JAX test's tolerance and the JAX
  ``forward_full``;
- greedy decode through the port's ``InferenceEngine`` (chunked prefill,
  paged decode) gives torch's greedy ids exactly;
- the tied checkpoint, two shards equal to one, the config-mismatch
  message, the MoE refusals (the Mixtral branch itself:
  tests/test_torch_mixtral_loader.py);
- the streamed int8 / int4 loads (per column, and per group of 32: K is 64
  or 96 here, so 128 divides none) are bit-equal both to the port's
  load-then-quantize and to the JAX streamed load;
- a bf16 checkpoint (written by ``safetensors.torch``) loads bit-exact in
  the port and bit-equal to the JAX load (which reads it only because
  ``jax`` registers ``ml_dtypes.bfloat16`` with numpy; a process without
  ``ml_dtypes`` cannot read it through numpy at all).
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from safetensors.torch import save_file as st_save  # noqa: E402
from test_hf_loader import HF_CFG, OUR_CFG, _write_checkpoint  # noqa: E402

from finchat_tpu.checkpoints.hf_loader import load_llama_params as jax_load  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.quant import quantize_llama_params as jax_quantize  # noqa: E402
from finchat_tpu_torch.checkpoints.hf_loader import load_llama_params  # noqa: E402
from finchat_tpu_torch.checkpoints.safetensors_io import save_file  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, quantize_llama_params  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402

torch.set_float32_matmul_precision("highest")


def _tcfg(dtype: torch.dtype = torch.float32, **changes) -> tllama.LlamaConfig:
    fields = {f.name: getattr(OUR_CFG, f.name) for f in dataclasses.fields(OUR_CFG)
              if f.name != "dtype"}
    return tllama.LlamaConfig(**{**fields, **changes}, dtype=dtype)


def _jcfg(dtype=jnp.float32):
    return dataclasses.replace(OUR_CFG, dtype=dtype)


def _flat(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def assert_trees_bit_equal(got: dict, want: dict) -> None:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert list(g) == list(w) or sorted(g) == sorted(w)
    for name in w:
        a, b = g[name], w[name]
        assert type(a) is type(b), name
        parts = [("q", a.q, b.q), ("scale", a.scale, b.scale)] if isinstance(
            a, (QTensor, Q4Tensor)) else [("", a, b)]
        for what, x, y in parts:
            assert x.dtype == y.dtype and x.shape == y.shape, (name, what, x.dtype, y.dtype)
            assert torch.equal(_bits(x), _bits(y)), (name, what)


def _from_jax(tree) -> dict:
    return params_from_numpy(jax.device_get(tree), "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the suite's other engine-backed files run:
    six workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, one_thread):
    path = tmp_path_factory.mktemp("hf_ckpt_port")
    model, tensors = _write_checkpoint(path, tied=False)
    return path, model, tensors


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaves_bit_equal_to_the_jax_load(checkpoint, dtype):
    path, _model, tensors = checkpoint
    got = load_llama_params(path, _tcfg(getattr(torch, dtype)), device="cpu")
    want = _from_jax(jax_load(str(path), _jcfg(getattr(jnp, dtype))))
    assert_trees_bit_equal(got, want)
    assert got["layers"]["attn_q"].shape == (2, 64, 64) and got["lm_head"].shape == (64, 128)
    np.testing.assert_array_equal(got["layers"]["mlp_down"][1].float().numpy(),
                                  torch.from_numpy(tensors["model.layers.1.mlp.down_proj.weight"])
                                  .t().to(getattr(torch, dtype)).float().numpy())


def test_logits_against_transformers_and_jax(checkpoint):
    path, model, _tensors = checkpoint
    params = load_llama_params(path, _tcfg(), device="cpu")
    ids = np.array([[1, 5, 9, 42, 99, 17, 3, 64]], np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
        positions = torch.arange(ids.shape[1])[None]
        ours, _ = tllama.forward(params, torch.from_numpy(ids), positions, config=_tcfg(),
                                 attention=tllama.dense_causal_attention)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=2e-3)
    jparams = jax_load(str(path), _jcfg())
    jax_logits = np.asarray(jllama.forward_full(jparams, jnp.asarray(ids, jnp.int32),
                                                jnp.arange(ids.shape[1])[None], config=_jcfg(),
                                                attn_backend="ref"))
    np.testing.assert_allclose(ours.numpy(), jax_logits, atol=1e-5, rtol=1e-5)


def test_golden_greedy_decode_through_the_port_engine(checkpoint):
    """Greedy continuation through chunked prefill and paged decode equals
    torch's greedy loop token for token (the JAX test's golden case)."""
    path, model, _tensors = checkpoint
    params = load_llama_params(path, _tcfg(), device="cpu")
    prompt, n_new = [1, 5, 9, 42, 99], 12
    golden = []
    ids = torch.tensor([prompt], dtype=torch.long)
    with torch.no_grad():
        for _ in range(n_new):
            nxt = int(model(ids).logits[0, -1].argmax())
            golden.append(nxt)
            ids = torch.cat([ids, torch.tensor([[nxt]])], dim=1)
    engine = InferenceEngine(_tcfg(), params, EngineConfig(
        max_seqs=2, page_size=8, num_pages=32, max_seq_len=64, prefill_chunk=4), device="cpu")
    engine.set_page_table_row(0, list(range(1, 9)))
    first = int(engine.commit_first_token(0, engine.prefill(0, prompt), 0.0, 1.0, 0))
    got = [first]
    active = np.array([True, False])
    zeros, ones, topk = np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.int32)
    for _ in range(n_new - 1):
        toks = engine.decode(active, zeros, ones, topk)
        got.append(int(np.asarray(toks)[0]))
    assert got == golden, (got, golden)


def test_tied_checkpoint(tmp_path, one_thread):
    model, tensors = _write_checkpoint(tmp_path, tied=True)
    assert "lm_head.weight" not in tensors
    got = load_llama_params(tmp_path, _tcfg(), device="cpu")
    assert_trees_bit_equal(got, _from_jax(jax_load(str(tmp_path), _jcfg())))
    assert torch.equal(got["lm_head"], torch.from_numpy(tensors["model.embed_tokens.weight"]).t())
    ids = np.array([[2, 40, 77]], np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
        ours, _ = tllama.forward(got, torch.from_numpy(ids), torch.arange(3)[None],
                                 config=_tcfg(), attention=tllama.dense_causal_attention)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 0), ("int4", 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_quantized_load(checkpoint, mode, group, dtype):
    """Quantize-at-load equals the port's load-then-quantize and the JAX
    package's streamed load (int4 groups of 32 here: K is 64 or 96)."""
    path, _m, _t = checkpoint
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    streamed = load_llama_params(path, _tcfg(tdtype), device="cpu", quant=mode,
                                 quant_group=group)
    cls = Q4Tensor if mode == "int4" else QTensor
    assert isinstance(streamed["layers"]["mlp_gate"], cls) and isinstance(streamed["lm_head"], cls)
    assert isinstance(streamed["embed"], torch.Tensor)
    full = quantize_llama_params(load_llama_params(path, _tcfg(tdtype), device="cpu"),
                                 mode=mode, group_size=group)
    assert_trees_bit_equal(streamed, full)
    jax_streamed = jax_load(str(path), _jcfg(jdtype), quant=mode, quant_group=group)
    assert_trees_bit_equal(streamed, _from_jax(jax_streamed))
    if mode == "int8" and dtype == "float32":
        # and the JAX load-then-quantize, closing the square
        assert_trees_bit_equal(streamed, _from_jax(jax_quantize(jax_load(str(path), _jcfg()))))


def test_config_mismatch_message_is_the_jax_one(checkpoint):
    path, _m, _t = checkpoint
    wrong = _tcfg(n_layers=3)
    with pytest.raises(ValueError) as got:
        load_llama_params(path, wrong, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_load(str(path), dataclasses.replace(OUR_CFG, n_layers=3))
    assert str(got.value) == str(want.value) == \
        "checkpoint num_hidden_layers=2 != config 3; wrong preset?"


def test_two_shards_equal_one(checkpoint, tmp_path):
    path, _m, tensors = checkpoint
    names = sorted(tensors)
    half = len(names) // 2
    for k, part in enumerate((names[:half], names[half:])):
        save_file({n: torch.from_numpy(tensors[n]) for n in part},
                  tmp_path / f"model-{k + 1:05d}-of-00002.safetensors")
    shutil.copy(path / "config.json", tmp_path / "config.json")
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {}}))
    assert_trees_bit_equal(load_llama_params(tmp_path, _tcfg(), device="cpu"),
                           load_llama_params(path, _tcfg(), device="cpu"))
    assert_trees_bit_equal(load_llama_params(tmp_path, _tcfg(), device="cpu"),
                           _from_jax(jax_load(str(tmp_path), _jcfg())))


@pytest.fixture(scope="module")
def bf16_checkpoint(checkpoint, tmp_path_factory):
    path, _m, tensors = checkpoint
    out = tmp_path_factory.mktemp("hf_ckpt_bf16")
    bf16 = {n: torch.from_numpy(t).to(torch.bfloat16) for n, t in tensors.items()}
    st_save(bf16, str(out / "model.safetensors"), metadata={"format": "pt"})
    shutil.copy(path / "config.json", out / "config.json")
    return out, bf16


def test_bf16_checkpoint_loads_bit_exact_in_the_port(bf16_checkpoint):
    path, bf16 = bf16_checkpoint
    got = load_llama_params(path, _tcfg(torch.bfloat16), device="cpu")
    assert torch.equal(_bits(got["embed"]), _bits(bf16["model.embed_tokens.weight"]))
    for i in range(2):
        assert torch.equal(_bits(got["layers"]["attn_k"][i]),
                           _bits(bf16[f"model.layers.{i}.self_attn.k_proj.weight"].t()))
        assert torch.equal(_bits(got["layers"]["ln_mlp"][i]),
                           _bits(bf16[f"model.layers.{i}.post_attention_layernorm.weight"]))
    assert torch.equal(_bits(got["lm_head"]), _bits(bf16["lm_head.weight"].t()))
    # at fp32 the bf16 values widen exactly
    wide = load_llama_params(path, _tcfg(), device="cpu")
    assert torch.equal(wide["layers"]["mlp_up"][1],
                       bf16["model.layers.1.mlp.up_proj.weight"].t().float())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_checkpoint_equals_the_jax_load(bf16_checkpoint, dtype):
    """The JAX loader reads shards through ``safe_open(framework="numpy")``.
    Numpy alone has no bfloat16, but the JAX package imports ``jax``, which
    registers ``ml_dtypes.bfloat16`` with numpy, so the reference does load
    a bf16 checkpoint; the port's load of it is bit-equal to the JAX one."""
    path, _bf16 = bf16_checkpoint
    got = load_llama_params(path, _tcfg(getattr(torch, dtype)), device="cpu")
    assert_trees_bit_equal(got, _from_jax(jax_load(str(path), _jcfg(getattr(jnp, dtype)))))


def test_numpy_reader_needs_ml_dtypes_for_bf16(bf16_checkpoint):
    """In a process that has not imported ``ml_dtypes`` (nor ``jax``),
    ``safe_open(framework="numpy")`` cannot give a bf16 tensor: why the
    port reads the format with its own code instead of through numpy."""
    import subprocess
    import sys

    path, _bf16 = bf16_checkpoint
    code = ("import sys\n"
            "from safetensors import safe_open\n"
            f"f = safe_open({str(path / 'model.safetensors')!r}, framework='numpy')\n"
            "try:\n"
            "    f.get_tensor('model.norm.weight')\n"
            "except TypeError as e:\n"
            "    print('TypeError', e, 'ml_dtypes' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True,
                         env={"PATH": "", "PYTHONPATH": ":".join(p for p in sys.path if p)},
                         timeout=120)
    assert out.stdout.strip() == "TypeError data type 'bfloat16' not understood False", out


def test_moe_refusals(checkpoint, tmp_path):
    """An MoE config over a dense checkpoint, and a dense config over a
    checkpoint whose ``config.json`` names experts: the JAX loader's
    messages, word for word."""
    path, _m, _t = checkpoint
    with pytest.raises(ValueError) as got:
        load_llama_params(path, _tcfg(n_experts=8), device="cpu")
    with pytest.raises(ValueError) as want:
        jax_load(str(path), dataclasses.replace(_jcfg(), n_experts=8))
    assert str(got.value) == str(want.value) == (
        "config expects an MoE checkpoint (n_experts=8) but config.json has no "
        "num_local_experts")
    shutil.copy(path / "model.safetensors", tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps({**HF_CFG, "num_local_experts": 8}))
    with pytest.raises(ValueError) as got:
        load_llama_params(tmp_path, _tcfg(), device="cpu")
    with pytest.raises(ValueError) as want:
        jax_load(str(tmp_path), _jcfg())
    assert str(got.value) == str(want.value) == \
        "checkpoint num_local_experts=8 != config 0; wrong preset?"
