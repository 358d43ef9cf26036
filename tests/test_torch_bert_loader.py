"""The port's BERT loader (``checkpoints/bert_loader.py``) against the JAX
package's, on tests/test_bert_loader.py's fixture (transformers writes a
seeded fp32 ``BertModel``): every leaf bit-equal to the JAX load (fp32 and
bf16), pooled embeddings under CLS and mean pooling against transformers'
hidden states (the JAX test's tolerance) and against the JAX load through
the JAX ``encode_batch``, a ``bert.``-prefixed export, and the
config-mismatch message."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from safetensors.torch import load_file  # noqa: E402
from test_bert_loader import HF_CFG, _our_config, bert_checkpoint  # noqa: E402,F401

from finchat_tpu.checkpoints.bert_loader import load_bert_params as jax_load  # noqa: E402
from finchat_tpu.embed.encoder import encode_batch as jax_encode  # noqa: E402
from finchat_tpu_torch.checkpoints.bert_loader import load_bert_params  # noqa: E402
from finchat_tpu_torch.checkpoints.safetensors_io import save_file  # noqa: E402
from finchat_tpu_torch.embed.encoder import BertConfig, encode_batch  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402

torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the suite's other engine-backed files run:
    six workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(pooling: str = "cls", dtype: torch.dtype = torch.float32, **changes) -> BertConfig:
    j = _our_config(pooling)
    fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "dtype"}
    return BertConfig(**{**fields, **changes}, dtype=dtype)


def _flat(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


def _assert_bit_equal(got: dict, want: dict) -> None:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].dtype == w[name].dtype and g[name].shape == w[name].shape, name
        assert torch.equal(g[name].contiguous().view(torch.uint8),
                           w[name].contiguous().view(torch.uint8)), name


def _batch():
    tokens = np.zeros((2, 9), np.int64)
    tokens[0] = [2, 17, 33, 80, 5, 9, 61, 44, 12]
    tokens[1, :7] = [2, 90, 4, 33, 17, 6, 1]
    return tokens, np.asarray([9, 7], np.int64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaves_bit_equal_to_the_jax_load(bert_checkpoint, dtype):
    path, _model = bert_checkpoint
    got = load_bert_params(path, _tcfg(dtype=getattr(torch, dtype)), device="cpu")
    jcfg = dataclasses.replace(_our_config("cls"), dtype=getattr(jnp, dtype))
    _assert_bit_equal(got, params_from_numpy(jax.device_get(jax_load(str(path), jcfg)), "cpu"))
    assert got["layers"]["qkv"].shape == (2, 48, 144) and got["layers"]["qkv_bias"].shape == (
        2, 144)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_pooled_embedding_against_transformers_and_jax(bert_checkpoint, pooling):
    path, model = bert_checkpoint
    cfg = _tcfg(pooling)
    params = load_bert_params(path, cfg, device="cpu")
    tokens, lengths = _batch()
    mask = (np.arange(9)[None, :] < lengths[:, None]).astype(np.int64)
    with torch.no_grad():
        hidden = model(input_ids=torch.from_numpy(tokens),
                       attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    if pooling == "cls":
        ref = hidden[:, 0, :]
    else:
        m = mask[:, :, None].astype(np.float32)
        ref = (hidden * m).sum(axis=1) / m.sum(axis=1)
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    ours = encode_batch(params, torch.from_numpy(tokens), torch.from_numpy(lengths),
                        config=cfg).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-3)
    jcfg = _our_config(pooling)
    jax_out = np.asarray(jax_encode(jax_load(str(path), jcfg), jnp.asarray(tokens, jnp.int32),
                                    jnp.asarray(lengths, jnp.int32), config=jcfg))
    np.testing.assert_allclose(ours, jax_out, atol=1e-5, rtol=1e-5)


def test_bert_prefix_is_stripped(bert_checkpoint, tmp_path):
    path, _model = bert_checkpoint
    tensors = load_file(path / "model.safetensors")
    save_file({f"bert.{n}": t for n, t in tensors.items()}, tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text((path / "config.json").read_text())
    _assert_bit_equal(load_bert_params(tmp_path, _tcfg(), device="cpu"),
                      load_bert_params(path, _tcfg(), device="cpu"))
    jcfg = _our_config("cls")
    _assert_bit_equal(load_bert_params(tmp_path, _tcfg(), device="cpu"),
                      params_from_numpy(jax.device_get(jax_load(str(tmp_path), jcfg)), "cpu"))


def test_config_mismatch_message_is_the_jax_one(bert_checkpoint):
    path, _model = bert_checkpoint
    with pytest.raises(ValueError) as got:
        load_bert_params(path, _tcfg(n_layers=5), device="cpu")
    with pytest.raises(ValueError) as want:
        jax_load(str(path), dataclasses.replace(_our_config("cls"), n_layers=5))
    assert str(got.value) == str(want.value) == \
        f"checkpoint num_hidden_layers={HF_CFG['num_hidden_layers']} != config 5; wrong preset?"
