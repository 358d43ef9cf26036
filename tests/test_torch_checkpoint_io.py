"""Native save/restore of the port's trees (``checkpoints/native_io.py``),
the counterpart of tests/test_checkpoint_io.py without Orbax: round trips of
fp32, bf16, ``QTensor`` and ``Q4Tensor`` trees, restoring onto another
dtype as ``like`` says, a mismatch named, ``force``, a save that fails
mid-write leaving the old checkpoint restorable, and a train resume after
two steps of ``tiny`` where one more step from the restored state equals
one more step from the original bit for bit."""

from __future__ import annotations

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

from finchat_tpu_torch.checkpoints import native_io, safetensors_io  # noqa: E402
from finchat_tpu_torch.checkpoints.native_io import (  # noqa: E402
    restore_pytree,
    restore_train_state,
    save_pytree,
    save_train_state,
)
from finchat_tpu_torch.models.llama import PRESETS, init_params  # noqa: E402
from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, quantize_llama_params  # noqa: E402
from finchat_tpu_torch.train.train_step import (  # noqa: E402
    init_train_state,
    make_optimizer,
    make_train_step,
    named_leaves,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the suite's other engine-backed files run:
    six workers' thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(dtype=torch.float32, seed=0):
    config = dataclasses.replace(PRESETS["tiny"], dtype=dtype)
    return config, init_params(config, torch.Generator().manual_seed(seed), "cpu")


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}/")
        elif isinstance(value, (QTensor, Q4Tensor)):
            yield f"{prefix}{name}.q", value.q
            yield f"{prefix}{name}.scale", value.scale
        else:
            yield prefix + name, value


def _bit_equal(a: dict, b: dict) -> bool:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    return list(la) == list(lb) and all(
        x.dtype == lb[n].dtype and x.shape == lb[n].shape
        and torch.equal(x.contiguous().view(torch.uint8), lb[n].contiguous().view(torch.uint8))
        for n, x in la.items())


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4", "int4_g32"])
def test_roundtrip(tmp_path, kind):
    config, params = _params(torch.bfloat16 if kind != "fp32" else torch.float32)
    if kind.startswith("int"):
        params = quantize_llama_params(params, mode=kind[:4], group_size=32 if "g32" in kind
                                       else 0)
    save_pytree(tmp_path / "ckpt", params)
    restored = restore_pytree(tmp_path / "ckpt", params)
    assert _bit_equal(restored, params)
    cls = {"int8": QTensor, "int4": Q4Tensor, "int4_g32": Q4Tensor}.get(kind)
    if cls is not None:
        assert type(restored["layers"]["attn_q"]) is cls and type(restored["lm_head"]) is cls
    # fresh tensors, not views of the file
    assert restored["embed"].data_ptr() != params["embed"].data_ptr()


def test_restore_onto_the_dtype_like_says(tmp_path):
    _c, params = _params(torch.float32)
    save_pytree(tmp_path / "ckpt", params)
    like = {**params, "embed": params["embed"].to(torch.bfloat16),
            "layers": {**params["layers"], "ln_attn": params["layers"]["ln_attn"].double()}}
    got = restore_pytree(tmp_path / "ckpt", like)
    assert got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["embed"], params["embed"].to(torch.bfloat16))
    assert got["layers"]["ln_attn"].dtype == torch.float64
    assert got["layers"]["mlp_up"].device == like["layers"]["mlp_up"].device


def test_a_mismatch_names_the_leaf(tmp_path):
    _c, params = _params()
    save_pytree(tmp_path / "ckpt", params)
    wrong = {**params, "layers": {**params["layers"], "attn_q": torch.zeros(2, 128, 64)}}
    with pytest.raises(ValueError, match="layers/attn_q"):
        restore_pytree(tmp_path / "ckpt", wrong)
    with pytest.raises(KeyError, match="extra"):
        restore_pytree(tmp_path / "ckpt", {**params, "extra": torch.zeros(1)})
    quantized = quantize_llama_params(params)
    with pytest.raises(ValueError, match="'layers/attn_q' is a tensor, the tree wants a QTensor"):
        restore_pytree(tmp_path / "ckpt", quantized)


def test_force(tmp_path):
    _c, params = _params(seed=1)
    save_pytree(tmp_path / "ckpt", params)
    with pytest.raises(ValueError, match="already exists"):
        save_pytree(tmp_path / "ckpt", params, force=False)
    _c, other = _params(seed=2)
    save_pytree(tmp_path / "ckpt", other)
    assert _bit_equal(restore_pytree(tmp_path / "ckpt", params), other)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_a_crashed_save_leaves_the_old_checkpoint(tmp_path, monkeypatch):
    _c, old = _params(seed=3)
    save_pytree(tmp_path / "ckpt", old)
    real = safetensors_io.save_file
    written = []

    def crashing(tensors, path, metadata=None):
        # write part of the new file, then fail as a lost process would
        written.append(path)
        with open(path, "wb") as f:
            f.write(b"\x00" * 64)
        raise OSError("No space left on device")

    monkeypatch.setattr(native_io, "save_file", crashing)
    _c, new = _params(seed=4)
    with pytest.raises(OSError, match="No space"):
        save_pytree(tmp_path / "ckpt", new)
    monkeypatch.setattr(native_io, "save_file", real)
    assert written and not written[0].exists()  # its temporary directory went with it
    assert _bit_equal(restore_pytree(tmp_path / "ckpt", old), old)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_train_state_resume_is_bit_exact(tmp_path):
    """Two steps of tiny, save, restore; one more step from each state gives
    the same loss, parameters and moments bit for bit."""
    torch.manual_seed(0)
    config, params = _params(seed=5)
    optimizer = make_optimizer()
    step = make_train_step(config, optimizer)
    state = init_train_state(config, params, optimizer)
    tokens = torch.randint(0, config.vocab_size, (2, 16), generator=torch.Generator()
                           .manual_seed(6))
    state, _ = step(state, tokens)
    state, _ = step(state, tokens)
    save_train_state(tmp_path, state)
    restored = restore_train_state(tmp_path, state)
    assert restored.step == state.step == 2
    assert _bit_equal(restored.params, {k: v for k, v in state.params.items()})
    restored, loss_r = step(restored, tokens)
    state, loss_o = step(state, tokens)
    assert restored.step == state.step == 3
    assert torch.equal(loss_r, loss_o)
    assert _bit_equal(restored.params, state.params)
    for (name, a), (_n, b) in zip(named_leaves(restored.params), named_leaves(state.params)):
        sa, sb = restored.opt_state.state[a], state.opt_state.state[b]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), (name, key)
