"""The port's model, weight conversion and sampler against the JAX package.

Weights are made once by the JAX package's ``init_params`` and converted
with ``finchat_tpu_torch.models.convert.params_from_numpy`` (bit-exact), so
both forwards see the same numbers.

Tolerances and why:
- forward logits, fp32, ``atol=rtol=2e-4``: an fp32 matmul of width 512
  already differs by ~9e-5 between the two frameworks on this machine, and
  the differences compound through the layers.
- conversion: bit-exact at fp32 and bf16.
- greedy sampling: exact; stochastic sampling: distribution level only (the
  noise generators differ).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.sampler import sample as jax_sample  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu_torch.engine.sampler import CANDIDATES, sample  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402

torch.set_float32_matmul_precision("highest")


def params_to_numpy(tree):
    """Torch leaves back to numpy; bf16 leaves as their raw bits viewed as
    ``ml_dtypes.bfloat16`` (the JAX package's numpy bf16)."""
    import ml_dtypes

    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def port_config(jcfg, dtype) -> "tllama.LlamaConfig":
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return tllama.LlamaConfig(**fields, dtype=dtype)


def jax_params(preset: str, jdtype, seed: int = 0):
    jcfg = dataclasses.replace(jllama.PRESETS[preset], dtype=jdtype)
    params = jllama.init_params(jcfg, jax.random.key(seed))
    return jcfg, params, jax.device_get(params)


@pytest.mark.parametrize("preset", ["tiny", "mini"])
def test_forward_logits_fp32_match_jax(preset):
    """Full causal forward, fp32, same converted weights: atol=rtol=2e-4."""
    jcfg, jp, np_tree = jax_params(preset, jnp.float32)
    tcfg = port_config(jcfg, torch.float32)
    tp = params_from_numpy(np_tree, "cpu")
    rng = np.random.default_rng(0)
    B, S = 2, 24
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    positions = np.tile(np.arange(S, dtype=np.int32), (B, 1)) + np.asarray([[0], [5]], np.int32)
    want = jllama.forward_full(jp, jnp.asarray(tokens), jnp.asarray(positions), config=jcfg,
                               attn_backend="ref")
    got = tllama.forward_full(tp, torch.from_numpy(tokens), torch.from_numpy(positions),
                              config=tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("preset", ["tiny", "mini"])
def test_params_round_trip_bit_exact(preset, jdtype):
    """JAX tree -> torch -> numpy: every leaf's bits survive, at fp32 and
    bf16 (bf16 rides a uint16 view, never float32)."""
    _jcfg, _jp, np_tree = jax_params(preset, jdtype, seed=3)
    back = params_to_numpy(params_from_numpy(np_tree, "cpu"))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v

    want = dict(leaves(np_tree))
    got = dict(leaves(back))
    assert want.keys() == got.keys()
    for name, a in want.items():
        b = got[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("preset", ["tiny", "mini", "llama3-8b"])
def test_presets_and_param_count_match_jax(preset):
    jcfg = jllama.PRESETS[preset]
    tcfg = tllama.PRESETS[preset]
    assert port_config(jcfg, tcfg.dtype) == tcfg
    assert tllama.n_params(tcfg) == jllama.n_params(jcfg)


def test_init_params_layout_matches_jax():
    """Random init: the JAX tree's leaves, shapes and dtype, made directly in
    the model dtype on the requested device."""
    jcfg = jllama.PRESETS["tiny"]
    jp = jax.eval_shape(lambda k: jllama.init_params(jcfg, k), jax.random.key(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tllama.init_params(tllama.PRESETS["tiny"], gen, "cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for name in jp["layers"]:
        assert tuple(tp["layers"][name].shape) == jp["layers"][name].shape, name
        assert tp["layers"][name].dtype == torch.bfloat16
    fan_in = jcfg.dim
    std = tp["layers"]["attn_q"].float().std().item()
    assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    n_bytes = sum(t.numel() * t.element_size() for t in tp["layers"].values())
    n_bytes += sum(tp[k].numel() * tp[k].element_size() for k in ("embed", "norm", "lm_head"))
    assert n_bytes == 2 * tllama.n_params(tllama.PRESETS["tiny"])


def test_moe_config_raises():
    """An MoE config that routes to more experts than it has (or to none)
    is refused at init; a valid one builds the expert leaves and no dense
    MLP (tests/test_torch_moe.py holds the layer against the JAX one)."""
    for top_k in (0, 5):
        cfg = tllama.LlamaConfig(n_experts=4, top_k_experts=top_k)
        with pytest.raises(ValueError, match="top_k_experts"):
            tllama.init_params(cfg, torch.Generator(), "cpu")
    params = tllama.init_params(tllama.LlamaConfig(n_experts=4), torch.Generator(), "cpu")
    assert params["layers"]["moe_gate"].shape == (2, 4, 128, 256)
    assert params["layers"]["router"].dtype == torch.float32
    assert not {"mlp_gate", "mlp_up", "mlp_down"} & set(params["layers"])


def test_bf16_norm_and_silu_cast_order_match_jax():
    """bf16 rounding points: RMSNorm casts the normalized activations to
    bf16 BEFORE the weight multiply; RoPE runs in fp32 and casts once."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    got = tllama.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-5)
    want = jllama.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    q = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    pos = np.asarray([[0, 1, 2], [40, 41, 900]], np.int32)
    got = tllama.rope(torch.from_numpy(q).bfloat16(), torch.from_numpy(pos), 500_000.0)
    want = jllama.rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos), 500_000.0)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert diff.max() <= 2 ** -7 * np.abs(q).max()  # at most one bf16 ulp apart


def test_greedy_sampling_exact_vs_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    temp = np.zeros(6, np.float32)
    top_p = np.asarray([1, 1, 0.9, 1, 0.5, 1], np.float32)
    top_k = np.asarray([0, 5, 0, 0, 0, 100], np.int32)
    want = jax_sample(jnp.asarray(logits), jax.random.key(0), jnp.asarray(temp),
                      jnp.asarray(top_p), jnp.asarray(top_k))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = sample(torch.from_numpy(logits), gen, torch.from_numpy(temp), torch.from_numpy(top_p),
                 torch.from_numpy(top_k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("truncate", [False, True], ids=["full_vocab", "top_k"])
def test_stochastic_sampling_distribution_matches_jax(truncate):
    """Gumbel-argmax from a torch.Generator: the empirical token
    distribution agrees with the JAX sampler's (and with the softmax, or
    the top-k-renormalized softmax under truncation) within sampling noise
    (total variation < 0.05 over 4096 draws)."""
    V, B = 12, 4096
    base = np.linspace(2.0, -2.0, V).astype(np.float32)
    logits = np.tile(base, (B, 1))
    temp = np.full(B, 0.8, np.float32)
    top_p = np.ones(B, np.float32)
    top_k = np.full(B, 4 if truncate else 0, np.int32)
    expect = np.exp(base / 0.8)
    if truncate:
        expect[4:] = 0
    expect /= expect.sum()

    gen = torch.Generator()
    gen.manual_seed(1)
    ids_t = sample(torch.from_numpy(logits), gen,
                   *[torch.from_numpy(a) for a in (temp, top_p, top_k)]).numpy()
    ids_j = np.asarray(jax_sample(jnp.asarray(logits), jax.random.key(1), jnp.asarray(temp),
                                  jnp.asarray(top_p), jnp.asarray(top_k)))
    ft = np.bincount(ids_t, minlength=V) / B
    fj = np.bincount(ids_j, minlength=V) / B
    assert 0.5 * np.abs(ft - expect).sum() < 0.05
    assert 0.5 * np.abs(ft - fj).sum() < 0.05
    if truncate:
        assert ft[4:].sum() == 0
    assert CANDIDATES == 64
