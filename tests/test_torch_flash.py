"""K7's plain versions (``finchat_tpu_torch/ops/flash_attention.py``) against
the JAX package, on the CPU.

The port's kernel runs only on the card (tests/test_torch_cuda.py); here its
plain forward is held against the JAX Pallas kernel run as the JAX package's
own tests run it on the CPU (``interpret=True``, tests/test_pallas_attention.py's
cases), its log-sum-exp against one computed from JAX's reference logits, and
its plain backward against ``jax.grad`` of JAX's ``mha_reference`` — the
gradient the JAX package's train step computes, since its kernel has no
gradient rule (pinned below).

Inputs come from a seeded numpy generator and go to both packages.
Tolerances: the forward and the log-sum-exp at fp32 atol = rtol = 2e-5 (the
JAX tests' own interpret-mode tolerance), at bf16 2e-2 (one bf16 rounding of
each output plus the weights' cast); the backward at fp32 atol 1e-5 (the two
frameworks' fp32 einsums differ by ~1e-7 per element, summed over a few
hundred keys).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from finchat_tpu.ops.refs import NEG_INF, gqa_repeat  # noqa: E402
from finchat_tpu.ops.refs import mha_reference as jax_mha  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.ops import dispatch  # noqa: E402
from finchat_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_ref,
)
from finchat_tpu_torch.ops.refs import mha_reference  # noqa: E402

torch.set_float32_matmul_precision("highest")

# tests/test_pallas_attention.py's cases:
# (name, B, Sq, Sk, H, Hkv, D, causal, q_offset, kv_len, bf16)
CASES = [
    ("mha_square", 1, 128, 128, 4, 4, 64, True, None, None, False),
    ("gqa_kv_longer", 2, 64, 256, 8, 2, 64, True, None, None, False),
    ("mqa", 1, 256, 512, 4, 1, 128, True, None, None, False),
    ("q_offset_kv_len", 2, 64, 256, 4, 2, 64, True, [32, 100], [96, 164], False),
    ("non_causal", 1, 128, 128, 4, 4, 64, False, None, None, False),
    ("bf16", 1, 128, 128, 8, 4, 64, True, None, None, True),
]


def _inputs(case, seed: int):
    _name, B, Sq, Sk, H, Hkv, D, causal, q_off, kv_len, bf16 = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, H, D))]
    if bf16:  # both sides start from the same bf16 values
        arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    qo = None if q_off is None else np.asarray(q_off, np.int32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    return arrays, qo, kl, causal, bf16


def _torch(a, bf16: bool):
    t = torch.from_numpy(a)
    return t.bfloat16() if bf16 else t


def _jax(a, bf16: bool):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


def _opt(x, to):
    return None if x is None else to(x)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_ref_matches_jax_interpret_kernel(case):
    (q, k, v, _do), qo, kl, causal, bf16 = _inputs(case, seed=0)
    want = jax_flash(_jax(q, bf16), _jax(k, bf16), _jax(v, bf16),
                     q_offset=_opt(qo, jnp.asarray), kv_len=_opt(kl, jnp.asarray),
                     causal=causal, interpret=True)
    got, _lse = flash_attention_ref(_torch(q, bf16), _torch(k, bf16), _torch(v, bf16),
                                    q_offset=_opt(qo, torch.from_numpy),
                                    kv_len=_opt(kl, torch.from_numpy), causal=causal)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_ref_lse_matches_jax_logits(case):
    """The log-sum-exp over keys of JAX's reference logits (its
    ``mha_reference`` math: fp32 ``scale * q . k``, masked to ``NEG_INF``)."""
    (q, k, v, _do), qo, kl, causal, bf16 = _inputs(case, seed=1)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    logits = jnp.einsum("bqhd,bkhd->bhqk", _jax(q, bf16), gqa_repeat(_jax(k, bf16), H),
                        preferred_element_type=jnp.float32) * D ** -0.5
    kv_pos = jnp.arange(Sk)[None, None, None, :]
    q_pos = (0 if qo is None else jnp.asarray(qo)[:, None]) + jnp.arange(Sq)[None, :]
    mask = jnp.zeros((B, 1, Sq, Sk), bool)
    if causal:
        mask = mask | (kv_pos > jnp.broadcast_to(q_pos, (B, Sq))[:, None, :, None])
    if kl is not None:
        mask = mask | (kv_pos >= jnp.asarray(kl)[:, None, None, None])
    want = jax.nn.logsumexp(jnp.where(mask, NEG_INF, logits), axis=-1)
    _out, got = flash_attention_ref(_torch(q, bf16), _torch(k, bf16), _torch(v, bf16),
                                    q_offset=_opt(qo, torch.from_numpy),
                                    kv_len=_opt(kl, torch.from_numpy), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# fp32 backward cases: every row has a valid key (rows without one get no
# gradient in the kernel, while the reference averages over masked keys)
BWD = [c for c in CASES if not c[-1]]


@pytest.mark.parametrize("case", BWD, ids=[c[0] for c in BWD])
def test_flash_bwd_ref_matches_jax_grad_and_torch_autograd(case):
    (q, k, v, do), qo, kl, causal, _bf16 = _inputs(case, seed=2)
    jqo, jkl = _opt(qo, jnp.asarray), _opt(kl, jnp.asarray)

    def jax_loss(q_, k_, v_):
        out = jax_mha(q_, k_, v_, causal=causal, q_offset=0 if jqo is None else jqo, kv_len=jkl)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tqo, tkl = _opt(qo, torch.from_numpy), _opt(kl, torch.from_numpy)
    out, lse = flash_attention_ref(tq.detach(), tk.detach(), tv.detach(), q_offset=tqo,
                                   kv_len=tkl, causal=causal)
    got = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out, lse,
                                  torch.from_numpy(do), q_offset=tqo, kv_len=tkl, causal=causal)
    mha_reference(tq, tk, tv, causal=causal, q_offset=0 if tqo is None else tqo,
                  kv_len=tkl).backward(torch.from_numpy(do))
    for g, w, leaf in zip(got, want, (tq, tk, tv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_flash_bwd_ref_gives_rows_without_keys_no_gradient():
    """kv_len == 0: the kernel's rows are zeros, forward and backward; the
    plain backward gives them no gradient either."""
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((2, 8, 4, 32)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 32)).astype(np.float32))
            for _ in range(2))
    kl = torch.tensor([16, 0], dtype=torch.int32)
    out, lse = flash_attention_ref(q, k, v, kv_len=kl)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, do, kv_len=kl)
    assert all(bool((g[1] == 0).all()) for g in (dq, dk, dv))
    assert all(bool((g[0] != 0).any()) for g in (dq, dk, dv))


def test_jax_kernel_has_no_gradient_rule():
    """The reference-side finding this slice rests on: ``jax.grad`` through
    the JAX package's Pallas kernel raises, so its train step differentiates
    ``mha_reference``. If a later jax adds the rule, this test says so."""
    (q, k, v, _do), _qo, _kl, _causal, _bf16 = _inputs(CASES[0], seed=4)

    def loss(q_):
        return jnp.sum(jax_flash(q_, jnp.asarray(k), jnp.asarray(v), interpret=True))

    with pytest.raises(NotImplementedError):
        jax.grad(loss)(jnp.asarray(q))


def test_causal_attention_dispatch_on_cpu_is_the_plain_version():
    """``dispatch.causal_attention`` (and the model's
    ``make_causal_attention``) on CPU tensors: the plain forward, with plain
    autograd gradients equal to ``mha_reference``'s."""
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, 12, 4, 16), (1, 12, 2, 16), (1, 12, 2, 16))]
    a = [torch.from_numpy(x).requires_grad_() for x in arrays]
    b = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out, _cache = tllama.make_causal_attention()(*a, None, 0)
    want = mha_reference(*b, causal=True)
    assert torch.equal(out, want) and torch.equal(dispatch.causal_attention(*a), want)
    out.sum().backward()
    want.sum().backward()
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, k, i32, i32 + 8, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, k, q, torch.zeros((1, 4, 8)), q, i32, i32 + 8, causal=True,
                            scale=1.0)
