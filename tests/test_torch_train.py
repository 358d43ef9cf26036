"""The port's training step against the JAX package's, on the CPU.

Weights are made by the JAX package's ``init_params`` at fp32 and converted
bit-exact (``models/convert.py``); tokens come from a seeded numpy
generator. The JAX step runs on its ``ref`` attention backend
(``FINCHAT_ATTN=ref``): its Pallas kernel has no gradient rule (see
tests/test_torch_flash.py), so the gradient the JAX package computes is that
of ``mha_reference``. On CPU tensors the port's attention is K7's plain
version, ``flash_attention_ref``, differentiated by plain autograd.

Tolerances and why:
- loss and gradients, fp32: the two frameworks' fp32 matmuls differ by
  ~1e-7 relative per product and the differences compound through the
  layers; a leaf's gradient is held per tensor to
  ``||got - want|| <= 1e-4 * ||want||``, the loss to 1e-5 absolute.
- the AdamW update on the same gradients: within 5 fp32 ulps a step of
  optax's, an ulp taken at the larger of the value and (for a parameter)
  the learning rate. ``torch.optim.AdamW`` and ``optax.adamw`` order the
  same arithmetic differently (decay before or after the Adam term, bias
  corrections folded into the step size or into the moments): each side
  rounds the parameter twice a step (half an ulp each) and its update, of
  size ~lr, a few times (observed: 6 ulps after two steps). It is held on
  its own because Adam's first step is ~``lr * sign(g)``: in an end-to-end
  parameter comparison a gradient element near zero flips sign on fp32
  noise and moves by 2 lr.
- remat on and off: bitwise (the recompute repeats the same CPU arithmetic).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.train import train_step as jtrain  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from finchat_tpu_torch.parallel.mesh import make_abstract_mesh  # noqa: E402
from finchat_tpu_torch.parallel.pipeline import pipeline_forward  # noqa: E402
from finchat_tpu_torch.parallel.sharding import shard_batch  # noqa: E402
from finchat_tpu_torch.train import train_step as ttrain  # noqa: E402

torch.set_float32_matmul_precision("highest")

B, S = 2, 24
LR = 1e-3  # larger than the default so three steps move the loss
ULPS_PER_STEP = 5


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


def _setup(preset: str, seed: int = 0):
    jcfg = dataclasses.replace(jllama.PRESETS[preset], dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(jcfg) if f.name != "dtype"},
                              dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.key(seed))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tokens


def _jax_loss(jcfg):
    """The JAX step's loss (train/train_step.py loss_fn) on the ref backend."""
    attention = jllama.make_causal_attention("ref")

    def loss_fn(params, tokens):
        positions = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
        logits, _ = jllama.forward(params, tokens, positions, config=jcfg, attention=attention,
                                   cache=None, remat=True)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], tokens[:, 1:])
        return ce.mean()

    return loss_fn


def _assert_tree_close(got, want, rel: float):
    want = dict(_leaves(want))
    for path, g in _leaves(got):
        w = np.asarray(want[path], np.float32)
        g = g.detach().numpy()
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w) + 1e-30, path


@pytest.mark.parametrize("preset", ["tiny", "mini"])
def test_loss_and_gradients_match_jax(preset):
    jcfg, tcfg, jp, tokens = _setup(preset)
    jloss, jgrads = jax.value_and_grad(_jax_loss(jcfg))(jp, jnp.asarray(tokens))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    loss, grads = ttrain.value_and_grad(tp, torch.from_numpy(tokens), config=tcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    _assert_tree_close(grads, jax.device_get(jgrads), rel=1e-4)


def test_loss_trajectory_matches_jax(monkeypatch):
    """Three steps of each package's ``make_train_step`` from the same
    weights and tokens."""
    monkeypatch.setenv("FINCHAT_ATTN", "ref")
    jcfg, tcfg, jp, tokens = _setup("tiny", seed=1)
    jopt = jtrain.make_optimizer(learning_rate=LR)
    jstate = jtrain.init_train_state(jcfg, jp, jopt)
    tstate = ttrain.init_train_state(tcfg, params_from_numpy(jax.device_get(jp), "cpu"),
                                     ttrain.make_optimizer(learning_rate=LR))
    jstep = jtrain.make_train_step(jcfg, jopt)
    tstep = ttrain.make_train_step(tcfg, ttrain.make_optimizer(learning_rate=LR))
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(tokens))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, torch.from_numpy(tokens))
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert tl[2] < tl[0] and tstate.step == 3 == int(jstate.step)


def test_adamw_update_matches_optax():
    """Two AdamW updates of every leaf on the same converted gradients:
    parameters and both moments within ``ULPS_PER_STEP`` fp32 ulps a step
    of optax's."""
    jcfg, tcfg, jp, tokens = _setup("tiny", seed=2)
    grads = jax.value_and_grad(_jax_loss(jcfg))(jp, jnp.asarray(tokens))[1]
    jopt = jtrain.make_optimizer(learning_rate=LR)
    jstate = jopt.init(jp)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    state = ttrain.init_train_state(tcfg, tp, ttrain.make_optimizer(learning_rate=LR))
    tg = dict(_leaves(params_from_numpy(jax.device_get(grads), "cpu")))
    for scale in (1.0, -0.5):  # a second step with other gradients
        g = jax.tree_util.tree_map(lambda x, s=scale: x * s, grads)
        updates, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for path, leaf in _leaves(tp):
            leaf.grad = tg[path] * scale
        state.opt_state.step()
    adam = jstate[0]
    params = dict(_leaves(tp))
    moments = {path: state.opt_state.state[leaf] for path, leaf in params.items()}
    # (JAX tree, the port's leaf for a path, the magnitude its sums round
    # against: a parameter near zero takes an update of ~lr)
    checks = ((jp, lambda p: params[p], LR),
              (adam.mu, lambda p: moments[p]["exp_avg"], 0.0),
              (adam.nu, lambda p: moments[p]["exp_avg_sq"], 0.0))
    for want_tree, pick, floor in checks:
        for path, w in _leaves(jax.device_get(want_tree)):
            got = pick(path).detach().numpy()
            mag = np.maximum(np.maximum(np.abs(w), np.abs(got)), floor).astype(np.float32)
            assert np.all(np.abs(got - w) <= 2 * ULPS_PER_STEP * np.spacing(mag)), path
    assert int(adam.count) == 2
    assert all(float(m["step"]) == 2.0 for m in moments.values())


def test_remat_on_and_off_agree_bitwise():
    _jcfg, tcfg, jp, tokens = _setup("tiny", seed=3)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    t = torch.from_numpy(tokens)
    loss_a, grads_a = ttrain.value_and_grad(tp, t, config=tcfg, remat=True)
    loss_b, grads_b = ttrain.value_and_grad(tp, t, config=tcfg, remat=False)
    assert torch.equal(loss_a, loss_b)
    b = dict(_leaves(grads_b))
    for path, g in _leaves(grads_a):
        assert torch.equal(g, b[path]), path


def test_jax_state_resumes_in_the_port(monkeypatch):
    """A JAX ``TrainState`` after one step, converted, takes the port's
    next step as JAX takes its own: the same loss on the same parameters,
    then parameters within the update tolerance and the step counts."""
    monkeypatch.setenv("FINCHAT_ATTN", "ref")
    jcfg, tcfg, jp, tokens = _setup("tiny", seed=4)
    jopt = jtrain.make_optimizer(learning_rate=LR)
    jstep = jtrain.make_train_step(jcfg, jopt)
    jstate, _ = jstep(jtrain.init_train_state(jcfg, jp, jopt), jnp.asarray(tokens))
    snapshot = jax.device_get(jstate)
    tstate = train_state_from_numpy(snapshot, "cpu", ttrain.make_optimizer(learning_rate=LR))
    assert tstate.step == 1
    for path, leaf in _leaves(tstate.params):
        want = dict(_leaves(snapshot.params))[path]
        np.testing.assert_array_equal(leaf.detach().numpy(), want)
        st = tstate.opt_state.state[leaf]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      dict(_leaves(snapshot.opt_state[0].mu))[path])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      dict(_leaves(snapshot.opt_state[0].nu))[path])
        assert float(st["step"]) == 1.0
    jstate, jloss = jstep(jstate, jnp.asarray(tokens))
    tstate, tloss = ttrain.make_train_step(tcfg, None)(tstate, torch.from_numpy(tokens))
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    assert tstate.step == 2 == int(jstate.step)
    # step 2 is no longer sign-like: mu / sqrt(nu) mixes two gradients, so
    # fp32 noise in a near-zero element moves its update by far less than lr
    _assert_tree_close(tstate.params, jax.device_get(jstate.params), rel=1e-4)


@pytest.mark.parametrize("kw", [dict(mesh=make_abstract_mesh((1, 1, 2, 1, 1))),
                                dict(use_ring_attention=True),
                                dict(use_ring_attention=True, sp_mode="ulysses")],
                         ids=["mesh", "ring", "ulysses"])
def test_planes_not_ported_are_refused(kw):
    """Sequence parallelism waits for A9c: ring and Ulysses attention, and
    a mesh with seq > 1 (any other mesh trains:
    tests/test_torch_train_parallel.py)."""
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        ttrain.make_train_step(tllama.PRESETS["tiny"], ttrain.make_optimizer(), **kw)


def test_moe_config_is_refused(monkeypatch):
    """A one-device MoE step runs (it was refused before MoE training was
    ported): the MoE config of tests/test_moe.py at fp32, the loss and every
    leaf's gradient against the JAX ``value_and_grad``, and three steps'
    losses against the JAX ``make_train_step``, under this test's rules."""
    monkeypatch.setenv("FINCHAT_ATTN", "ref")
    moe = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64,
               max_seq_len=32, n_experts=4, top_k_experts=2)
    jcfg = jllama.LlamaConfig(**moe, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**moe, dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.key(5))
    tokens = np.random.default_rng(5).integers(0, 64, (B, S)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(_jax_loss(jcfg))(jp, jnp.asarray(tokens))
    loss, grads = ttrain.value_and_grad(params_from_numpy(jax.device_get(jp), "cpu"),
                                        torch.from_numpy(tokens), config=tcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    _assert_tree_close(grads, jax.device_get(jgrads), rel=1e-4)
    jopt = jtrain.make_optimizer(learning_rate=LR)
    jstate, jstep = jtrain.init_train_state(jcfg, jp, jopt), jtrain.make_train_step(jcfg, jopt)
    tstate = ttrain.init_train_state(tcfg, params_from_numpy(jax.device_get(jp), "cpu"),
                                     ttrain.make_optimizer(learning_rate=LR))
    tstep = ttrain.make_train_step(tcfg, ttrain.make_optimizer(learning_rate=LR))
    jl, tl = [], []
    for _ in range(3):
        jstate, l1 = jstep(jstate, jnp.asarray(tokens))
        tstate, l2 = tstep(tstate, torch.from_numpy(tokens))
        jl.append(float(l1))
        tl.append(l2.item())
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert tl[2] < tl[0]


def _refuse_seq_step():
    ttrain.make_train_step(tllama.PRESETS["tiny"], ttrain.make_optimizer(),
                           make_abstract_mesh((2, 1, 2, 1, 1)))


def _refuse_seq_batch():
    shard_batch(torch.zeros((2, 8), dtype=torch.int32), make_abstract_mesh((1, 1, 1, 1, 1)),
                seq_sharded=True)


def _refuse_seq_pipeline():
    cfg = tllama.PRESETS["tiny"]
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    pipeline_forward({}, tokens, tokens, config=cfg, mesh=make_abstract_mesh((1, 2, 2, 1, 1)),
                     n_micro=1)


def _refuse_pipe_step():
    ttrain.make_train_step(tllama.PRESETS["tiny"], ttrain.make_optimizer(),
                           make_abstract_mesh((1, 2, 1, 1, 1)))


def _refuse_moe_app():
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.serve.app import build_app
    from finchat_tpu_torch.utils.config import load_config

    cfg = load_config(overrides={"model.preset": "moe-tiny", "mesh.model": 2})
    build_app(cfg, store=InMemoryStore(), kafka=KafkaClient(cfg.kafka, broker=InMemoryBroker()),
              retriever=lambda a: [], device="cpu")


@pytest.mark.parametrize("call,words", [
    (_refuse_seq_step, "seq=2: sequence parallelism"),
    (_refuse_seq_batch, "seq-sharded batch \\(sequence parallelism"),
    (_refuse_seq_pipeline, "seq=2: sequence parallelism"),
    (_refuse_pipe_step, "pipe=2: a pipelined step is parallel/pipeline.make_pipeline_train_step"),
    (_refuse_moe_app, "mesh: an MoE model is not served on a mesh"),
], ids=["seq_train_step", "seq_shard_batch", "seq_pipeline", "pipe_train_step", "moe_build_app"])
def test_planes_kept_for_later_are_refused_by_name(call, words):
    """What stays refused, matched by name: a mesh with seq > 1 in the train
    step, ``shard_batch`` and ``pipeline_forward`` (A9c); pipe > 1 in
    ``make_train_step`` (the pipeline step's); an MoE model on a mesh at
    ``build_app`` (serving MoE over a mesh is A item 4). No rank starts."""
    with pytest.raises(NotImplementedError, match=words):
        call()
    assert not torch.distributed.is_initialized()
