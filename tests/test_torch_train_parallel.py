"""The port's training over a mesh (``train/train_step.py`` with
``parallel/{mesh,sharding,collectives}.py``) against the JAX package, on
spawned gloo ranks.

One world of 8 CPU ranks is spawned for the file (``torch_train_ranks``:
they import only torch and the port) and every mesh is built over it:

- ``data=2 x model=2`` (ranks 0-3), a dense fp32 model: the loss and every
  leaf's gradient, gathered from the ranks' shards, against the JAX
  package's ``value_and_grad`` of the whole tree; three steps' losses
  against the JAX ``make_train_step`` (the same function GSPMD partitions);
- ``data=2 x expert=2 x model=2`` (all 8), the MoE config of
  tests/test_moe.py: the logits of ``test_moe_ep_sharded_matches_unsharded``
  against the JAX unsharded forward; the loss, gradients and three steps as
  above; ``test_moe_train_step_learns_ep_dp_tp``'s bf16 setup (losses
  falling), and the EP MoE step of ``__graft_entry__.dryrun_multichip``;
- every replicated leaf's gradient (embedding, norms, router) equal on every
  rank, and each sharded leaf's equal on the ranks holding the same shard;
- a one-rank mesh (rank 0) bit-equal to no mesh: loss, gradients, and the
  parameters after two steps, dense and MoE;
- ``row_parallel_dense``'s overlapped schedule byte-equal to its serial one
  under autograd, forward and both gradients (model=2, ranks 0-1).

The JAX side runs in the pytest process on its unsharded functions (the
oracle: a mesh changes only where GSPMD places the work), on its ``ref``
attention. Tolerances (fp32): the loss 1e-5 absolute; a leaf's gradient
``||got - want|| <= 1e-4 * ||want||`` (tests/test_torch_train.py's rule);
losses over three steps 1e-4 (AdamW at lr 1e-3, as there).

A one-device MoE step against the JAX one is in tests/test_torch_train.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.train import train_step as jtrain  # noqa: E402
from finchat_tpu_torch.parallel.mesh import make_abstract_mesh  # noqa: E402
from finchat_tpu_torch.parallel.sharding import llama_param_shardings  # noqa: E402
from torch_train_ranks import World, gather, numpy_tree  # noqa: E402

DENSE = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64,
             max_seq_len=32)
MOE = dict(DENSE, n_experts=4, top_k_experts=2)
# __graft_entry__.dryrun_multichip's EP step: its config (bf16), a data=2 x
# expert=2 x model=2 mesh on 8 devices, the default optimizer, two steps
DRYRUN_MOE = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64,
                  max_seq_len=32, n_experts=4, top_k_experts=2)
DP_TP, EP = (2, 1, 1, 1, 2), (2, 1, 1, 2, 2)
LR, STEPS = 1e-3, 3


def _tokens(seed: int, shape=(4, 16), vocab: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


CASES = {
    "dp_tp": dict(kind="train", sizes=DP_TP, ranks=(0, 1, 2, 3), cfg=DENSE,
                  tree=numpy_tree(DENSE, 0), tokens=_tokens(1), grads=True, lr=LR, steps=STEPS),
    "ep": dict(kind="train", sizes=EP, ranks=tuple(range(8)), cfg=MOE, tree=numpy_tree(MOE, 2),
               tokens=_tokens(3), logit_tokens=_tokens(4, (2, 16)), grads=True, lr=LR,
               steps=STEPS),
    "ep_learns": dict(kind="train", sizes=EP, ranks=tuple(range(8)), cfg=MOE,
                      tree=numpy_tree(MOE, 5), tokens=_tokens(6), dtype=torch.bfloat16, lr=1e-2,
                      steps=5),
    "ep_dryrun": dict(kind="train", sizes=EP, ranks=tuple(range(8)), cfg=DRYRUN_MOE,
                      tree=numpy_tree(DRYRUN_MOE, 7), tokens=_tokens(8), dtype=torch.bfloat16,
                      lr=1e-4, steps=2),
    "one_rank_dense": dict(kind="train", sizes=(1, 1, 1, 1, 1), ranks=(0,), cfg=DENSE,
                           tree=numpy_tree(DENSE, 9), tokens=_tokens(10), grads=True,
                           one_device=True, lr=1e-2, steps=2),
    "one_rank_moe": dict(kind="train", sizes=(1, 1, 1, 1, 1), ranks=(0,), cfg=MOE,
                         tree=numpy_tree(MOE, 11), tokens=_tokens(12), grads=True,
                         one_device=True, lr=1e-2, steps=2),
    "row_parallel_grad": dict(kind="row_parallel_grad", sizes=(1, 1, 1, 1, 2), ranks=(0, 1),
                              seed=13, shape=(2, 8, 64, 32), n_chunks=4),
}


@pytest.fixture(scope="module")
def runs():
    """The world's results, and the JAX oracle of the dp_tp and ep cases
    computed while the ranks run: the loss and every gradient of the whole
    tree, three steps' losses."""
    world = World(8, CASES)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FINCHAT_ATTN", "ref")  # the JAX step's backend, read at its build
            oracle = {case: _jax_oracle(CASES[case]) for case in ("dp_tp", "ep")}
        yield world.results(), oracle
    finally:
        world.close()


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


def _ranks(world, case: str) -> dict:
    return {r: res[case] for r, res in world.items() if case in res}


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


def _jax_cfg(cfg: dict, dtype=jnp.float32):
    return jllama.LlamaConfig(**cfg, dtype=dtype)


def _jax_params(tree: dict, dtype=jnp.float32):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.float32 if p[-1].key == "router" else dtype), tree)


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


def _gather(ranks: dict, key: str, want: dict, sizes: tuple) -> dict:
    """Each leaf's whole gradient placed from the ranks' shards."""
    specs = llama_param_shardings(make_abstract_mesh(sizes))
    flat = {**{k: v for k, v in specs.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in specs["layers"].items()}}
    return gather(ranks, key, want, sizes, flat)


def _assert_close(got: dict, want: dict, rel: float):
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        assert np.linalg.norm(got[path] - w) <= rel * np.linalg.norm(w) + 1e-30, path


def _jax_oracle(c: dict) -> tuple:
    jcfg = _jax_cfg(c["cfg"])
    jp = _jax_params(c["tree"])
    tokens = jnp.asarray(c["tokens"])
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(jcfg)))(jp, tokens)
    opt = jtrain.make_optimizer(learning_rate=c["lr"])
    state = jtrain.init_train_state(jcfg, jp, opt)
    step = jtrain.make_train_step(jcfg, opt)
    losses = []
    for _ in range(c["steps"]):
        state, step_loss = step(state, tokens)
        losses.append(float(step_loss))
    return float(loss), dict(_leaves(jax.device_get(grads))), losses


@pytest.mark.parametrize("case,sizes", [("dp_tp", DP_TP), ("ep", EP)])
def test_mesh_loss_and_gradients_match_jax(runs, case, sizes):
    """The global loss on every rank and every leaf's gradient gathered from
    the ranks' shards against the JAX ``value_and_grad`` of the whole tree."""
    world, oracle = runs
    jloss, jgrads, _ = oracle[case]
    ranks = _ranks(world, case)
    assert len(ranks) == math.prod(sizes)
    for res in ranks.values():
        assert abs(res["loss"].item() - jloss) <= 1e-5
    _assert_close(_gather(ranks, "grads", jgrads, sizes), jgrads, rel=1e-4)


@pytest.mark.parametrize("case", ["dp_tp", "ep"])
def test_mesh_step_losses_match_jax(runs, case):
    """Three AdamW steps of ``make_train_step`` over the mesh against the
    JAX ``make_train_step`` from the same weights and tokens."""
    world, oracle = runs
    _l, _g, jlosses = oracle[case]
    for res in _ranks(world, case).values():
        got = [x.item() for x in res["losses"]]
        np.testing.assert_allclose(got, jlosses, atol=1e-4)
        assert got[-1] < got[0]


def test_moe_ep_logits_match_jax_unsharded(world):
    """``test_moe_ep_sharded_matches_unsharded``'s mesh and config: the
    logits of the whole batch from every rank's shard against the JAX
    unsharded forward (fp32, 1e-4)."""
    c = CASES["ep"]
    jcfg = _jax_cfg(c["cfg"])
    tokens = jnp.asarray(c["logit_tokens"])
    positions = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
    want, _ = jllama.forward(_jax_params(c["tree"]), tokens, positions, config=jcfg,
                             attention=jllama.make_causal_attention("ref"))
    for res in _ranks(world, "ep").values():
        np.testing.assert_allclose(res["logits"].numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("case,lr,steps", [("ep_learns", 1e-2, 5), ("ep_dryrun", 1e-4, 2)])
def test_moe_ep_dp_tp_steps_learn(world, case, lr, steps):
    """``test_moe_train_step_learns_ep_dp_tp``'s setup (bf16, lr 1e-2, five
    steps: the loss falls) and the dryrun's EP step (its config, the
    default optimizer, two steps: finite and moving sanely), the loss equal
    on every rank."""
    ranks = _ranks(world, case)
    losses = [x.item() for x in ranks[0]["losses"]]
    assert len(losses) == steps and all(math.isfinite(x) for x in losses), losses
    if case == "ep_learns":
        assert losses[-1] < losses[0], losses
    else:
        assert losses[1] < losses[0] + 1.0, losses
    for res in ranks.values():
        assert [x.item() for x in res["losses"]] == losses


@pytest.mark.parametrize("case", ["dp_tp", "ep"])
def test_replicated_gradients_equal_on_every_rank(world, case):
    """Every replicated leaf's gradient (the embedding, the norms, the
    router) is bit-equal on every rank, and every sharded leaf's on the
    ranks that hold the same shard (a missing ``copy_to_group`` would leave
    a rank with only its part)."""
    ranks = _ranks(world, case)
    specs = llama_param_shardings(make_abstract_mesh(CASES[case]["sizes"]))
    by_shard: dict = {}
    for res in ranks.values():
        for path, g in _leaves(res["grads"]):
            spec = specs[path] if "/" not in path else specs["layers"][path.split("/")[1]]
            held = tuple(res["coords"][a] for a in ("expert", "model")
                         if any(a == e or (isinstance(e, tuple) and a in e) for e in spec))
            by_shard.setdefault((path, held), []).append(g)
    replicated = 0
    for (path, held), gs in by_shard.items():
        if not held:
            replicated += 1
            assert len(gs) == len(ranks), path
        assert all(torch.equal(gs[0], g) for g in gs[1:]), (path, held)
    assert replicated >= 4


@pytest.mark.parametrize("case", ["dp_tp", "ep"])
def test_collectives_are_counted(world, case):
    """The collectives one ``value_and_grad`` issues, by kind: per layer the
    column inputs' backward sums (attention, and the MLP or the experts'
    input and gates) and the head's; the MoE output's sum a layer (remat's
    recompute stops once the tensors the backward needs are back, before
    it); the row-parallel outputs, each again in the recompute (a custom
    node's saved tensors are back only once its forward has run); one data
    mean a leaf and one for the loss."""
    L = CASES[case]["cfg"]["n_layers"]
    moe = case == "ep"
    n_leaves = 12 if not moe else 13
    for res in _ranks(world, case).values():
        got = res["collectives"]
        want = {"copy_to_group": (3 * L if moe else 2 * L) + 1,
                "reduce_from_group": L if moe else 0, "mean_grads": n_leaves, "mean_over": 1,
                "row_parallel": 2 * L if moe else 4 * L, "logits_gather": 1}
        assert got == want


@pytest.mark.parametrize("case", ["one_rank_dense", "one_rank_moe"])
def test_one_rank_mesh_is_bit_equal_to_no_mesh(world, case):
    """A one-rank mesh (rank 0 of the world) against no mesh on the same
    rank: the loss, every gradient, two steps' losses and the parameters
    after them, bit for bit."""
    (res,) = _ranks(world, case).values()
    assert torch.equal(res["loss"], res["plain_loss"])
    plain = dict(_leaves(res["plain_grads"]))
    for path, g in _leaves(res["grads"]):
        assert torch.equal(g, plain[path]), path
    assert all(torch.equal(a, b) for a, b in zip(res["losses"], res["plain_losses"]))
    for path, p in res["params"].items():
        assert torch.equal(p, res["plain_params"][path]), path


def test_row_parallel_overlap_is_byte_equal_under_autograd(world):
    """``row_parallel_dense`` over model=2 with four chunks against the
    serial schedule, autograd on: the output and the gradients of the
    rank's input slice and weight shard, byte for byte."""
    for res in _ranks(world, "row_parallel_grad").values():
        for a, b in zip(res["serial"], res["overlap"]):
            assert torch.equal(a, b)
