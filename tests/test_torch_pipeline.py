"""The port's stage pipeline (``parallel/pipeline.py``) against the JAX
package's, on the CPU.

In the pytest process, with no rank spawned:
- ``_stage_tp`` and ``_pipeline_layer_specs`` against the JAX functions on
  abstract meshes, the pipeline route of
  ``test_70b_shardings_fit_v5p16_mesh_shapes`` (llama3-70b on pipe=4 x
  model=4: in-stage TP 4) included, and the warn-and-replicate rule for an
  MoE model and for heads the axis does not divide;
- each rank's ``shard_params_for_pipeline`` leaf equal to the JAX array's
  shard on the device at the same coordinates (data=2 x pipe=2 x model=2
  over the 8 CPU devices).

One world of 8 gloo ranks (``torch_train_ranks``; they import only torch
and the port), one mesh over it: data=2 x pipe=2 x model=2, the config of
``test_pipeline_forward_matches_plain``:
- ``pipeline_forward`` for ``n_micro`` 1, 2 and 4 and with per-row
  position offsets ``[0, 3, 8, 1]`` at ``n_micro=4``, against the JAX plain
  forward (fp32, 1e-4), on every rank;
- the overlapped schedule (``tp_overlap``, four chunks) byte-equal to the
  serial one across the whole pipeline forward. The JAX package's own pair
  (``test_pipeline_forward_tp_overlap_matches_serial``) differs in 3,709 of
  4,096 elements by up to 2.65e-6; the port's does not differ;
- ``make_pipeline_train_step`` at fp32: the first step's gradient of every
  leaf, gathered from the stages' and ranks' slices, against the JAX
  ``value_and_grad`` of the plain loss (rel 1e-4 a leaf); three steps'
  losses against the JAX plain ``make_train_step`` (atol 1e-4, AdamW at lr
  1e-3) and falling; every replicated leaf's gradient equal on every rank;
- ``test_pipeline_train_step_learns``'s setup (bf16, lr 1e-2, five steps:
  the loss falls), and the pipeline step of
  ``__graft_entry__.dryrun_multichip`` (its config, in-stage TP 2, without
  its seq axis, which waits for sequence parallelism).
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
from finchat_tpu.parallel import pipeline as jpipeline  # noqa: E402
from finchat_tpu.parallel.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from finchat_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from finchat_tpu.parallel.mesh import make_abstract_mesh as jax_abstract_mesh  # noqa: E402
from finchat_tpu.train import train_step as jtrain  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.parallel import pipeline as tpipeline  # noqa: E402
from finchat_tpu_torch.parallel.mesh import AXES, make_abstract_mesh  # noqa: E402
from torch_train_ranks import World, gather, numpy_tree, torch_config, torch_tree  # noqa: E402

PIPE = dict(vocab_size=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2, hidden_dim=64,
            max_seq_len=32)
# __graft_entry__.dryrun_multichip's pipeline step at model=2: its config
# (bf16), n_micro=2, tokens (4, 16), the default optimizer, two steps
DRYRUN = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
              max_seq_len=64)
SIZES = (2, 2, 1, 1, 2)
B, S = 4, 16
LR, STEPS = 1e-3, 3


def _tokens(seed: int, vocab: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


POSITIONS = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
OFFSETS = (np.asarray([0, 3, 8, 1], np.int32)[:, None] + np.arange(S, dtype=np.int32)[None])
CASES = {
    "pp": dict(kind="pipeline", sizes=SIZES, ranks=tuple(range(8)), cfg=PIPE,
               tree=numpy_tree(PIPE, 0), tokens=_tokens(1),
               forwards={"n_micro_1": (1, POSITIONS, False), "n_micro_2": (2, POSITIONS, False),
                         "n_micro_4": (4, POSITIONS, False), "offsets": (4, OFFSETS, False),
                         "overlap": (2, POSITIONS, True)},
               n_micro=2, lr=LR, steps=STEPS),
    "pp_learns": dict(kind="pipeline", sizes=SIZES, ranks=tuple(range(8)), cfg=PIPE,
                      tree=numpy_tree(PIPE, 2), tokens=_tokens(3), dtype=torch.bfloat16,
                      n_micro=2, lr=1e-2, steps=5),
    "pp_dryrun": dict(kind="pipeline", sizes=SIZES, ranks=tuple(range(8)), cfg=DRYRUN,
                      tree=numpy_tree(DRYRUN, 4), tokens=_tokens(5, 128), dtype=torch.bfloat16,
                      n_micro=2, lr=1e-4, steps=2),
}


@pytest.fixture(scope="module")
def runs():
    """The world's results, and the JAX oracle of the ``pp`` case computed
    while the ranks run: the plain forward at each positions, the first
    step's loss and gradients, three plain steps' losses."""
    world = World(8, CASES)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FINCHAT_ATTN", "ref")  # the JAX step's backend, read at its build
            oracle = _jax_oracle(CASES["pp"])
        yield world.results(), oracle
    finally:
        world.close()


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


def _jax_cfg(cfg: dict, dtype=jnp.float32):
    return jllama.LlamaConfig(**cfg, dtype=dtype)


def _jax_oracle(c: dict) -> dict:
    jcfg = _jax_cfg(c["cfg"])
    params = jax.tree.map(jnp.asarray, c["tree"])
    tokens = jnp.asarray(c["tokens"])
    attention = jllama.make_causal_attention("ref")

    def logits(params, positions):
        return jllama.forward(params, tokens, positions, config=jcfg, attention=attention)[0]

    def loss_fn(params, tokens):
        positions = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
        out, _ = jllama.forward(params, tokens, positions, config=jcfg, attention=attention)
        return optax.softmax_cross_entropy_with_integer_labels(out[:, :-1], tokens[:, 1:]).mean()

    fwd = jax.jit(logits)
    out = {"positions": np.asarray(fwd(params, jnp.asarray(POSITIONS))),
           "offsets": np.asarray(fwd(params, jnp.asarray(OFFSETS)))}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, tokens)
    grads = dict(_leaves(jax.device_get(grads)))
    opt = jtrain.make_optimizer(learning_rate=c["lr"])
    state = jtrain.init_train_state(jcfg, params, opt)
    step = jtrain.make_train_step(jcfg, opt)  # donates the state: params are gone after it
    losses = []
    for _ in range(c["steps"]):
        state, step_loss = step(state, tokens)
        losses.append(float(step_loss))
    return dict(logits=out, loss=float(loss), grads=grads, losses=losses)


# --- the stage rules and the placement, no rank spawned ---------------------------------

STAGE_CASES = [
    (PIPE, (2, 2, 1, 1, 2)),
    (PIPE, (1, 2, 1, 1, 4)),  # n_kv_heads 2 over model=4: replicated, with a warning
    (PIPE, (1, 2, 1, 1, 1)),
    (dict(PIPE, n_experts=4, top_k_experts=2), (1, 2, 1, 1, 2)),  # MoE: replicated
    (dict(PIPE, n_heads=6, n_kv_heads=6, dim=48), (1, 2, 1, 1, 4)),  # heads: replicated
]


@pytest.mark.parametrize("cfg,sizes", STAGE_CASES)
def test_stage_tp_and_specs_equal_the_jax_rules(cfg, sizes, caplog):
    """``_stage_tp`` and ``_pipeline_layer_specs`` give the JAX functions'
    results on the same abstract mesh, the warning included."""
    jm = jax_abstract_mesh(sizes, AXES)
    want = jpipeline._stage_tp(_jax_cfg(cfg), jm)
    warned = "in-stage TP disabled" in caplog.text
    caplog.clear()
    got = tpipeline._stage_tp(torch_config(cfg, torch.float32), make_abstract_mesh(sizes))
    assert got == want and ("in-stage TP disabled" in caplog.text) == warned
    layers = numpy_tree(cfg, 0)["layers"]
    jspecs = jpipeline._pipeline_layer_specs(layers, want)
    for name, spec in tpipeline._pipeline_layer_specs(layers, got).items():
        assert spec == tuple(jspecs[name]), name


def test_70b_pipeline_route_matches_jax():
    """The pipeline route of ``test_70b_shardings_fit_v5p16_mesh_shapes``:
    llama3-70b on pipe=4 x model=4, in-stage TP 4, the specs equal to the
    JAX ones and every layer leaf divides its stage and TP extents."""
    c = tllama.PRESETS["llama3-70b"]
    sizes = (1, 4, 1, 1, 4)
    mesh = make_abstract_mesh(sizes)
    tp = tpipeline._stage_tp(c, mesh)
    assert tp == 4 == jpipeline._stage_tp(jllama.PRESETS["llama3-70b"],
                                          jax_abstract_mesh(sizes, AXES))
    L, D, H, Hkv, hd, F = c.n_layers, c.dim, c.n_heads, c.n_kv_heads, c.head_dim, c.hidden_dim
    shapes = {"attn_q": (L, D, H * hd), "attn_k": (L, D, Hkv * hd), "attn_v": (L, D, Hkv * hd),
              "attn_o": (L, H * hd, D), "mlp_gate": (L, D, F), "mlp_up": (L, D, F),
              "mlp_down": (L, F, D), "ln_attn": (L, D), "ln_mlp": (L, D)}
    specs = tpipeline._pipeline_layer_specs(shapes, tp)
    jspecs = jpipeline._pipeline_layer_specs(shapes, tp)
    assert specs["attn_q"] == ("pipe", None, "model") and specs["mlp_down"] == ("pipe", "model",
                                                                                None)
    for name, shape in shapes.items():
        assert specs[name] == tuple(jspecs[name]), name
        for dim, entry in zip(shape, specs[name]):
            if entry is not None:
                assert dim % mesh.shape[entry] == 0, name


def test_each_rank_pipeline_shard_equals_the_jax_shard():
    """data=2 x pipe=2 x model=2: every leaf of each rank's
    ``shard_params_for_pipeline`` equals the JAX sharded array's shard on
    the device at the same coordinates (a stage's layers with their
    Megatron slices; the embedding, the norm and the head whole)."""
    jm = jax_build_mesh(JaxMeshSpec(**dict(zip(AXES, SIZES))))
    tree = numpy_tree(PIPE, 0)
    jsharded = jpipeline.shard_params_for_pipeline(jax.tree.map(jnp.asarray, tree), jm,
                                                   _jax_cfg(PIPE))
    cfg = torch_config(PIPE, torch.float32)
    local = {r: tpipeline.shard_params_for_pipeline(torch_tree(tree, torch.float32),
                                                    make_abstract_mesh(SIZES, rank=r), cfg)
             for r in range(8)}
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for path, leaf in _leaves(jsharded):
        for shard in leaf.addressable_shards:
            pos = tuple(int(i) for i in np.argwhere(ids == shard.device.id)[0])
            rank = int(np.ravel_multi_index(pos, ids.shape))
            got = dict(_leaves(local[rank]))[path]
            assert got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data), err_msg=path)


# --- the spawned world -------------------------------------------------------------------

@pytest.mark.parametrize("key,want", [("n_micro_1", "positions"), ("n_micro_2", "positions"),
                                      ("n_micro_4", "positions"), ("offsets", "offsets")])
def test_pipeline_forward_matches_plain(runs, key, want):
    """``test_pipeline_forward_matches_plain`` at data=2 x pipe=2 x model=2:
    every rank's logits (the last stage's, broadcast over pipe, the data
    slices gathered) against the JAX plain forward, each microbatch with
    its own positions."""
    world, oracle = runs
    for res in world.values():
        np.testing.assert_allclose(res["pp"][key].numpy(), oracle["logits"][want], atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_pipeline_forward_tp_overlap_is_byte_equal(world):
    """The overlapped schedule (four chunks a row-parallel output) against
    the serial one across the whole pipeline forward at fp32, byte for
    byte, on every rank (the JAX package's own pair differs by up to
    2.65e-6: its seed failure)."""
    for res in world.values():
        assert torch.equal(res["pp"]["overlap"], res["pp"]["n_micro_2"])


def _pipeline_specs(layers: dict) -> dict:
    specs = {f"layers/{k}": v for k, v in tpipeline._pipeline_layer_specs(layers, 2).items()}
    return {**specs, "embed": (), "norm": (), "lm_head": ()}


def test_pipeline_gradients_match_jax(runs):
    """The first step's gradient of every leaf, gathered from the ranks'
    slices (a stage's layers and their Megatron slices; the replicated
    leaves' summed over pipe, everything averaged over data), against the
    JAX ``value_and_grad`` of the plain loss, and the loss of that step."""
    world, oracle = runs
    want = oracle["grads"]
    ranks = {r: res["pp"] for r, res in world.items()}
    got = gather(ranks, "grads", want, SIZES, _pipeline_specs(CASES["pp"]["tree"]["layers"]))
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        assert np.linalg.norm(got[path] - w) <= 1e-4 * np.linalg.norm(w), path
    for res in ranks.values():
        assert abs(res["losses"][0].item() - oracle["loss"]) <= 1e-5


def test_pipeline_step_losses_match_jax_plain_step(runs):
    """Three AdamW steps of ``make_pipeline_train_step`` (n_micro=2)
    against the JAX plain ``make_train_step`` from the same weights and
    tokens; the loss falls and is the same on every rank."""
    world, oracle = runs
    for res in world.values():
        got = [x.item() for x in res["pp"]["losses"]]
        np.testing.assert_allclose(got, oracle["losses"], atol=1e-4)
        assert got[-1] < got[0]


def test_pipeline_replicated_gradients_equal_on_every_rank(world):
    """The embedding's, the final norm's and the head's gradients (summed
    over pipe) are bit-equal on every rank; a stage's layer leaves on the
    ranks holding the same slice (its norms on both TP ranks)."""
    by_slice: dict = {}
    specs = _pipeline_specs(CASES["pp"]["tree"]["layers"])
    for res in world.values():
        for path, g in res["pp"]["grads"].items():
            held = tuple(res["pp"]["coords"][a] for a in ("pipe", "model") if a in specs[path])
            by_slice.setdefault((path, held), []).append(g)
    for (path, held), gs in by_slice.items():
        if path in ("embed", "norm", "lm_head"):
            assert len(gs) == 8, path
        assert all(torch.equal(gs[0], g) for g in gs[1:]), (path, held)


@pytest.mark.parametrize("case", ["pp_learns", "pp_dryrun"])
def test_pipeline_train_step_learns(world, case):
    """``test_pipeline_train_step_learns``'s setup (bf16, lr 1e-2, five
    steps: the loss falls) and the dryrun's pipeline step (two steps,
    finite, moving sanely); the loss equal on every rank."""
    losses = [x.item() for x in world[0][case]["losses"]]
    assert len(losses) == CASES[case]["steps"] and all(math.isfinite(x) for x in losses)
    if case == "pp_learns":
        assert losses[-1] < losses[0], losses
    else:
        assert losses[1] < losses[0] + 1.0, losses
    for res in world.values():
        assert [x.item() for x in res[case]["losses"]] == losses
