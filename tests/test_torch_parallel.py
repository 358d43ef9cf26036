"""The port's mesh and sharding rules (``finchat_tpu_torch/parallel/``)
against the JAX package's, in process, with no rank spawned.

- ``MeshSpec.resolve`` on the cases of tests/test_parallel.py's
  ``test_mesh_spec_resolution`` (and a few more), the same sizes or the
  same ``ValueError`` as the JAX ``MeshSpec``; a rank's coordinates are the
  JAX mesh's device position of the same index; ``mesh_devices`` on the CPU.
- Each rank's shard of a param tree on the ``test_pipe_axis_tolerated_by_
  shardings`` mesh (pipe=2 x model=4), bf16, int8 and int4 at group 128,
  equals the JAX sharded array's ``addressable_shards`` entry on the device
  at the same coordinates. One named difference: a row-parallel int4 leaf's
  scale takes only its own groups (the JAX shard keeps every group). The
  decode state's shards likewise, with one more named difference: a rank's
  int8 scale rows sit in a block padded to ``scale_rows`` of its heads; and
  the TP engine's own pool has exactly that layout.
- The non-pipeline half of ``test_70b_shardings_fit_v5p16_mesh_shapes`` on
  ``make_abstract_mesh``: the spec tables equal the JAX package's, and
  every llama3-70b leaf shards with no forced replication.
- ``_fit_sharding``: replication with a warning below 256 MiB, a refusal
  above it, as the JAX package's.
- The planes a mesh does not serve are refused by name, before any rank
  starts (``build_app``) or at the engine (heads the axis does not divide,
  a gloo decode loop on the card).
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import create_state as jax_create_state  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models import quant as jquant  # noqa: E402
from finchat_tpu.parallel import sharding as jsharding  # noqa: E402
from finchat_tpu.parallel.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from finchat_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from finchat_tpu.parallel.mesh import make_abstract_mesh as jax_abstract_mesh  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import DecodeState, InferenceEngine, _place_tp  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import scale_rows  # noqa: E402
from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient  # noqa: E402
from finchat_tpu_torch.io.store import InMemoryStore  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.quant import Q4Tensor, QTensor  # noqa: E402
from finchat_tpu_torch.parallel import sharding  # noqa: E402
from finchat_tpu_torch.parallel.mesh import (  # noqa: E402
    AXES,
    Mesh,
    MeshSpec,
    make_abstract_mesh,
    mesh_devices,
)
from finchat_tpu_torch.serve import app as tapp  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig, load_config  # noqa: E402
from torch_tp_ranks import numpy_llama  # noqa: E402

# --- the mesh ---------------------------------------------------------------------------

SPEC_CASES = [
    (dict(data=2, model=-1), 8),
    (dict(data=1, seq=1, expert=1, model=8), 8),
    (dict(data=1, pipe=2, model=-1), 8),
    (dict(data=3, model=-1), 8),  # 8 % 3
    (dict(data=2, model=2), 8),  # product mismatch
    (dict(data=-1, model=-1), 8),  # two free axes
    (dict(model=-1), 1),
    (dict(pipe=2, model=4), 8),
    (dict(seq=2, expert=2, model=-1), 8),
]


@pytest.mark.parametrize("kw,n", SPEC_CASES)
def test_mesh_spec_resolution_matches_jax(kw, n):
    """The JAX test's cases and a few more: the same sizes, or a
    ``ValueError`` from both."""
    try:
        want = JaxMeshSpec(**kw).resolve(n)
    except ValueError:
        with pytest.raises(ValueError):
            MeshSpec(**kw).resolve(n)
        return
    assert MeshSpec(**kw).resolve(n) == want


@pytest.mark.parametrize("sizes", [(1, 2, 1, 1, 4), (2, 1, 1, 1, 4), (1, 1, 2, 2, 2)])
def test_rank_coordinates_are_the_jax_mesh_positions(sizes):
    """Rank r's coordinates are where the JAX mesh over 8 CPU devices puts
    device r (row-major over AXES, the model axis fastest)."""
    jm = jax_build_mesh(JaxMeshSpec(**dict(zip(AXES, sizes))))
    for rank in range(8):
        pos = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices) == rank)[0]
        assert make_abstract_mesh(sizes, rank=rank).coords == dict(zip(AXES, map(int, pos)))


@pytest.mark.parametrize("kw,n", [(dict(), 1), (dict(model=2), 2), (dict(data=2, model=-1), 2),
                                  (dict(pipe=2, model=4), 8)])
def test_mesh_devices_on_the_cpu(kw, n):
    """On the CPU a -1 axis absorbs 1 device (the default config stays
    unsharded) and a fixed mesh asks for its product in CPU ranks."""
    assert mesh_devices(MeshSpec(**kw), "cpu") == [torch.device("cpu")] * n


# --- shards against the JAX package's addressable shards ------------------------------

PIPE_CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=4, hidden_dim=64,
                max_seq_len=32)
# int4 at group 128: every row-parallel K shard (512 / 4, 1024 / 4) whole groups
INT4_CFG = dict(vocab_size=64, dim=512, n_layers=1, n_heads=4, n_kv_heads=4, hidden_dim=1024,
                max_seq_len=32)
PIPE_MESH = (1, 2, 1, 1, 4)
ROW_PARALLEL = {"attn_o", "mlp_down"}


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_build_mesh(JaxMeshSpec(**dict(zip(AXES, PIPE_MESH))))


def _coords_rank(mesh, device) -> int:
    pos = np.argwhere(np.vectorize(lambda d: d.id)(mesh.devices) == device.id)[0]
    return int(np.ravel_multi_index(tuple(pos), mesh.devices.shape))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _check_shards(jarr, local_of, name: str, own_groups: bool = False):
    """Every addressable shard of the JAX array against the port's slice at
    the same coordinates. ``own_groups``: the port's int4 row-parallel scale
    holds its own groups, the JAX shard all of them."""
    for shard in jarr.addressable_shards:
        mine = _np(local_of(_coords_rank(jarr.sharding.mesh, shard.device)))
        want = np.asarray(shard.data, np.float32 if mine.dtype == np.float32 else None)
        if own_groups:
            tp = want.shape[-2] // mine.shape[-2]
            assert tp == PIPE_MESH[-1], name
            m = make_abstract_mesh(PIPE_MESH, rank=_coords_rank(jarr.sharding.mesh,
                                                                shard.device)).coords["model"]
            g = mine.shape[-2]
            want = want[..., m * g:(m + 1) * g, :]
        np.testing.assert_array_equal(mine, want, err_msg=name)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_each_rank_shard_equals_the_jax_addressable_shard(mode, jax_mesh):
    """pipe=2 x model=4: every leaf of this rank's tree (``shard_params``)
    equals the JAX array's shard on the device at the same coordinates; a
    ``QTensor``'s scale follows the output axis; a row-parallel ``Q4Tensor``
    scale holds the rank's own groups (``[G/4, N]``), which are exactly its
    rows of the JAX shard's ``[G, N]``."""
    c = INT4_CFG if mode == "int4" else PIPE_CFG
    tree = numpy_llama(c["vocab_size"], c["dim"], c["n_layers"], c["n_heads"],
                       c["n_kv_heads"], c["hidden_dim"], 0)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    if mode != "bf16":
        jparams = jquant.quantize_llama_params(jparams, mode=mode,
                                               group_size=128 if mode == "int4" else 0)
    jsharded = jsharding.shard_params(jparams, jsharding.llama_param_shardings(jax_mesh))
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")
    specs = sharding.llama_param_shardings(make_abstract_mesh(PIPE_MESH))
    locals_ = {}

    def local(rank):
        if rank not in locals_:
            locals_[rank] = sharding.shard_params(tparams, specs,
                                                  make_abstract_mesh(PIPE_MESH, rank=rank))
        return locals_[rank]

    for name, leaf in _leaves(jsharded):
        if hasattr(leaf, "q"):
            cls = QTensor if mode == "int8" else Q4Tensor
            assert isinstance(_get(local(0), name), cls)
            _check_shards(leaf.q, lambda r: _get(local(r), name).q, name + ".q")
            rowpar = mode == "int4" and name.split("/")[-1] in ROW_PARALLEL
            _check_shards(leaf.scale, lambda r: _get(local(r), name).scale, name + ".scale",
                          own_groups=rowpar)
            if rowpar:
                G = leaf.scale.shape[-2]
                assert _get(local(0), name).scale.shape[-2] == G // 4  # the named difference
        else:
            _check_shards(leaf, lambda r: _get(local(r), name), name)
    for rank in range(8):
        for _n, t in _leaves({k: v for k, v in local(rank).items()}):
            parts = (t.q, t.scale) if isinstance(t, (QTensor, Q4Tensor)) else (t,)
            assert all(p.is_contiguous() for p in parts)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_decode_state_shards_equal_the_jax_shards(kv_quant, jax_mesh):
    """``shard_decode_state`` on the pipe=2 x model=4 mesh: the pages over
    the fused KV-head dim (Hkv = 8: two heads a rank) and the rest
    replicated, each equal to the JAX shard at the same coordinates; the
    int8 scale planes' live rows (a rank's two heads) equal the JAX shard's
    rows (Hkv % 8 == 0: it splits them too), in a block padded to
    ``scale_rows(2)`` = 8 rows whose padding is zero (the named
    difference)."""
    cfg = jllama.LlamaConfig(**{**PIPE_CFG, "n_heads": 8, "n_kv_heads": 8, "dim": 64})
    ecfg = JaxEngineConfig(max_seqs=2, page_size=8, num_pages=16, max_seq_len=32,
                           prefill_chunk=8, kv_quant=kv_quant)
    state = jax_create_state(cfg, ecfg, 4, kv_quant)
    rng = np.random.default_rng(0)
    fill = {f: rng.integers(-100, 100, np.shape(getattr(state, f))).astype(
        np.asarray(getattr(state, f)).dtype) for f in ("k_pages", "v_pages", "k_scales",
                                                       "v_scales", "page_table",
                                                       "context_lens")}
    state = dataclasses.replace(state, **{f: jnp.asarray(a) for f, a in fill.items()})
    jstate = jsharding.shard_decode_state(state, jax_mesh, cfg.n_kv_heads)
    host = {f: params_from_numpy(np.asarray(a), "cpu") for f, a in fill.items()}
    if not kv_quant:
        host["k_scales"] = host["v_scales"] = None
    tstate = DecodeState(last_tokens=torch.zeros(2, dtype=torch.int32),
                         kv_gaps=torch.zeros(2, dtype=torch.int32),
                         generator=torch.Generator(), **host)
    def local(r, f):
        return getattr(sharding.shard_decode_state(
            tstate, make_abstract_mesh(PIPE_MESH, rank=r), cfg.n_kv_heads), f)

    for f in ("k_pages", "v_pages", "page_table", "context_lens"):
        _check_shards(getattr(jstate, f), lambda r, f=f: local(r, f), f)
    for f in ("k_scales", "v_scales") if kv_quant else ():
        _check_shards(getattr(jstate, f), lambda r, f=f: local(r, f)[:, :, :2], f)
        for r in range(8):
            block = local(r, f)
            assert block.shape[2] == scale_rows(2) and not block[:, :, 2:].any()


def _spec_tuple(ns) -> tuple:
    return tuple(ns.spec)


def test_tp_pool_is_the_shard_of_the_one_device_pool():
    """The TP engine's pool (``PagedKVCache.create`` over a rank's heads)
    has the shapes and dtypes of ``shard_decode_state``'s cut of the
    one-device pool, bf16 and int8 (llama3-8b's 8 KV heads over 2 and 4)."""
    from finchat_tpu_torch.engine.kv_cache import PagedKVCache
    from finchat_tpu_torch.ops.tp_overlap import TPShard

    base = dataclasses.replace(tllama.PRESETS["llama3-8b"], n_layers=2)
    for tp in (2, 4):
        for kv_quant in ("", "int8"):
            one = PagedKVCache.create(base, 3, 16, "cpu", kv_quant)
            state = DecodeState(k_pages=one.k_pages, v_pages=one.v_pages,
                                k_scales=one.k_scales, v_scales=one.v_scales,
                                page_table=torch.zeros(1, 1, dtype=torch.int32),
                                context_lens=torch.zeros(1, dtype=torch.int32),
                                last_tokens=torch.zeros(1, dtype=torch.int32),
                                kv_gaps=torch.zeros(1, dtype=torch.int32),
                                generator=torch.Generator())
            cut = sharding.shard_decode_state(state, make_abstract_mesh((1, 1, 1, 1, tp),
                                                                        rank=tp - 1), 8)
            pool = PagedKVCache.create(
                dataclasses.replace(base, tp=TPShard(group=None, size=tp, rank=tp - 1)), 3, 16,
                "cpu", kv_quant)
            for f in ("k_pages", "v_pages", "k_scales", "v_scales"):
                a, b = getattr(cut, f), getattr(pool, f)
                assert (a is None and b is None) or (a.shape, a.dtype) == (b.shape, b.dtype), f


def test_spec_tables_equal_the_jax_tables():
    """``llama_param_shardings`` names the same axes a dim as the JAX
    package's; ``decode_state_shardings`` over model=4 too, at Hkv 8, and
    at Hkv 4 for the pages (the JAX package replicates the scale rows there,
    the port splits them by head: the named difference); at Hkv 6 the port
    refuses by name what the JAX package replicates."""
    jm = jax_abstract_mesh((1, 1, 1, 1, 4), AXES)
    mesh = make_abstract_mesh((1, 1, 1, 1, 4))
    want = jsharding.llama_param_shardings(jm)
    got = sharding.llama_param_shardings(mesh)
    for name, leaf in _leaves(want):
        assert _get(got, name) + (None,) * (len(leaf.spec) - len(_get(got, name))) \
            == _spec_tuple(leaf), name
    for hkv in (8, 4):
        want = jsharding.decode_state_shardings(jm, hkv)
        got = sharding.decode_state_shardings(mesh, hkv)
        for f, spec in got.items():
            if hkv == 4 and f in ("k_scales", "v_scales"):
                assert (_spec_tuple(want[f]), spec) == ((None,) * 4, (None, None, "model", None))
                continue
            assert spec[:len(want[f].spec)] == _spec_tuple(want[f]), (hkv, f)
    with pytest.raises(NotImplementedError, match="model=4 does not divide n_kv_heads=6"):
        sharding.decode_state_shardings(mesh, 6)


def test_70b_shardings_fit_the_data2_model8_mesh():
    """BASELINE config 5's mesh (data=2, model=8) on ``make_abstract_mesh``:
    every llama3-70b leaf and the KV pages divide, so ``_fit_sharding``
    keeps every axis (it would refuse to replicate any of these leaves,
    all above 256 MiB save the norms), and every rank's slice is the whole
    shape over the axis extents; no 70B weight is made."""
    c = tllama.PRESETS["llama3-70b"]
    mesh = make_abstract_mesh((2, 1, 1, 1, 8))
    L, D, H, Hkv, hd, F = c.n_layers, c.dim, c.n_heads, c.n_kv_heads, c.head_dim, c.hidden_dim
    shapes = {
        "embed": (c.vocab_size, D),
        "layers": {"attn_q": (L, D, H * hd), "attn_k": (L, D, Hkv * hd),
                   "attn_v": (L, D, Hkv * hd), "attn_o": (L, H * hd, D),
                   "mlp_gate": (L, D, F), "mlp_up": (L, D, F), "mlp_down": (L, F, D),
                   "ln_attn": (L, D), "ln_mlp": (L, D)},
        "norm": (D,),
        "lm_head": (D, c.vocab_size),
    }
    specs = sharding.llama_param_shardings(mesh)
    for name, shape in _leaves(shapes):
        spec = _get(specs, name)
        nbytes = 2 * math.prod(shape)
        fitted = sharding._fit_sharding(spec, shape, nbytes, mesh)
        assert fitted == tuple(spec) + (None,) * (len(shape) - len(spec)), name
    kv = sharding.decode_state_shardings(mesh, Hkv)
    assert (Hkv * hd) % mesh.shape["model"] == 0 and kv["k_pages"][-1] == "model"
    assert kv["k_scales"][2] == "model"  # Hkv % 8 == 0: the scale rows shard head-aligned


@pytest.mark.parametrize("dim,nbytes,kept", [(30, 1 << 10, False), (32, 1 << 10, True),
                                             (30, (256 << 20) + 1, None)])
def test_fit_sharding_replicates_small_and_refuses_large(dim, nbytes, kept, caplog):
    """A dim the model axis (8) does not divide replicates with a warning
    below 256 MiB and raises above it, as the JAX package's
    ``_fit_sharding``; a dividing dim keeps its axis."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    jm = jax_build_mesh(JaxMeshSpec(data=1, seq=1, expert=1, model=8))
    mesh = make_abstract_mesh((1, 1, 1, 1, 8))
    shape = (4, dim)
    if kept is None:
        with pytest.raises(ValueError, match="refusing to replicate"):
            jsharding._fit_sharding(NamedSharding(jm, P(None, "model")), shape, nbytes)
        with pytest.raises(ValueError, match="refusing to replicate"):
            sharding._fit_sharding((None, "model"), shape, nbytes, mesh)
        return
    want = _spec_tuple(jsharding._fit_sharding(NamedSharding(jm, P(None, "model")), shape,
                                               nbytes))
    got = sharding._fit_sharding((None, "model"), shape, nbytes, mesh)
    assert got == want + (None,) * (2 - len(want)) and (got[1] == "model") == kept
    if not kept:
        assert "replicating dim of size 30" in caplog.text


@pytest.mark.parametrize("quant", ["", "int8"])
def test_a_rank_loads_its_shard_one_leaf_at_a_time(quant, monkeypatch):
    """``_load_model_artifacts`` for rank 1 of model=2 cuts each leaf as it
    is made (``sharding.leaf_sharder``): the tree equals ``shard_params`` of
    the whole tree from the same seed, and whenever a leaf is cut, no whole
    leaf cut before it is still held, so a rank's peak is its shard plus one
    whole leaf, never the whole tree."""
    cfg = load_config(overrides={"model.preset": "tiny", "model.dtype": "float32",
                                 "model.quant": quant})
    mesh = make_abstract_mesh((1, 1, 1, 1, 2), rank=1)
    cut = sharding.shard_leaf
    whole: list = []

    def parts(x):
        return (x.q, x.scale) if isinstance(x, (QTensor, Q4Tensor)) else (x,)

    def spy(x, *args, **kwargs):
        held = [name for name, ref in whole if ref() is not None]
        assert not held, f"whole leaves still held when {kwargs.get('name')} is cut: {held}"
        out = cut(x, *args, **kwargs)
        kept = {id(p) for p in parts(out)}  # a replicated leaf is its own shard
        whole.extend((kwargs.get("name"), weakref.ref(p)) for p in parts(x) if id(p) not in kept)
        return out

    monkeypatch.setattr(sharding, "shard_leaf", spy)
    _c, local, _t, _d = tapp._load_model_artifacts(cfg, "cpu", mesh=mesh)
    monkeypatch.setattr(sharding, "shard_leaf", cut)
    assert whole  # the column- and row-parallel leaves were cut
    _c, full, _t, _d = tapp._load_model_artifacts(cfg, "cpu")
    want = sharding.shard_params(full, sharding.llama_param_shardings(mesh), mesh)
    got_leaves, want_leaves = dict(_leaves(local)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for name, w in want_leaves.items():
        for a, b in zip(parts(got_leaves[name]), parts(w)):
            assert torch.equal(a, b), name


def test_int4_row_parallel_groups_that_do_not_divide_are_refused():
    """A row-parallel int4 leaf whose groups the model axis does not divide
    is refused by name (never replicated silently)."""
    w = jquant.quantize_int4(jax.random.normal(jax.random.key(1), (2, 256, 64)), 128)
    leaf = params_from_numpy(jax.device_get(w), "cpu")  # G = 2 over model=4
    with pytest.raises(ValueError, match="mlp_down: its 2 scale groups do not divide"):
        sharding.shard_leaf(leaf, (None, "model", None), make_abstract_mesh((1, 1, 1, 1, 4)),
                            name="mlp_down")


# --- refusals ---------------------------------------------------------------------------

MESH_REFUSALS = {
    "data": ({"mesh.data": 2}, "pipeline, data and expert axes are"),
    "pipe": ({"mesh.pipe": 2}, "pipeline, data and expert axes are"),
    "expert": ({"mesh.expert": 2}, "pipeline, data and expert axes are"),
    # seq is served: a mesh with seq is still refused by name on its data axis
    "seq": ({"mesh.seq": 2, "mesh.data": 2}, "pipeline, data and expert axes are"),
    "moe": ({"model.preset": "moe-tiny"}, "MoE"),
    "fleet": ({"fleet.replicas": 2}, "fleet of 2"),
    "disagg": ({"fleet.replicas": 2, "fleet.roles": "prefill,decode"}, "fleet of 2"),
    "pod": ({"pod.host_id": "host-a"}, "pod plane"),
    "n_kv_heads": ({"mesh.model": 4}, "model=4 does not divide n_kv_heads=2"),
}


@pytest.mark.parametrize("case", list(MESH_REFUSALS))
def test_build_app_refuses_the_planes_a_mesh_does_not_serve(case):
    """Each plane kept for later (data, pipe and expert for the pipeline and
    expert parallelism, also beside a served seq axis, an MoE preset, a fleet
    or disagg of more than one replica, the pod plane, and a model axis that
    does not divide the KV heads) raises by name, with ``mesh`` in the
    message, before any rank is spawned."""
    overrides, words = MESH_REFUSALS[case]
    cfg = load_config(overrides={"model.preset": "tiny", "mesh.model": 2, **overrides})
    with pytest.raises(NotImplementedError, match="mesh") as err:
        tapp.build_app(cfg, store=InMemoryStore(),
                       kafka=KafkaClient(cfg.kafka, broker=InMemoryBroker()),
                       retriever=lambda a: [], device="cpu")
    assert words in str(err.value)
    assert not torch.distributed.is_initialized()


def _tiny():
    cfg = dataclasses.replace(tllama.PRESETS["tiny"], dtype=torch.float32)
    return cfg, tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("sizes,words", [
    ((1, 1, 1, 1, 4), "does not divide n_kv_heads=2"),
    ((1, 1, 1, 1, 3), "does not divide n_heads=4"),
    ((2, 1, 1, 1, 1), "pipeline, data and expert axes are not served yet"),
])
def test_engine_refuses_a_mesh_it_cannot_place(sizes, words):
    """The TP engine refuses by name a model axis that does not divide the
    heads or the KV heads, and any axis but model above 1."""
    cfg, params = _tiny()
    mesh = Mesh(tuple(sizes), rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(NotImplementedError, match=words):
        InferenceEngine(cfg, params, EngineConfig(max_seqs=2, num_pages=8, page_size=8),
                        mesh=mesh)


def test_engine_refuses_a_gloo_decode_loop_on_the_card():
    """A decode loop deeper than 1 over a gloo group on the card is refused
    by name: a gloo collective cannot be captured in the loop's CUDA
    graph."""
    cfg, params = _tiny()
    mesh = Mesh((1, 1, 1, 1, 2), rank=0, device=torch.device("cuda", 0), backend="gloo")
    with pytest.raises(NotImplementedError, match="gloo"):
        _place_tp(cfg, params, EngineConfig(decode_loop_depth=4), mesh, "", 0)
