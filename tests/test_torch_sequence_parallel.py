"""The port's sequence parallelism (``ops/ring_attention.py``,
``ops/ulysses.py``, the seq-sharded prefill of ``engine/engine.py``) against
the JAX package, on spawned gloo ranks.

One world of 8 CPU ranks is spawned for the file (``torch_sp_ranks``: they
import only torch and the port) and every mesh is built over it; the JAX
side runs on its 8-device CPU mesh while the ranks run (its engines in three
spawned processes, its ops in the pytest process), at fp32:

- ``ring_attention`` (seq=8) and ``ulysses_attention`` (data=2 x seq=4, MHA
  and GQA) at ``tests/test_parallel.py``'s shapes, causal and full, and their
  prefix variants (a padded cached prefix), against the JAX ``mha_reference``
  (over the prefix and the segment for those) and the JAX ops themselves
  (the causal ring, its prefix variant, causal GQA Ulysses) within 1e-4; the
  collectives each issued;
- the engine at the configs of ``test_ring_prefill_serving_matches_chunked``
  and ``test_segmented_ring_prefill_matches_monolithic`` (seq=2 x model=4),
  ``test_ulysses_serving_prefill_matches_chunked`` (seq=2 x model=2, and its
  fallback to ring at seq=2 x model=4) and ``tests/test_kv_quant.py``'s two
  int8-KV ring tests: ``prefill_ring`` (through the routed ``prefill``) and
  ``prefill_ring_segment`` give the JAX engine's last-token logits on the
  same mesh shape within 1e-4 and its greedy continuation, equal to the
  port's one-device chunked one; the pages every rank wrote equal the
  chunked prefill's (1e-5; int8: the same codes but where a row's K/V sit
  at a rounding boundary) and the session records are the one-device
  layout, one of them (seq=2 x model=2) resumed on one device.

Where a reference mesh has ``data > 1`` (the Ulysses serving test's
``data=2``) the port's mesh has ``data=1``: the JAX engine only replicates
over ``data``, and the port's serving refuses that axis (ROADMAP A item 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_sp_ranks  # noqa: E402
from torch_tp_ranks import drive, next_turn, numpy_llama  # noqa: E402
from torch_train_ranks import World  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.engine import commit_first_token as jax_commit  # noqa: E402
from finchat_tpu.engine.kv_cache import PageAllocator as JaxAllocator  # noqa: E402
from finchat_tpu.engine.kv_cache import pages_needed as jax_pages_needed  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.ops.refs import mha_reference as jax_mha  # noqa: E402
from finchat_tpu.ops.ring_attention import ring_attention as jax_ring  # noqa: E402
from finchat_tpu.ops.ring_attention import (  # noqa: E402
    ring_attention_with_prefix as jax_ring_prefix,
)
from finchat_tpu.ops.ulysses import ulysses_attention as jax_ulysses  # noqa: E402
from finchat_tpu.parallel.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from finchat_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.ops.ulysses import ulysses_attention, ulysses_supported  # noqa: E402
from finchat_tpu_torch.parallel.mesh import make_abstract_mesh  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402

torch.set_float32_matmul_precision("highest")

OP_TOL = 1e-4  # the ops and the last-token logits against the JAX package (fp32)
PAGE_TOL = 1e-5  # the pages the ring wrote against the chunked prefill's (fp32)
MARGIN = 1e-3
N_NEW = 5
ALL = tuple(range(8))

# the ops: tests/test_parallel.py's shapes
RING = dict(B=2, S=64, H=4, Hkv=2, D=16)
ULY_SIZES = (2, 1, 4, 1, 1)  # data=2 x seq=4
ULY_HEADS = {"mha": (8, 8), "gqa": (8, 4)}
PREFIX_P, PREFIX_LEN = 32, 27  # a cached prefix padded past its valid length


def _qkv(seed: int, H: int, Hkv: int, B=2, S=64, D=16, P=PREFIX_P) -> dict:
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(q=r(B, S, H, D), k=r(B, S, Hkv, D), v=r(B, S, Hkv, D), kp=r(B, P, Hkv, D),
                vp=r(B, P, Hkv, D), prefix_len=PREFIX_LEN)


OPS = {
    "ring_ops": dict(kind="ops", sizes=(1, 1, 8, 1, 1), ranks=ALL, **_qkv(0, 4, 2),
                     calls={"causal": ("ring", True), "full": ("ring", False),
                            "prefix": ("ring_prefix", True)}),
    **{f"uly_ops_{name}": dict(kind="ops", sizes=ULY_SIZES, ranks=ALL, **_qkv(h, h, hkv),
                               calls={"causal": ("ulysses", True), "full": ("ulysses", False),
                                      "prefix": ("ulysses_prefix", True)})
       for name, (h, hkv) in ULY_HEADS.items()},
}

# the engine: the JAX tests' config (tests/test_parallel.py; test_kv_quant.py's has 8 KV heads)
DENSE = dict(vocab_size=128, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128)
KV8 = dict(DENSE, n_kv_heads=8)
ECFG = dict(max_seqs=2, page_size=8, num_pages=64, max_seq_len=256, prefill_chunk=16,
            ring_prefill_min_tokens=16, ring_prefill_chunk=32)


def _prompt(seed: int, n: int) -> list[int]:
    return [int(x) for x in np.random.RandomState(seed).randint(1, 128, size=n)]


SEQ2_MODEL4, SEQ2_MODEL2 = (1, 1, 2, 1, 4), (1, 1, 2, 1, 2)
# name: (model, mesh sizes, the JAX mesh, sp_mode, kv_quant, {turn: (prompt, how)})
ENGINES = {
    "ring": (DENSE, SEQ2_MODEL4, dict(seq=2, model=4), "ring", "",
             {"mono": (_prompt(3, 50), "prefill"), "seg": (_prompt(11, 100), "segments")}),
    "fallback": (DENSE, SEQ2_MODEL4, dict(seq=2, model=4), "ulysses", "",
                 {"mono": (_prompt(3, 50), "prefill")}),
    "ulysses": (DENSE, SEQ2_MODEL2, dict(data=2, seq=2, model=2), "ulysses", "",
                {"mono": (_prompt(5, 50), "prefill"), "seg": (_prompt(11, 100), "segments")}),
    "int8": (KV8, SEQ2_MODEL4, dict(seq=2, model=4), "ring", "int8",
             {"mono": (_prompt(7, 50), "prefill"), "seg": (_prompt(13, 100), "segments")}),
}
TREES = {"dense": numpy_llama(128, 64, 2, 8, 4, 128, 0),
         "kv8": numpy_llama(128, 64, 2, 8, 8, 128, 0)}


def _tree(model: dict) -> dict:
    return TREES["kv8" if model["n_kv_heads"] == 8 else "dense"]


def _tcfg(model: dict):
    return tllama.LlamaConfig(**model, max_seq_len=256, dtype=torch.float32)


def _ecfg(sp_mode: str, kv_quant: str) -> dict:
    return dict(ECFG, sp_mode=sp_mode, kv_quant=kv_quant)


def _engine_cases() -> dict:
    cases = {}
    for name, (model, sizes, _jm, sp_mode, kvq, turns) in ENGINES.items():
        n = int(np.prod(sizes))
        cases[name] = dict(kind="engine", sizes=sizes, ranks=tuple(range(n)),
                           config=_tcfg(model), params=params_from_numpy(_tree(model), "cpu"),
                           ecfg=EngineConfig(**_ecfg(sp_mode, kvq)), warmup=name == "ring",
                           turns={k: (p, N_NEW, how) for k, (p, how) in turns.items()})
    return cases


def _jax_ops() -> dict:
    """The JAX oracle at the ops' inputs: ``mha_reference`` for every call
    (over the valid prefix and the segment, at the prefix's offset, for the
    prefix variants), and the JAX ops themselves for the causal ring over
    seq=8, its prefix variant, and causal GQA Ulysses over data=2 x seq=4."""
    out = {}
    ring_mesh = jax_build_mesh(JaxMeshSpec(data=1, seq=8, expert=1, model=1))
    uly_mesh = jax_build_mesh(JaxMeshSpec(data=2, seq=4, expert=1, model=1))
    for case in OPS:
        c = OPS[case]
        q, k, v = (jnp.asarray(c[x]) for x in ("q", "k", "v"))
        kp = jnp.concatenate([jnp.asarray(c["kp"][:, :PREFIX_LEN]), k], 1)
        vp = jnp.concatenate([jnp.asarray(c["vp"][:, :PREFIX_LEN]), v], 1)
        out[case] = {"causal_reference": np.asarray(jax_mha(q, k, v, causal=True)),
                     "full_reference": np.asarray(jax_mha(q, k, v, causal=False)),
                     "prefix_reference": np.asarray(jax_mha(q, kp, vp, causal=True,
                                                            q_offset=PREFIX_LEN))}
    c = OPS["ring_ops"]
    q, k, v = (jnp.asarray(c[x]) for x in ("q", "k", "v"))
    out["ring_ops"]["causal"] = np.asarray(jax_ring(q, k, v, mesh=ring_mesh, causal=True))
    out["ring_ops"]["prefix"] = np.asarray(jax_ring_prefix(
        q, k, v, jnp.asarray(c["kp"]), jnp.asarray(c["vp"]), c["prefix_len"], mesh=ring_mesh,
        causal=True))
    c = OPS["uly_ops_gqa"]
    q, k, v = (jnp.asarray(c[x]) for x in ("q", "k", "v"))
    out["uly_ops_gqa"]["causal"] = np.asarray(jax_ulysses(q, k, v, mesh=uly_mesh, causal=True))
    return out


def _jax_engine(name: str) -> dict:
    """The JAX engine's turns on case ``name``'s mesh shape: the last-token
    logits and the greedy continuation (and the int8 pool the last turn
    left)."""
    model, _sizes, jmesh, sp_mode, kvq, turns = ENGINES[name]
    jcfg = jllama.LlamaConfig(**model, max_seq_len=256, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, _tree(model))
    mesh = jax_build_mesh(JaxMeshSpec(**{"data": 1, "expert": 1, **jmesh}))
    ecfg = JaxEngineConfig(**_ecfg(sp_mode, kvq))
    eng = JaxEngine(jcfg, params, ecfg, mesh=mesh)
    assert eng.sp_mode == sp_mode
    res = {"buckets": {n: eng._ring_bucket(n) for n in (16, 33, 50, 100)},
           "prefix_pages": {p: eng._prefix_page_bucket(p) for p in (1, 32, 64, 96, 200)}}
    for key, (prompt, how) in turns.items():
        alloc = JaxAllocator(ecfg.num_pages)
        pages = alloc.allocate("s", jax_pages_needed(len(prompt) + N_NEW, 8))
        eng.set_page_table_row(0, pages)
        if how == "segments":
            rc = eng.ring_segment_tokens()
            for start in range(0, len(prompt), rc):
                logits = eng.prefill_ring_segment(0, prompt[start:start + rc], start)
        else:
            assert eng._use_ring_prefill(len(prompt))
            logits = eng.prefill(0, prompt)
        eng.state, tok = jax_commit(eng.state, jnp.int32(0), logits, jnp.float32(0.0),
                                    jnp.float32(1.0), jnp.int32(0))
        tokens = [int(tok)]
        active = jnp.zeros((2,), bool).at[0].set(True)
        z, o, zk = jnp.zeros((2,)), jnp.ones((2,)), jnp.zeros((2,), jnp.int32)
        for _ in range(N_NEW - 1):
            tokens.append(int(eng.decode(active, z, o, zk)[0]))
        res[key] = dict(logits=np.asarray(logits, np.float32), tokens=tokens, pages=pages)
        if kvq:  # the int8 pool the JAX ring wrote (the last turn's pages stay)
            st = eng.state
            res["pool"] = tuple(np.asarray(x) for x in (st.k_pages, st.v_pages, st.k_scales,
                                                         st.v_scales))
        eng.reset_slot(0)
    return res


def _jax_part(part: str, queue) -> None:
    """One case's JAX engine oracle, in a process of its own (``runs``), put
    on ``queue`` (a failure as its traceback). JAX on the CPU, as
    tests/conftest.py sets it (the 8 devices come with the environment)."""
    import traceback

    try:
        jax.config.update("jax_platforms", "cpu")
        assert jax.device_count() == 8
        queue.put((part, _jax_engine(part)))
    except Exception:  # the process's boundary: the parent reports it
        queue.put((part, traceback.format_exc()))


def _jax_engines(parts: tuple, work) -> tuple:
    """Run ``work()`` here while ``parts``' JAX oracles run in spawned
    processes at once (each compiles its own steps); every read and join is
    bounded, and a process still alive at the end is terminated. Returns
    ``(work's result, {part: oracle})``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_jax_part, args=(p, queue), daemon=True) for p in parts]
    for proc in procs:
        proc.start()
    try:
        done = work()
        got = dict(queue.get(timeout=300) for _ in parts)
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
    failed = {p: r for p, r in got.items() if isinstance(r, str)}
    assert not failed, failed
    return done, got


def _plain_turns() -> dict:
    """The port's one-device chunked turn of every prompt (tokens, logits,
    pages, record) on the case's model and KV dtype."""
    out = {}
    for name, (model, _s, _jm, _sp, kvq, turns) in ENGINES.items():
        for key, (prompt, _how) in turns.items():
            engine = InferenceEngine(_tcfg(model), params_from_numpy(_tree(model), "cpu"),
                                     EngineConfig(**_ecfg("ring", kvq)), device="cpu")
            out[(name, key)] = dict(drive(engine, prompt, N_NEW), engine=engine)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    the spawned ranks (and the suite's other workers) share the machine's
    cores, where every process's default thread pool would oversubscribe
    them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The world's results, and the oracles computed while it runs: the
    JAX engines in three processes at once, the JAX ops and the port's
    one-device turns here."""
    world = World(8, {**OPS, **_engine_cases()}, target=torch_sp_ranks.rank_main)
    try:
        oracle, engines = _jax_engines(("ring", "ulysses", "int8"),
                                       lambda: dict(ops=_jax_ops(), plain=_plain_turns()))
        oracle["engines"] = engines
        yield world.results(), oracle
    finally:
        world.close()


def _ranks(world: dict, case: str) -> dict:
    return {r: res[case] for r, res in world.items() if case in res}


def _assembled(world: dict, case: str, call: str) -> np.ndarray:
    """The ranks' output blocks of one call in sequence order (the data
    coordinate 0's, where the mesh has one)."""
    blocks = sorted((res["coords"]["seq"], res[call]) for res in _ranks(world, case).values()
                    if res["coords"]["data"] == 0)
    return torch.cat([b for _, b in blocks], dim=1).numpy()


# --- the ops ----------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["causal", "full"])
def test_ring_attention_matches_jax_and_reference(runs, call):
    """The ring over seq=8 (GQA, 4 query and 2 KV heads) against the JAX
    ring and ``mha_reference``; every rank issues ``n - 1`` hops (K and V
    riding one), causal or not."""
    world, oracle = runs
    got = _assembled(world, "ring_ops", call)
    want = oracle["ops"]["ring_ops"]
    assert np.abs(got - want[call + "_reference"]).max() < OP_TOL
    if call in want:
        assert np.abs(got - want[call]).max() < OP_TOL
    for res in _ranks(world, "ring_ops").values():
        assert res[call + "_collectives"] == {"ring_shift": 7}


def test_ring_attention_with_prefix_matches_jax(runs):
    """A segment's ring with a cached prefix (padded past its 27 valid
    positions) folded first, against the JAX op and the reference over
    prefix plus segment."""
    world, oracle = runs
    got = _assembled(world, "ring_ops", "prefix")
    assert np.abs(got - oracle["ops"]["ring_ops"]["prefix"]).max() < OP_TOL
    assert np.abs(got - oracle["ops"]["ring_ops"]["prefix_reference"]).max() < OP_TOL


@pytest.mark.parametrize("heads", list(ULY_HEADS))
@pytest.mark.parametrize("call", ["causal", "full"])
def test_ulysses_attention_matches_jax_and_reference(runs, heads, call):
    """Ulysses over data=2 x seq=4 (MHA 8/8, GQA 8/4), causal and full,
    against the JAX op and ``mha_reference``; the data coordinates agree;
    three scatters and one gather a call."""
    world, oracle = runs
    case = f"uly_ops_{heads}"
    got = _assembled(world, case, call)
    want = oracle["ops"][case]
    assert np.abs(got - want[call + "_reference"]).max() < OP_TOL
    if call in want:
        assert np.abs(got - want[call]).max() < OP_TOL
    ranks = _ranks(world, case)
    for res in ranks.values():
        twin = [r for r in ranks.values() if r["coords"]["seq"] == res["coords"]["seq"]]
        assert all(torch.equal(t[call], res[call]) for t in twin)
        assert res[call + "_collectives"] == {"seq_to_heads": 3, "heads_to_seq": 1}


@pytest.mark.parametrize("heads", list(ULY_HEADS))
def test_ulysses_attention_with_prefix_matches_jax(runs, heads):
    """A segment's Ulysses attention with a padded cached prefix folded
    first (each rank its head group of it), against the JAX reference over
    the valid prefix and the segment at the prefix's offset (what the JAX
    op computes)."""
    world, oracle = runs
    case = f"uly_ops_{heads}"
    got = _assembled(world, case, "prefix")
    assert np.abs(got - oracle["ops"][case]["prefix_reference"]).max() < OP_TOL


def test_ulysses_rejects_indivisible_heads():
    """4 heads over seq=8: refused before any collective, as the JAX op
    refuses it; the predicate is the JAX one's."""
    mesh = make_abstract_mesh((1, 1, 8, 1, 1))
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="ring attention instead"):
        ulysses_attention(q, q, q, mesh=mesh)
    from finchat_tpu.ops.ulysses import ulysses_supported as jax_supported

    jmesh = jax_build_mesh(JaxMeshSpec(data=1, seq=2, expert=1, model=4))
    pmesh = make_abstract_mesh((1, 1, 2, 1, 4))
    for h, hkv in ((8, 4), (8, 8), (16, 8), (32, 8), (4, 2)):
        assert ulysses_supported(h, hkv, pmesh, "seq", "model") == jax_supported(
            h, hkv, jmesh, "seq", "model")


# --- the engine -------------------------------------------------------------------------

def _margins(rows) -> np.ndarray:
    top2 = np.sort(np.asarray(rows, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _check_turn(world, oracle, name: str, key: str) -> dict:
    """Rank 0's turn against the JAX engine's (the fallback's against the
    ring case's) and the port's one-device chunked turn."""
    got = world[0][name][key]
    jax_name = "ring" if name == "fallback" else name
    want = oracle["engines"][jax_name][key]
    plain = oracle["plain"][(name, key)]
    assert np.abs(got["logits"][0].numpy() - want["logits"]).max() < OP_TOL
    assert got["tokens"] == want["tokens"]
    assert got["tokens"] == plain["tokens"]
    assert got["context"] == len(ENGINES[name][5][key][0])
    return got


@pytest.mark.parametrize("name", ["ring", "fallback", "ulysses", "int8"])
def test_prefill_ring_matches_jax_and_chunked(runs, name):
    """A prompt of 50 tokens (past ``ring_prefill_min_tokens`` 16) prefilled
    through the routed ``prefill`` on the case's mesh: the seq-sharded path
    (its collectives issued, no chunk), the JAX engine's last-token logits
    within 1e-4 on the same mesh shape and its greedy continuation, which is
    also the port's one-device chunked one. The Ulysses case runs Ulysses,
    the fallback (seq=2 over 1 KV head a rank) runs ring, as the JAX engine
    resolves them."""
    world, oracle = runs
    got = _check_turn(world, oracle, name, "mono")
    sp_mode = "ring" if name != "ulysses" else "ulysses"
    assert {res["sp_mode"] for res in _ranks(world, name).values()} == {sp_mode}
    hops = "ring_shift" if sp_mode == "ring" else "seq_to_heads"
    assert got["collectives"][hops] > 0 and got["collectives"]["broadcast_seq"] == 1


@pytest.mark.parametrize("name", ["ring", "ulysses", "int8"])
def test_prefill_ring_segment_matches_jax_and_chunked(runs, name):
    """100 tokens in segments of 32 (``prefill_ring_segment``: the first at
    position 0 on the plain step, the others folding the cached earlier
    segments): the JAX engine's last-token logits within 1e-4 and its
    continuation, the port's one-device one; the context length the whole
    prompt."""
    world, oracle = runs
    got = _check_turn(world, oracle, name, "seg")
    assert got["collectives"]["broadcast_seq"] == 4  # one a segment


@pytest.mark.parametrize("name", ["ring", "ulysses", "int8"])
def test_ring_pages_equal_the_chunked_prefill(runs, name):
    """The pages of the last turn, on every rank (replicated over seq, this
    rank's heads over model), and every turn's session record (gathered
    over seq coordinate 0's model group, the one-device layout): fp32,
    against the one-device chunked prefill's within 1e-5. The int8 pool
    against the JAX ring's on the same mesh shape (codes within one, for a
    row at a rounding boundary; scales within 1e-5): the chunked prefill
    reads the earlier chunks back quantized where the ring attends over the
    exact K/V, so their later layers part by the quantization's envelope."""
    world, oracle = runs
    model, sizes, _jm, _sp, kvq, turns = ENGINES[name]
    last = list(turns)[-1]
    plain = oracle["plain"][(name, last)]
    pages = plain["pages"]
    if kvq:
        jax_side = oracle["engines"][name]
        assert jax_side[last]["pages"] == pages
        full = [torch.from_numpy(x) for x in jax_side["pool"]]
    else:
        st = plain["engine"].state
        full = [st.k_pages, st.v_pages, st.k_scales, st.v_scales]
    tp = sizes[-1]
    hl = model["n_kv_heads"] // tp

    def close(got, want):
        if got.dtype == torch.int8:
            diff = (got.float() - want.float()).abs()
            return diff.max() <= 1 and (diff > 0).float().mean() < 0.01
        return torch.allclose(got.float(), want.float(), rtol=0, atol=PAGE_TOL)

    for res in _ranks(world, name).values():
        m = res["coords"]["model"]
        k, v, ks, vs = res["local"]
        w = k.shape[-1]
        for got, whole in ((k, full[0]), (v, full[1])):
            assert close(got[:, pages], whole[:, pages][..., m * w:(m + 1) * w])
        if kvq:
            for got, whole in ((ks, full[2]), (vs, full[3])):
                assert close(got[:, pages, :hl], whole[:, pages, m * hl:(m + 1) * hl])
    for key in turns:
        record = world[0][name][key]["record"]
        want = oracle["plain"][(name, key)]["record"]
        for i, (got_t, want_t) in enumerate(zip(record, want)):
            if want_t is None:
                assert got_t is None
                continue
            assert got_t.shape == want_t.shape and got_t.dtype == want_t.dtype
            if key == last:
                assert close(got_t, want_t if not kvq else full[i][:, pages])
    for res in _ranks(world, name).values():
        if res["coords"]["seq"]:
            assert all(res[key]["record"] is None for key in turns if key in res)


def test_seq_record_resumes_on_one_device(runs):
    """A conversation's record offloaded on seq=2 x model=2 (its pages
    written by the Ulysses prefill) restores into a one-device engine,
    whose next turn equals the one the one-device engine makes from its own
    record."""
    world, oracle = runs
    got = world[0]["ulysses"]["mono"]
    plain = oracle["plain"][("ulysses", "mono")]
    model = ENGINES["ulysses"][0]
    nxt = ([41, 7, 88], 4)

    def resume(record):
        engine = InferenceEngine(_tcfg(model), params_from_numpy(_tree(model), "cpu"),
                                 EngineConfig(**_ecfg("ring", "")), device="cpu")
        return next_turn(engine, record, plain["written"], *nxt)

    assert resume(got["record"])["tokens"] == resume(plain["record"])["tokens"]


def test_ring_buckets_match_jax(runs):
    """The ring buckets (a power of two rounded up to a seq multiple) and
    the segment's prefix-page buckets (floored at one segment's pages,
    capped at the row) are the JAX engine's."""
    world, oracle = runs
    for name in ("ring", "ulysses"):
        assert world[0][name]["buckets"] == oracle["engines"][name]["buckets"]
        assert world[0][name]["prefix_pages"] == oracle["engines"][name]["prefix_pages"]


def test_warmup_runs_the_ring_variants(runs):
    """On a seq mesh the warmup runs, beyond a one-device engine's variants,
    the seq-sharded ones the JAX engine's warmup enumerates: ring buckets
    ``bucket(min(16, 32))`` to ``bucket(32)`` (16, 32) and the segment step
    at every prefix-page bucket from ``_prefix_page_bucket(32)`` to
    ``_prefix_page_bucket(256)`` (4, 8, 16, 32 pages): six; its
    ``n_valid = 0`` writes leave the turns after it as they were."""
    world, oracle = runs
    model = ENGINES["ring"][0]
    plain = InferenceEngine(_tcfg(model), params_from_numpy(_tree(model), "cpu"),
                            EngineConfig(**_ecfg("ring", "")), device="cpu")
    plain.warmup()
    assert world[0]["ring"]["compiled_variants"] == plain.compiled_variants + 6
    assert oracle["engines"]["ring"]["buckets"][16] == 16
    assert oracle["engines"]["ring"]["prefix_pages"][32] == 4


def test_unknown_sp_mode_is_refused():
    """An ``sp_mode`` other than ring or ulysses raises at construction, as
    the JAX engine's does."""
    cfg = dataclasses.replace(tllama.PRESETS["tiny"], dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="unknown sp_mode"):
        InferenceEngine(cfg, params, EngineConfig(max_seqs=2, num_pages=8, page_size=8,
                                                  sp_mode="zigzag"), device="cpu")
