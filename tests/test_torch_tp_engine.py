"""The port's tensor-parallel serving over spawned gloo ranks on the CPU,
against the JAX package's GSPMD engine and the port's one-device engine.

The JAX side runs in the pytest process (8 CPU devices); the port's ranks
are spawned processes that import only torch and the port
(tests/torch_tp_ranks.py), one group a world size, every collective under a
60 s timeout and every join bounded, so a failure is an error, never a
hang.

- ``row_parallel_dense`` at 4 ranks (the JAX test's shapes over 4): the
  chunked schedule is byte-identical to its serial form, the same
  rank-ordered sum over one chunk, at fp32 (and for a weight chunked once
  at placement), issues ``n_chunks`` collectives against 1, stays within
  fp32 noise (and bf16 rounding) of the plain all-reduce, and
  agrees with the JAX package's 8-way result; an output dim the chunks do
  not divide runs serial.
- The JAX test's engine config at 2 and 4 ranks, fp32 and int8 weights over
  an int8 KV pool: the greedy tokens equal the JAX engine's (unsharded, and
  for fp32 also at model=8) wherever the JAX top-2 margin exceeds 1e-3
  (gate (b)); the
  fp32 logits agree with the port's one-device engine within ``TP_ATOL``
  (the row-parallel sums add the same products in another order); the
  scheduler's streams (coexisting prefill and decode rounds) equal the
  one-device scheduler's wherever its margin exceeds 1e-3; ``tp_overlap``
  changes no bit (from 3 ranks, against its own one-chunk form).
- At 1 rank the TP engine is bit-equal to no mesh: tokens, logits and the
  session record.
- A session record offloaded at TP=2 has the one-device layout (shapes,
  dtypes, head order, scale rows), each rank's pages are exactly its heads'
  slice, a gather and scatter round trip is exact, and a record restores
  both ways (TP=2 into one device, one device into TP=2) with the next turn
  under gate (b).
- ``build_app`` at ``mesh.model=2`` (``tiny``, fp32, temperature 0) serves a
  Kafka turn in the chunk schema with the one-device app's tokens (gate
  (b)), and stops with no follower left.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401
from torch_tp_ranks import drive, next_turn, numpy_llama, run_group  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.engine import commit_first_token as jax_commit  # noqa: E402
from finchat_tpu.engine.kv_cache import PageAllocator as JaxAllocator  # noqa: E402
from finchat_tpu.engine.kv_cache import pages_needed as jax_pages_needed  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.ops.tp_overlap import row_parallel_dense as jax_row_parallel  # noqa: E402
from finchat_tpu.parallel.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from finchat_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import scale_rows  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
# fp32 logits of a TP engine against the one-device engine: the same
# products, each row-parallel sum added in another order (~1e-6 here)
TP_ATOL = 1e-4
# tests/test_parallel.py::test_tp_sharded_engine_matches_unsharded's config
JCFG = jllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=8, n_kv_heads=8,
                          hidden_dim=128, max_seq_len=64, dtype=jnp.float32)
ENGINE = dict(max_seqs=2, page_size=8, num_pages=16, max_seq_len=64, prefill_chunk=8)
PROMPT = [5, 9, 2, 100, 17, 3]
N_NEW = 6
NEXT = ([41, 7, 88], 4)  # the next turn's new tokens and its budget
# the scheduler's streams: three prompts at once, 6 tokens each
SCHED_ENGINE = dict(max_seqs=4, page_size=8, num_pages=32, max_seq_len=64, prefill_chunk=8,
                    prefix_cache=False, session_cache=False, warmup_on_start=False)
SCHED_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], [2, 7, 1, 8], [1, 1, 2, 3, 5, 8, 13, 21, 34]]
# the row-parallel case: tests/test_parallel.py's shapes, over 4 ranks
ROW = (8, 256, 128, 4)
ROW_ODD = (4, 64, 30, 4)  # 30 % 4 != 0: serial


def _tcfg(jcfg=JCFG):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return tllama.LlamaConfig(**fields, dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    c = JCFG
    tree = numpy_llama(c.vocab_size, c.dim, c.n_layers, c.n_heads, c.n_kv_heads,
                       c.hidden_dim, 0)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


PLANES = {"fp32": dict(quant="", kv_quant=""), "int8+kv8": dict(quant="int8", kv_quant="int8")}


def _jax_turn(jparams, plane: str, mesh=None) -> tuple[list[int], np.ndarray]:
    """The JAX engine's greedy turn (tokens and the fp32 logits of every
    step) at the JAX test's seams."""
    spec = PLANES[plane]
    ecfg = JaxEngineConfig(**ENGINE, kv_quant=spec["kv_quant"])
    eng = JaxEngine(JCFG, jparams, ecfg, mesh=mesh, attn_backend="ref", quant=spec["quant"])
    alloc = JaxAllocator(ecfg.num_pages)
    eng.set_page_table_row(0, alloc.allocate("s", jax_pages_needed(len(PROMPT) + N_NEW, 8)))
    logits = eng.prefill(0, PROMPT)
    eng.state, tok = jax_commit(eng.state, jnp.int32(0), logits, jnp.float32(0.0),
                                jnp.float32(1.0), jnp.int32(0))
    out, rows = [int(tok)], [np.asarray(logits)]
    active = jnp.zeros((2,), bool).at[0].set(True)
    z, o, zk = jnp.zeros((2,)), jnp.ones((2,)), jnp.zeros((2,), jnp.int32)
    for _ in range(N_NEW - 1):
        toks, lg = eng.decode(active, z, o, zk, return_logits=True)
        out.append(int(toks[0]))
        rows.append(np.asarray(lg)[0])
    return out, np.stack(rows)


def _gate_b(got: list[int], want: list[int], margins: np.ndarray) -> int:
    """Equal tokens up to the first difference, which only a top-2 margin
    <= 1e-3 of the reference may excuse (the streams part there). Returns
    the tokens held equal."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert margins[i] <= MARGIN, (i, a, b, margins[i])
            return i
    assert len(got) == len(want)
    return len(got)


def _margins(rows) -> np.ndarray:
    top2 = np.sort(np.asarray(rows, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _plain_engine(tparams, plane: str, ecfg: dict = ENGINE):
    spec = PLANES[plane]
    return InferenceEngine(_tcfg(), tparams, EngineConfig(**ecfg, kv_quant=spec["kv_quant"]),
                           device="cpu", quant=spec["quant"])


def _engine_case(tparams, plane: str, steps: list, overlap: bool = False, ecfg=ENGINE,
                 chunks: int = 4, **extra):
    spec = PLANES[plane]
    return dict(kind="engine", config=_tcfg(), params=tparams,
                ecfg=EngineConfig(**ecfg, kv_quant=spec["kv_quant"], tp_overlap=overlap,
                                  tp_overlap_chunks=chunks),
                quant=spec["quant"], steps=steps, **extra)


@pytest.fixture(scope="module")
def plain(model):
    """The port's one-device runs: a turn a plane, its next turn from its
    own record, and the scheduler's streams with their margins."""
    _jp, tparams = model
    out = {}
    for plane in PLANES:
        t = drive(_plain_engine(tparams, plane), PROMPT, N_NEW)
        t["next"] = next_turn(_plain_engine(tparams, plane), t["record"], t["written"], *NEXT)
        out[plane] = t
    from torch_tp_ranks import scheduler_run

    out["streams"] = scheduler_run(_plain_engine(tparams, "fp32", SCHED_ENGINE), SCHED_PROMPTS,
                                   N_NEW)
    return out


_GROUPS: dict = {}


def _group(world: int, model, plain) -> dict:
    """Every case of one world size in one spawned group (cached)."""
    if world not in _GROUPS:
        _jp, tparams = model
        turn = ("drive", PROMPT, N_NEW)
        cases = {}
        if world == 4:
            cases["row"] = dict(kind="row_parallel", args=ROW + (0,))
            cases["row_odd"] = dict(kind="row_parallel", args=ROW_ODD + (2,))
        for plane in PLANES:
            steps = [turn]
            if world == 2:
                steps += [("round_trip",) + NEXT, ("restore_plain",) + NEXT]
            cases[plane] = _engine_case(tparams, plane, steps,
                                        plain_record=plain[plane]["record"],
                                        plain_written=plain[plane]["written"])
        if world > 2:  # the knob's one-chunk form: the bytes its chunks must equal
            cases["overlap_one"] = _engine_case(tparams, "fp32", [turn], overlap=True, chunks=1)
        if world > 1:
            cases["overlap"] = _engine_case(tparams, "fp32", [turn], overlap=True)
            cases["scheduler"] = _engine_case(tparams, "fp32",
                                              [("scheduler", SCHED_PROMPTS, N_NEW)],
                                              ecfg=SCHED_ENGINE)
        _GROUPS[world] = run_group(world, cases)
    return _GROUPS[world]


# --- row_parallel_dense ---------------------------------------------------------------

def _row_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _jax_row_parallel(x, w, overlap: bool, n_chunks: int) -> np.ndarray:
    from jax.sharding import PartitionSpec as P

    from finchat_tpu.parallel.mesh import shard_map

    mesh = jax_build_mesh(JaxMeshSpec(data=1, seq=1, expert=1, model=8))
    f = shard_map(lambda a, b: jax_row_parallel(a, b, "model", overlap=overlap,
                                                n_chunks=n_chunks),
                  mesh=mesh, in_specs=(P(None, "model"), P("model", None)),
                  out_specs=P(None, None))
    return np.asarray(f(jnp.asarray(x), jnp.asarray(w)))


def test_row_parallel_byte_identity_and_collective_count(model, plain):
    """4 ranks, ``x [8, 256] @ w [256, 128]`` in 4 chunks: the chunked
    schedule equals its serial form (the same rank-ordered sum over one
    chunk) byte for byte at fp32 and for an int8 weight chunked once at
    placement (``chunk_row_parallel``) and in bf16; the plain serial
    all-reduce within fp32 noise of it and, in bf16, within the rounding of
    another order of addition; 4 collectives against 1; every rank holds the
    same bytes; and the result agrees with the JAX package's 8-way
    ``row_parallel_dense`` on the same inputs within fp32 noise."""
    res = _group(4, model, plain)
    M, K, N, n = ROW
    for rank in range(4):
        r = res[rank]["row"]
        for kind in ("", "_int8", "_bf16"):
            assert torch.equal(r["overlap_one" + kind], r["overlap" + kind]), kind
        np.testing.assert_allclose(r["overlap"].numpy(), r["serial"].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["overlap_int8"].numpy(), r["serial_int8"].numpy(), rtol=0,
                                   atol=1e-5)
        # bf16: four partials added in two orders, each add rounded to bf16
        # (2^-9 of the running sum at most): within 2^-6 of the row's top
        got, want = r["overlap_bf16"].float(), r["serial_bf16"].float()
        assert ((got - want).abs() <= 2.0 ** -6 * want.abs().amax(-1, keepdim=True)).all()
        assert (r["serial_collectives"], r["overlap_collectives"]) == (1, n)
        assert (r["overlap_one_collectives"], r["overlap_one_int8_collectives"]) == (1, 1)
        assert (r["serial_int8_collectives"], r["overlap_int8_collectives"]) == (1, n)
        for name in ("serial", "overlap"):
            assert torch.equal(r[name], res[0]["row"][name])
    x, w = _row_inputs(M, K, N, 0)
    want = _jax_row_parallel(x, w, True, n)
    np.testing.assert_allclose(res[0]["row"]["serial"].numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res[0]["row"]["serial"].numpy(), x @ w, rtol=0, atol=1e-4)


def test_row_parallel_indivisible_falls_back_serial(model, plain):
    """An output dim of 30 over 4 chunks runs the serial collective (one
    all-reduce, the serial bytes) on every rank, as the JAX package's
    ``test_tp_overlap_indivisible_falls_back_serial`` asks."""
    res = _group(4, model, plain)
    for rank in range(4):
        r = res[rank]["row_odd"]
        assert torch.equal(r["serial"], r["overlap"])
        assert r["overlap_collectives"] == 1
    x, w = _row_inputs(*ROW_ODD[:3], 2)
    np.testing.assert_allclose(res[0]["row_odd"]["serial"].numpy(),
                               _jax_row_parallel(x, w, True, 4), rtol=0, atol=1e-4)


# --- the TP engine --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_turns(model):
    """The JAX engine's turns: fp32 unsharded and at model=8, int8+kv8
    unsharded (the JAX package's own test holds its model=8 run to its
    unsharded one)."""
    jparams, _tp = model
    mesh = jax_build_mesh(JaxMeshSpec(data=1, seq=1, expert=1, model=8))
    return {("fp32", False): _jax_turn(jparams, "fp32"),
            ("fp32", True): _jax_turn(jparams, "fp32", mesh=mesh),
            ("int8+kv8", False): _jax_turn(jparams, "int8+kv8")}


@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("world", [2, 4])
def test_tp_engine_matches_jax_and_one_device(world, plane, model, plain, jax_turns):
    """``test_tp_sharded_engine_matches_unsharded``'s config at ``world``
    ranks: greedy tokens equal to the JAX engine's (unsharded, and at
    model=8 for fp32) by gate (b), fp32 logits within ``TP_ATOL`` of the
    port's one-device engine, every rank's state reached by the same
    calls."""
    res = _group(world, model, plain)
    turn = res[0][plane]["turn"]
    for (p, _sharded), (want, rows) in jax_turns.items():
        if p == plane:
            assert _gate_b(turn["tokens"], want, _margins(rows)) >= 2
    one = plain[plane]
    assert turn["tokens"] == one["tokens"] or _gate_b(turn["tokens"], one["tokens"],
                                                      _margins(one["logits"].numpy())) >= 2
    n = min(len(turn["tokens"]), len(one["tokens"]))
    np.testing.assert_allclose(turn["logits"][:n].numpy(), one["logits"][:n].numpy(),
                               rtol=0, atol=TP_ATOL)
    calls = [res[r][plane]["calls"] for r in range(1, world)]
    assert calls and len(set(calls)) == 1 and calls[0] > N_NEW


@pytest.mark.parametrize("world", [2, 4])
def test_tp_overlap_changes_no_bit(world, model, plain):
    """``engine.tp_overlap`` (4 chunks of each row-parallel output) against
    the serial schedule on the same engine config: the same tokens, the
    same logits and the same session record, bit for bit. At 2 ranks the
    serial schedule is the plain all-reduce (no knob); from 3 ranks it is
    the knob's one-chunk form, whose rank-ordered sum the chunks keep."""
    res = _group(world, model, plain)
    a, b = res[0]["fp32" if world == 2 else "overlap_one"]["turn"], res[0]["overlap"]["turn"]
    assert a["tokens"] == b["tokens"]
    assert torch.equal(a["logits"], b["logits"])
    for x, y in zip(a["record"], b["record"]):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_scheduler_streams_match_one_device(world, model, plain):
    """Three prompts at once through the port's scheduler on rank 0 (the
    others following every call): the streams equal the one-device
    scheduler's up to a token whose one-device plain margin is <= 1e-3."""
    _jp, tparams = model
    cfg = _tcfg()
    got = _group(world, model, plain)[0]["scheduler"]["streams"]
    for p, g, w in zip(SCHED_PROMPTS, got, plain["streams"]):
        if g == w:
            continue
        ids = torch.tensor([p + w[:-1]])
        with torch.no_grad():
            logits = tllama.forward_full(tparams, ids, torch.arange(ids.shape[1])[None],
                                         config=cfg)[0, len(p) - 1:]
        _gate_b(g, w, _margins(logits.numpy()))


@pytest.mark.parametrize("plane", list(PLANES))
def test_one_rank_mesh_is_bit_equal_to_no_mesh(plane, model, plain):
    """A mesh of one rank (its model group a one-rank gloo group): tokens,
    every step's logits and the session record equal the one-device
    engine's bit for bit."""
    turn = _group(1, model, plain)[0][plane]["turn"]
    one = plain[plane]
    assert turn["tokens"] == one["tokens"]
    assert torch.equal(turn["logits"], one["logits"])
    for x, y in zip(turn["record"], one["record"]):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("plane", list(PLANES))
def test_tp2_session_record_layout_and_restores(plane, model, plain):
    """A record offloaded at TP=2: the one-device record's shapes and
    dtypes; each rank's pool pages are exactly its heads' slice of it, and
    each rank's live scale rows its rows (the padding rows zero); a restore
    into the TP engine and an offload again give it back bit for bit; and
    it restores into the one-device engine, and the one-device record into
    the TP engine, with the next turn under gate (b) against the one-device
    engine's own next turn."""
    res = _group(2, model, plain)
    _jp, tparams = model
    cfg = _tcfg()
    turn, one = res[0][plane]["turn"], plain[plane]
    rec, ref = turn["record"], one["record"]
    for x, y in zip(rec, ref):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.shape == y.shape and x.dtype == y.dtype and x.device.type == "cpu"
    hl, hd = cfg.n_kv_heads // 2, cfg.head_dim
    pages = torch.tensor(turn["pages"])
    for r in range(2):
        local = res[r][plane]
        for i, name in ((0, "local_k"), (1, "local_v")):
            assert torch.equal(rec[i][..., r * hl * hd:(r + 1) * hl * hd],
                               local[name].index_select(1, pages))
        if rec[2] is not None:
            mine = local["local_k_scales"].index_select(1, pages)
            assert mine.shape[2] == scale_rows(hl)
            assert torch.equal(rec[2][:, :, r * hl:(r + 1) * hl], mine[:, :, :hl])
            assert not mine[:, :, hl:].any()
    if rec[2] is not None:
        assert not rec[2][:, :, cfg.n_kv_heads:].any()
    # the gather and scatter round trip: restored at TP=2, offloaded again
    for x, y in zip(res[0][plane]["round_trip"]["restored"], rec):
        assert (x is None and y is None) or torch.equal(x, y)
    # both ways, each next turn held to the one-device engine's own
    want = one["next"]["tokens"]
    ctx = PROMPT + one["tokens"][:-1]  # the written tokens; the next turn's follow them
    ids = torch.tensor([ctx + NEXT[0] + want[:-1]])
    engine = _plain_engine(tparams, plane)
    with torch.no_grad():
        logits = tllama.forward_full(engine.params, ids, torch.arange(ids.shape[1])[None],
                                     config=cfg)[0, len(ctx) + len(NEXT[0]) - 1:]
    margins = _margins(logits.numpy())
    into_one = next_turn(engine, rec, turn["written"], *NEXT)["tokens"]
    for got in (into_one, res[0][plane]["from_plain"]["tokens"],
                res[0][plane]["round_trip"]["tokens"]):
        assert _gate_b(got, want, margins) >= 1


# --- build_app over a mesh ------------------------------------------------------------

APP_SYSTEM = ("You are Penny, a careful personal-finance assistant. Answer from the "
              "user's own accounts and transactions, briefly, and never invent numbers.")
APP_TOOL = ("Decide whether transaction data is needed. Answer with one tool call "
            "or with the words No tool call.")
APP_ENGINE = dict(max_seqs=4, page_size=32, num_pages=72, max_seq_len=1024, prefill_chunk=32,
                  max_new_tokens=12, temperature=0.0)
APP_CONTEXT = {"user_id": "u9", "name": "Alex", "income": 5000, "savings_goal": 800}
APP_RETRIEVE = 'retrieve_transactions({"search_query": "coffee", "num_transactions": 2})'


async def _app_retriever(args):
    return [f"txn for {args['user_id']}", "COFFEE $4.50 on 2026-07-30"]


def _app_turn(mesh_model: int) -> tuple:
    """One Kafka turn through the port's ``build_app`` on ``tiny`` (fp32,
    seed 5, greedy), the decision a stub that retrieves; returns the app,
    the response handle and the ``ai_response`` chunks."""
    from finchat_tpu_torch.engine.generator import StubGenerator
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.serve import app as tapp
    from finchat_tpu_torch.utils.config import load_config

    cfg = load_config(overrides={
        "model.preset": "tiny", "model.dtype": "float32", "model.seed": 5,
        "mesh.model": mesh_model, **{f"engine.{k}": v for k, v in APP_ENGINE.items()}})
    store = InMemoryStore()
    store.upsert_context("c1", APP_CONTEXT)
    store.add_user_message("c1", "How am I doing?", "u9", timestamp=100)
    broker = InMemoryBroker()
    app = tapp.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                         tool_generator=StubGenerator(default=APP_RETRIEVE),
                         retriever=_app_retriever, device="cpu")
    handles = []
    submit = app.scheduler.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    app.scheduler.submit = recording_submit

    async def through_app():
        await app.start(serve_http=False)
        try:
            KafkaClient(cfg.kafka, broker=broker).produce_message(
                "user_message", "c1", {"message": "What about coffee?", "conversation_id": "c1",
                                       "user_id": "u9", "message_id": "m-tp"})
            for _ in range(60000):  # bounded: 300 s of 5 ms ticks
                if any(json.loads(m.value()).get("type") == "complete"
                       for m in broker.drain("ai_response")):
                    break
                await asyncio.sleep(0.005)
            while app._inflight:
                await asyncio.sleep(0.005)
        finally:
            await app.stop()

    try:
        asyncio.run(through_app())
    finally:
        if app.ranks is not None:
            app.ranks.close(join_s=10.0)
    return app, handles[-1], [json.loads(m.value()) for m in broker.drain("ai_response")]


def test_build_app_mesh_model2_serves_a_kafka_turn(monkeypatch):
    """``build_app`` with ``mesh.model=2`` on the CPU: this process is rank
    0 (the app, the scheduler, the engine's calls mirrored), one follower
    process loads its own shard from the seed; the Kafka turn completes in
    the chunk schema, its response tokens equal the one-device app's (gate
    (b): a difference only at a top-2 margin <= 1e-3 of the one-device
    plain forward, and then the chunks up to it), the pages held are the one-device app's,
    and stopping the app leaves no follower alive and no process group."""
    import torch.distributed as dist

    from finchat_tpu_torch.serve import app as tapp

    monkeypatch.setattr(tapp, "load_prompts", lambda: (APP_SYSTEM, APP_TOOL))
    # one intra-op thread a rank: two processes spinning on every core for
    # each of their small ops slow a turn several times over; the spawned
    # rank reads the variable at its start
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one_app, one, one_chunks = _app_turn(1)
        app, got, chunks = _app_turn(2)
    finally:
        torch.set_num_threads(threads)
    assert one_app.ranks is None
    assert app.ranks is not None and app.ranks.closed and app.ranks.live == 0
    assert not dist.is_initialized()
    assert app.scheduler.engine.config.tp.size == 2
    # the registered prompt heads hold their pages, as on one device
    assert app.scheduler.allocator.used_count == one_app.scheduler.allocator.used_count
    assert chunks[-1]["type"] == "complete" and chunks[-1]["message"] == "What about coffee?"
    assert [c for c in chunks if "type" not in c] == []  # no error chunk
    assert list(got.prompt_ids) == list(one.prompt_ids)
    served = list(got.history[len(got.prompt_ids):])
    want = list(one.history[len(one.prompt_ids):])
    assert served
    cfg = dataclasses.replace(tllama.PRESETS["tiny"], dtype=torch.float32)
    ids = torch.tensor([list(one.prompt_ids) + want[:-1]])
    with torch.no_grad():
        logits = tllama.forward_full(one_app.scheduler.engine.params, ids,
                                     torch.arange(ids.shape[1])[None],
                                     config=cfg)[0, len(one.prompt_ids) - 1:]
    if _gate_b(served, want, _margins(logits.numpy())) == len(want):
        assert chunks == one_chunks


def test_build_app_mesh_answers_promptly_when_a_follower_dies(monkeypatch):
    """``build_app`` with ``mesh.model=2``: once the follower process is
    killed, rank 0 sees it within a 10 s wait (the group's timeout is
    120 s): ``/health`` answers a retryable 503, a Kafka turn gets a
    retryable error chunk, an engine call raises ``RankDown`` instead of
    blocking in a collective, and stopping the app leaves no follower and
    no process group."""
    import time

    import torch.distributed as dist

    from finchat_tpu_torch.engine.generator import StubGenerator
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.parallel.ranks import RankDown
    from finchat_tpu_torch.serve import app as tapp
    from finchat_tpu_torch.utils.config import load_config

    monkeypatch.setattr(tapp, "load_prompts", lambda: (APP_SYSTEM, APP_TOOL))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = load_config(overrides={
        "model.preset": "tiny", "model.dtype": "float32", "model.seed": 5, "mesh.model": 2,
        **{f"engine.{k}": v for k, v in APP_ENGINE.items()}})
    store = InMemoryStore()
    store.upsert_context("c1", APP_CONTEXT)
    store.add_user_message("c1", "How am I doing?", "u9", timestamp=100)
    broker = InMemoryBroker()
    app = tapp.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                         tool_generator=StubGenerator(default=APP_RETRIEVE),
                         retriever=_app_retriever, device="cpu")
    leader = app.scheduler.engine.leader

    async def scenario():
        await app.start(serve_http=False)
        try:
            assert (await app.health(None)).status == 200
            app.ranks.procs[0].kill()
            t0 = time.monotonic()
            while leader.failure is None and time.monotonic() - t0 < 10.0:
                await asyncio.sleep(0.05)
            health = await app.health(None)
            KafkaClient(cfg.kafka, broker=broker).produce_message(
                "user_message", "c1", {"message": "What about coffee?", "conversation_id": "c1",
                                       "user_id": "u9", "message_id": "m-dead"})
            chunks: list = []
            for _ in range(2000):  # bounded: 10 s of 5 ms ticks
                chunks += [json.loads(m.value()) for m in broker.drain("ai_response")]
                if chunks:
                    break
                await asyncio.sleep(0.005)
            with pytest.raises(RankDown, match="exited"):
                app.scheduler.engine.reset_slot(0)
            return health, chunks
        finally:
            await app.stop()

    try:
        health, chunks = asyncio.run(scenario())
    finally:
        app.ranks.close(join_s=10.0)
    assert leader.failure and "exited" in leader.failure
    assert health.status == 503 and json.loads(health.body)["retryable"] is True
    assert chunks and all(c.get("retryable") is True for c in chunks), chunks
    assert app.ranks.closed and app.ranks.live == 0
    assert not dist.is_initialized()
