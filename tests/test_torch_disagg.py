"""The port's disaggregated prefill/decode serving against the JAX
package's, on CPU at fp32.

The non-fabric cases of the JAX package's tests/test_disagg.py run on both
packages' fleets (serve/disagg.py, serve/fleet.py) over the same converted
``tiny`` fp32 weights: role parsing, routing over the serving pool with the
disagg families seeded, the empty serving pool and the empty prefill pool
(each a counted fallback), a cold turn prefilled on the prefill replica and
handed over, a warm turn that skips the handoff, a bounded-KV prompt whose
handed-off entry carries its gap, a cross-mode snapshot refused and
counted, a fault in the prefill pass, a decode replica's breaker trip
racing the handed-off turn, and every ingress path routing through
``agent_for``. Held across packages: counters by reason and replica, the
handed-off payload (conversation id, token ids, ``prefix_len``,
``kv_gap``, ``kv_sink`` and the snapshot's shapes and dtypes byte-equal;
the snapshot's KV within 2e-4, the two frameworks' fp32 noise), a JAX
payload imported by the port serving the same stream, and the greedy
streams under the teacher-forced contract; within each package the stream
equals the mixed fleet's exactly.
"""

import asyncio
import dataclasses
import json
import types
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401  (the leak audit)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.serve import disagg as jdisagg  # noqa: E402
from finchat_tpu.serve import fleet as jfleet  # noqa: E402
from finchat_tpu.utils import faults as jfaults  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.config import FleetConfig as JaxFleetConfig  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.serve import disagg as tdisagg  # noqa: E402
from finchat_tpu_torch.serve import fleet as tfleet  # noqa: E402
from finchat_tpu_torch.utils import faults  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig, FleetConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
CHUNK = 16
PAGE = 8
# tests/test_disagg.py's replica
ENGINE = dict(max_seqs=3, page_size=PAGE, num_pages=64, max_seq_len=256, prefill_chunk=CHUNK,
              session_cache=True, session_cache_bytes=16 << 20, breaker_max_rebuilds=1)
PREFILL, DECODE, MIXED = tdisagg.ROLE_PREFILL, tdisagg.ROLE_DECODE, tdisagg.ROLE_MIXED


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.disarm_all()
    jfaults.disarm_all()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _sides(models):
    jcfg, jparams, tcfg, tparams = models

    def port_replica(rid, role=MIXED, **over):
        eng = InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **over}), device="cpu")
        sched = ContinuousBatchingScheduler(eng, eos_id=-1, metrics=METRICS.labeled(replica=rid),
                                            replica_id=rid)
        return tfleet.EngineReplica(replica_id=rid, scheduler=sched, role=role)

    def jax_replica(rid, role=MIXED, **over):
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **over}), attn_backend="ref")
        sched = JaxScheduler(eng, eos_id=-1, metrics=JAX_METRICS.labeled(replica=rid),
                             replica_id=rid)
        return jfleet.EngineReplica(replica_id=rid, scheduler=sched, role=role)

    def ns(fleet_mod, disagg_mod, replica, fleet_cfg, faults_mod, metrics, sampling):
        def make_fleet(roles, **over):
            reps = [replica(str(i), role=role, **over) for i, role in enumerate(roles)]
            return fleet_mod.EngineFleet(reps, fleet_cfg(replicas=len(reps),
                                                         respawn_backoff_seconds=0.05,
                                                         supervisor_interval_seconds=0.05),
                                         num_partitions=16)

        def stub_fleet(roles):
            reps = [fleet_mod.EngineReplica(
                replica_id=str(i), role=r, scheduler=types.SimpleNamespace(
                    on_give_up=[], session_cache=None,
                    metrics=metrics.labeled(replica=str(i)))) for i, r in enumerate(roles)]
            return fleet_mod.EngineFleet(reps, fleet_cfg(replicas=len(roles), respawn=False),
                                         num_partitions=32)

        def get(name, rid, **labels):
            return metrics.get(name, {"replica": rid, **labels})

        return SimpleNamespace(fleet=fleet_mod, disagg=disagg_mod, replica=replica,
                               make_fleet=make_fleet, stub_fleet=stub_fleet, fleet_cfg=fleet_cfg,
                               faults=faults_mod, metrics=metrics, get=get,
                               greedy=lambda n: sampling(temperature=0.0, max_new_tokens=n))

    return {
        "port": ns(tfleet, tdisagg, port_replica, FleetConfig, faults, METRICS, SamplingParams),
        "jax": ns(jfleet, jdisagg, jax_replica, JaxFleetConfig, jfaults, JAX_METRICS,
                  JaxSampling),
    }


def _both(models, scenario):
    return {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}


async def _drain(handle):
    tokens = []
    while True:
        ev = await asyncio.wait_for(handle.events.get(), timeout=120)
        if ev["type"] == "token":
            tokens.append(ev["token_id"])
        elif ev["type"] == "done":
            return tokens, None
        else:
            return tokens, ev


def _serving(fleet):
    return next(r for r in fleet.replicas if r.role != PREFILL)


def _assert_teacher_forced(models, prompt, got, want):
    jcfg, jparams, _tc, _tp = models
    assert got and want
    n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return
    ids = jnp.asarray([prompt + want[:n]], jnp.int32)
    logits = np.asarray(jllama.forward_full(jparams, ids, jnp.arange(ids.shape[1])[None],
                                            config=jcfg, attn_backend="ref"))[0, -1]
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] <= MARGIN, (n, got[n], want[n], top2)


def _recording_imports(sched, box: list):
    """Record every payload ``sched`` is asked to import."""
    real = sched.import_session_entry

    def rec(payload, **kw):
        box.append(payload)
        return real(payload, **kw)

    sched.import_session_entry = rec


def _snap_arrays(snap) -> list:
    return [None if a is None else (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
            for a in snap]


def _assert_payloads_equal(got: dict, want: dict):
    """The handed-off payload: header fields byte-equal, the snapshot's
    shapes and dtypes equal, its KV within the frameworks' fp32 noise."""
    for key in ("conversation_id", "prefix_len", "kv_gap", "kv_sink"):
        assert got[key] == want[key], key
    assert np.asarray(got["token_ids"]).tobytes() == np.asarray(want["token_ids"]).tobytes()
    a, b = _snap_arrays(got["snap"]), _snap_arrays(want["snap"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.shape == y.shape and x.dtype.name == np.dtype(y.dtype).name
            np.testing.assert_allclose(x, y, atol=2e-4, rtol=0)


# --- role parsing and routing (no engines) ----------------------------------------

def test_parse_roles_contract():
    for mod in (tdisagg, jdisagg):
        assert mod.parse_roles("", 3) == [MIXED] * 3
        assert mod.parse_roles("prefill,decode", 4) == [PREFILL, DECODE, MIXED, MIXED]
        assert mod.parse_roles(" Prefill , decode , decode , mixed , mixed ", 3) == [
            PREFILL, DECODE, DECODE]
        with pytest.raises(ValueError, match="bogus"):
            mod.parse_roles("prefill,bogus", 2)
        assert mod.parse_roles("prefill,prefill", 2) == [MIXED] * 2
    assert (tdisagg.ROLES, tdisagg.FALLBACK_REASONS) == (jdisagg.ROLES, jdisagg.FALLBACK_REASONS)


def test_routing_excludes_prefill_pool_and_seeds_metrics(models):
    def scenario(side):
        fleet = side.stub_fleet([PREFILL, DECODE, DECODE, MIXED])
        assert fleet.disagg is not None
        assert getattr(fleet.replicas[0].scheduler, "disagg", None) is None
        for rep in fleet.replicas[1:]:
            assert rep.scheduler.disagg is fleet.disagg
        routes = [fleet.replica_for(f"conv-{i}").replica_id for i in range(200)]
        assert all(fleet._by_id[r].role != PREFILL for r in routes)
        roles = [side.get("finchat_disagg_role", str(i)) for i in range(4)]
        text = side.metrics.render_prometheus()
        for rid in ("0", "1", "2", "3"):
            for reason in side.disagg.FALLBACK_REASONS:
                assert f'finchat_disagg_fallbacks_total{{reason="{reason}",replica="{rid}"}}' \
                    in text
        return routes, roles

    out = {name: scenario(side) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"]
    assert out["port"][1] == [1, 2, 2, 0]


def test_empty_serving_pool_falls_back_to_prefill_and_counts(models):
    def scenario(side):
        fleet = side.stub_fleet([PREFILL, DECODE])
        before = side.get("finchat_disagg_fallbacks_total", "0", reason="serving_pool_empty")
        fleet.replicas[1].state = side.fleet.OUT
        rep = fleet.replica_for("conv-x")
        return (rep is fleet.replicas[0], rep.role,
                side.get("finchat_disagg_fallbacks_total", "0",
                         reason="serving_pool_empty") - before)

    out = {name: scenario(side) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == (True, PREFILL, 1)


# --- the handoff -------------------------------------------------------------------

def _turn(roles, prompt, conv, max_new, *, on=None, fault=None, **over):
    """One turn submitted to the fleet's first serving replica: its tokens,
    its resumed length, the per-replica counter deltas by reason, the
    payloads the serving replica imported."""
    async def run(side):
        fleet = side.make_fleet(roles, **over)
        serving = fleet.replicas[on] if on is not None else _serving(fleet)
        rid = serving.replica_id
        imported: list = []
        _recording_imports(serving.scheduler, imported)
        names = [("finchat_disagg_handoffs_total", {})] + [
            ("finchat_disagg_fallbacks_total", {"reason": r})
            for r in side.disagg.FALLBACK_REASONS] + [
            ("finchat_quant_dequant_fallbacks_total", {})]
        before = {(n, tuple(lb.items())): side.get(n, rid, **lb) for n, lb in names}
        d0 = side.metrics.get("finchat_fleet_drained_streams_total")
        await fleet.start()
        try:
            if fault is not None:
                fault(side, serving)
            h = await serving.scheduler.submit("t1", prompt, side.greedy(max_new),
                                               conversation_id=conv)
            toks, err = await _drain(h)
            assert err is None, err
            entry = serving.scheduler.session_cache.get(conv)
            out = {
                "tokens": toks, "resumed": h.resumed_len, "imported": imported,
                "delta": {f"{n}{dict(lb)}": side.get(n, rid, **lb) - before[(n, tuple(lb.items()))]
                          for n, lb in names},
                "drained": side.metrics.get("finchat_fleet_drained_streams_total") - d0,
                "entry": None if entry is None else (entry.n_tokens, entry.kv_gap,
                                                     entry.kv_sink),
                "source_clean": fleet.replicas[0].scheduler.session_cache.get(conv) is None,
            }
            for rep in fleet.replicas:
                if fault is None or rep is not serving:
                    rep.scheduler.allocator.check_invariants()
            return out
        finally:
            await fleet.stop()
            side.faults.disarm_all()
    return run


def test_empty_prefill_pool_counts_fallback_and_serves(models):
    prompt = list(range(1, 41))

    async def run(side):
        fleet = side.make_fleet([PREFILL, MIXED])
        await fleet.start()
        try:
            serving = _serving(fleet)
            fleet.replicas[0].state = side.fleet.OUT
            before = side.get("finchat_disagg_fallbacks_total", serving.replica_id,
                              reason="no_prefill_replica")
            h = await serving.scheduler.submit("t1", prompt, side.greedy(6),
                                               conversation_id="conv-np")
            toks, err = await _drain(h)
            assert err is None
            return toks, side.get("finchat_disagg_fallbacks_total", serving.replica_id,
                                  reason="no_prefill_replica") - before
        finally:
            await fleet.stop()

    out = _both(models, run)
    control = _both(models, _turn([MIXED, MIXED], prompt, "conv-np2", 6, on=0))
    for name in ("port", "jax"):
        assert out[name][1] == 1
        assert out[name][0] == control[name]["tokens"]
    _assert_teacher_forced(models, prompt, out["port"][0], out["jax"][0])


def test_cold_turn_handoff_byte_identity_and_warm_resume(models):
    """A cold turn prefills on the prefill replica, its KV crosses pools,
    admission resumes from it and the stream is the mixed fleet's; the
    handed payload is the JAX package's, and the JAX payload imported by the
    port serves the port's stream."""
    prompt = list(range(1, 41))  # a residue of 39 >= one chunk
    disagg = _both(models, _turn([PREFILL, DECODE], prompt, "conv-h", 8))
    mixed = _both(models, _turn([MIXED, MIXED], prompt, "conv-h", 8))
    for name in ("port", "jax"):
        d = disagg[name]
        assert d["tokens"] == mixed[name]["tokens"]
        assert d["delta"]["finchat_disagg_handoffs_total{}"] == 1
        assert mixed[name]["delta"]["finchat_disagg_handoffs_total{}"] == 0
        assert d["resumed"] > 0 and d["source_clean"]
        assert len(d["imported"]) == 1
    assert disagg["port"]["delta"] == disagg["jax"]["delta"]
    assert disagg["port"]["resumed"] == disagg["jax"]["resumed"]
    _assert_payloads_equal(disagg["port"]["imported"][0], disagg["jax"]["imported"][0])
    _assert_teacher_forced(models, prompt, disagg["port"]["tokens"], disagg["jax"]["tokens"])
    for metrics in (METRICS, JAX_METRICS):
        assert metrics.snapshot().get('finchat_disagg_handoff_seconds{replica="1"}_count', 0) >= 1

    # the JAX payload over the wire into the port's decode replica
    jpayload = dict(disagg["jax"]["imported"][0])
    jpayload["snap"] = tuple(None if a is None else torch.from_numpy(np.array(a))
                             for a in jpayload["snap"])
    side = _sides(models)["port"]

    async def wire():
        rep = side.replica("9")
        await rep.scheduler.start()
        try:
            assert rep.scheduler.import_session_entry(jpayload)
            h = await rep.scheduler.submit("t1", prompt, side.greedy(8), conversation_id="conv-h")
            toks, err = await _drain(h)
            assert err is None
            return toks, h.resumed_len
        finally:
            await rep.scheduler.stop()

    toks, resumed = asyncio.run(wire())
    assert resumed == disagg["port"]["resumed"]
    _assert_teacher_forced(models, prompt, toks, disagg["jax"]["tokens"])


def test_warm_turn_skips_the_handoff(models):
    async def run(side):
        fleet = side.make_fleet([PREFILL, DECODE])
        await fleet.start()
        try:
            serving = _serving(fleet)
            rid = serving.replica_id
            prompt = list(range(1, 41))
            h = await serving.scheduler.submit("t1", prompt, side.greedy(8),
                                               conversation_id="conv-w")
            t1, err = await _drain(h)
            assert err is None
            h1 = side.get("finchat_disagg_handoffs_total", rid)
            h2 = await serving.scheduler.submit("t2", prompt + t1 + [5, 6, 7], side.greedy(4),
                                                conversation_id="conv-w")
            _t2, err = await _drain(h2)
            assert err is None
            return h2.resumed_len > 0, side.get("finchat_disagg_handoffs_total", rid) - h1
        finally:
            await fleet.stop()

    out = _both(models, run)
    assert out["port"] == out["jax"] == (True, 0)


def test_bounded_kv_gapped_handoff(models):
    """A prompt past the bounded budget evicts during the prefill pass: the
    handed entry carries its ``kv_gap``/``kv_sink``, equal across packages,
    and the stream equals the mixed bounded fleet's."""
    bounded = dict(kv_sink_pages=1, kv_window_pages=4, num_pages=128)
    prompt = list(range(1, 57))  # 56 tokens > the 40-token budget
    disagg = _both(models, _turn([PREFILL, DECODE], prompt, "conv-b", 8, **bounded))
    mixed = _both(models, _turn([MIXED, MIXED], prompt, "conv-b", 8, **bounded))
    for name in ("port", "jax"):
        d = disagg[name]
        assert d["delta"]["finchat_disagg_handoffs_total{}"] == 1
        assert d["tokens"] == mixed[name]["tokens"]
        assert d["entry"] is not None and d["entry"][1] > 0
        assert d["imported"][0]["kv_gap"] > 0
    assert disagg["port"]["delta"] == disagg["jax"]["delta"]
    assert disagg["port"]["entry"] == disagg["jax"]["entry"]
    _assert_payloads_equal(disagg["port"]["imported"][0], disagg["jax"]["imported"][0])
    _assert_teacher_forced(models, prompt, disagg["port"]["tokens"], disagg["jax"]["tokens"])


def test_crossmode_handoff_refused_and_counted(models):
    """An int8-KV prefill replica and an fp32 decode replica: the snapshot is
    refused at import, both counters fire, the turn prefills locally and
    equals a mixed fp32 fleet's."""
    prompt = list(range(1, 41))

    def run_for(side):
        async def run():
            reps = [side.replica("0", role=PREFILL, kv_quant="int8"),
                    side.replica("1", role=DECODE)]
            fleet = side.fleet.EngineFleet(reps, side.fleet_cfg(replicas=2, respawn=False),
                                           num_partitions=16)
            await fleet.start()
            try:
                q0 = side.get("finchat_quant_dequant_fallbacks_total", "1")
                f0 = side.get("finchat_disagg_fallbacks_total", "1", reason="import_refused")
                h = await reps[1].scheduler.submit("t1", prompt, side.greedy(6),
                                                   conversation_id="conv-q")
                toks, err = await _drain(h)
                assert err is None
                return (toks, side.get("finchat_quant_dequant_fallbacks_total", "1") - q0,
                        side.get("finchat_disagg_fallbacks_total", "1",
                                 reason="import_refused") - f0,
                        reps[1].scheduler.session_cache.get("conv-q") is not None)
            finally:
                await fleet.stop()
        return run()

    out = {name: asyncio.run(run_for(side)) for name, side in _sides(models).items()}
    control = _both(models, _turn([MIXED, MIXED], prompt, "conv-q2", 6, on=1))
    for name in ("port", "jax"):
        assert out[name][1:] == (1, 1, True)
        assert out[name][0] == control[name]["tokens"]
    _assert_teacher_forced(models, prompt, out["port"][0], out["jax"][0])


def test_prefill_pass_error_falls_back_to_local_prefill(models):
    prompt = list(range(1, 41))

    def wedge(seq_id="", **_ctx):
        if seq_id.startswith("__disagg_"):
            raise RuntimeError("drill: prefill pool fault")

    def arm(side, _serving):
        side.faults.arm("scheduler.prefill", wedge)

    clean = _both(models, _turn([PREFILL, DECODE], prompt, "conv-e", 6))
    chaos = _both(models, _turn([PREFILL, DECODE], prompt, "conv-e", 6, fault=arm))
    for name in ("port", "jax"):
        assert chaos[name]["delta"]["finchat_disagg_fallbacks_total{'reason': 'prefill_error'}"] \
            == 1
        assert clean[name]["delta"]["finchat_disagg_fallbacks_total{'reason': 'prefill_error'}"] \
            == 0
        assert chaos[name]["tokens"] == clean[name]["tokens"]
    assert chaos["port"]["delta"] == chaos["jax"]["delta"]
    _assert_teacher_forced(models, prompt, chaos["port"]["tokens"], chaos["jax"]["tokens"])


def test_handoff_then_decode_breaker_trip_drains_clean(models):
    """The decode replica imports the handoff, wedges on its first decode
    round, trips, and the drain hands the stream with its session bytes to
    the other decode replica: the same stream, no error, no leak."""
    prompt = list(range(1, 41))

    def arm(side, victim):
        dead = [True]

        def wedge(**ctx):
            if dead[0] and ctx.get("replica") == victim.replica_id:
                raise RuntimeError("drill: decode pool trip")

        side.faults.arm("scheduler.decode", wedge)
        side.faults.arm("engine.rebuild", wedge)

    clean = _both(models, _turn([PREFILL, DECODE, DECODE], prompt, "conv-t", 8))
    chaos = _both(models, _turn([PREFILL, DECODE, DECODE], prompt, "conv-t", 8, fault=arm))
    for name in ("port", "jax"):
        assert clean[name]["delta"]["finchat_disagg_handoffs_total{}"] == 1
        assert chaos[name]["delta"]["finchat_disagg_handoffs_total{}"] == 1
        assert chaos[name]["tokens"] == clean[name]["tokens"]
        assert chaos[name]["drained"] >= 1
    assert chaos["port"]["drained"] == chaos["jax"]["drained"]
    _assert_teacher_forced(models, prompt, chaos["port"]["tokens"], chaos["jax"]["tokens"])


# --- ingress parity -------------------------------------------------------------

def test_all_ingress_paths_route_through_fleet_agent_for():
    """HTTP /chat, /chat/stream and the Kafka worker each take their agent
    from ``fleet.agent_for`` with the bare conversation id, in both
    packages."""
    from finchat_tpu.engine.generator import StubGenerator as JaxStub
    from finchat_tpu.io.kafka import InMemoryBroker as JaxBroker
    from finchat_tpu.io.kafka import KafkaClient as JaxKafka
    from finchat_tpu.io.kafka import Message as JaxMessage
    from finchat_tpu.io.store import InMemoryStore as JaxStore
    from finchat_tpu.serve.app import build_app as jax_build_app
    from finchat_tpu.serve.http import Request as JaxRequest
    from finchat_tpu.utils.config import USER_MESSAGE_TOPIC
    from finchat_tpu.utils.config import load_config as jax_load_config
    from finchat_tpu_torch.engine.generator import StubGenerator
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient, Message
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.serve.app import build_app
    from finchat_tpu_torch.serve.http import Request
    from finchat_tpu_torch.utils.config import load_config

    async def no_rows(**_kw):
        return []

    def drive(build, load, store_cls, broker_cls, kafka_cls, stub, request, message, **kw):
        cfg = load(overrides={"model.preset": "stub"})
        store = store_cls()
        store.upsert_context("c1", {"user_id": "u9", "name": "Alex", "income": 5000,
                                    "savings_goal": 800})
        store.add_user_message("c1", "How am I doing?", "u9")
        app = build(cfg, store=store, kafka=kafka_cls(cfg.kafka, broker=broker_cls()),
                    tool_generator=stub(default="No tool call"),
                    response_generator=stub(default="Hi.", chunk_delay=0.001), **kw)
        calls: list[str] = []
        real_agent = app.agent

        class RecordingFleet:
            replicas: list = []

            def agent_for(self, conversation_id):
                calls.append(conversation_id)
                return real_agent

        app.fleet = RecordingFleet()
        body = json.dumps({"message": "How am I doing?", "conversation_id": "c1",
                           "user_id": "u9"}).encode()

        async def run():
            resp = await app.chat(request("POST", "/chat", {}, body))
            assert resp.status == 200
            stream = await app.chat_stream(request("POST", "/chat/stream", {}, body))
            async for _chunk in stream.chunks:
                pass
            await app.process_message(message(USER_MESSAGE_TOPIC, "c1", body))

        asyncio.run(run())
        return calls

    port = drive(build_app, load_config, InMemoryStore, InMemoryBroker, KafkaClient,
                 StubGenerator, Request, Message, retriever=no_rows, device="cpu")
    jax_ = drive(jax_build_app, jax_load_config, JaxStore, JaxBroker, JaxKafka, JaxStub,
                 JaxRequest, JaxMessage, retriever=no_rows)
    assert port == jax_ == ["c1", "c1", "c1"]
