"""The port's engine fleet against the JAX package's, on CPU at fp32.

Every case of the JAX package's tests/test_fleet.py runs on both packages'
fleets (serve/fleet.py), over the same converted ``tiny`` fp32 weights (the
JAX engines on their reference attention): rendezvous routing and its
partition alignment, the reshuffle on a replica's loss, the shared dedupe
ring, the drain of a killed replica's streams to siblings with the give-up,
OUT and the supervised respawn, a cancel reaching the adopter, the give-up
with no sibling, the adopter's queue bound, the prefix-job and revive
seams, the poll gate, session migration at route time (bare and per-role
keys), the drain sink's routing by conversation, the import's head re-link
or refusal, and the labeled metrics. Held across packages: the chosen
replicas, the counter deltas, the error events (dicts equal), the states,
and the greedy streams under the teacher-forced contract of the port's
other scheduler tests (equal up to their first difference, where the JAX
forward's top-2 margin must be within 1e-3). Within each package a drained
stream equals its undisturbed run exactly.

Besides: routing equal across packages on 5,000 seeded keys, the
synchronous ``revive``, the app's drain order (tests/test_durability.py:
the supervisor stops before the replicas' drains), and ``build_app``'s
fleet: N replicas over one parameter tree (``data_ptr`` equal, bf16 and an
int8 tree quantized at load), the parsed roles, and a Kafka turn answered
as the JAX package's fleet answers it.
"""

import asyncio
import dataclasses
import logging
import threading
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
from finchat_tpu.engine.scheduler import _PrefixJob as JaxPrefixJob  # noqa: E402
from finchat_tpu.engine.session_cache import session_key as jax_session_key  # noqa: E402
from finchat_tpu.io.kafka import partition_for_key as jax_partition_for_key  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.serve import app as japp  # noqa: E402
from finchat_tpu.serve import fleet as jfleet  # noqa: E402
from finchat_tpu.utils import faults as jfaults  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.config import FleetConfig as JaxFleetConfig  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu.utils.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler, _PrefixJob  # noqa: E402
from finchat_tpu_torch.engine.session_cache import SESSION_KEY_ROLES, session_key  # noqa: E402
from finchat_tpu_torch.io.kafka import partition_for_key  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.serve import app as tapp  # noqa: E402
from finchat_tpu_torch.serve import fleet as tfleet  # noqa: E402
from finchat_tpu_torch.utils import faults  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig, FleetConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS, MetricsRegistry  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
# tests/test_fleet.py's replica: three slots, pages of 8, chunks of 16, a
# session cache, the breaker giving up after one rebuild
ENGINE = dict(max_seqs=3, page_size=8, num_pages=64, max_seq_len=128, prefill_chunk=16,
              session_cache=True, session_cache_bytes=16 << 20, breaker_max_rebuilds=1)
FLEET_COUNTERS = ("finchat_fleet_drained_streams_total", "finchat_fleet_drain_failures_total",
                  "finchat_fleet_session_migrations_total", "finchat_fleet_session_handoffs_total",
                  "finchat_fleet_session_import_refused_total", "finchat_fleet_respawns_total",
                  "finchat_fleet_reroutes_total")


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.disarm_all()
    jfaults.disarm_all()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite runs six workers
    on a few cores)."""
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
    """Each package's fleet stack, addressed the same way by the scenarios."""
    jcfg, jparams, tcfg, tparams = models

    def port_replica(rid, **over):
        eng = InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **over}), device="cpu")
        sched = ContinuousBatchingScheduler(eng, eos_id=-1, metrics=METRICS.labeled(replica=rid),
                                            replica_id=rid)
        return tfleet.EngineReplica(replica_id=rid, scheduler=sched)

    def jax_replica(rid, **over):
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **over}), attn_backend="ref")
        sched = JaxScheduler(eng, eos_id=-1, metrics=JAX_METRICS.labeled(replica=rid),
                             replica_id=rid)
        return jfleet.EngineReplica(replica_id=rid, scheduler=sched)

    def ns(fleet_mod, replica, fleet_cfg, faults_mod, metrics, sampling, prefix_job, skey,
           part, app_cls, registry):
        def make_fleet(n, **over):
            reps = [replica(str(i), **over) for i in range(n)]
            return fleet_mod.EngineFleet(reps, fleet_cfg(replicas=n, respawn_backoff_seconds=0.05,
                                                         supervisor_interval_seconds=0.05),
                                         num_partitions=16)

        def stub_fleet(n, num_partitions=32):
            reps = [fleet_mod.EngineReplica(
                replica_id=str(i), scheduler=types.SimpleNamespace(on_give_up=[],
                                                                   session_cache=None))
                    for i in range(n)]
            return fleet_mod.EngineFleet(reps, fleet_cfg(replicas=n, respawn=False),
                                         num_partitions=num_partitions)

        return SimpleNamespace(
            fleet=fleet_mod, replica=replica, make_fleet=make_fleet, stub_fleet=stub_fleet,
            fleet_cfg=fleet_cfg, faults=faults_mod, metrics=metrics,
            greedy=lambda n: sampling(temperature=0.0, max_new_tokens=n),
            prefix_job=prefix_job, session_key=skey, partition_for_key=part, App=app_cls,
            registry=registry)

    return {
        "port": ns(tfleet, port_replica, FleetConfig, faults, METRICS, SamplingParams,
                   _PrefixJob, session_key, partition_for_key, tapp.App, MetricsRegistry),
        "jax": ns(jfleet, jax_replica, JaxFleetConfig, jfaults, JAX_METRICS, JaxSampling,
                  JaxPrefixJob, jax_session_key, jax_partition_for_key, japp.App, JaxRegistry),
    }


def _both(models, scenario):
    """Run ``scenario(side)`` on each package; {package: result}."""
    return {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}


def _both_sync(models, scenario):
    return {name: scenario(side) for name, side in _sides(models).items()}


def _fleet_counters(metrics) -> dict:
    return {name: metrics.get(name) for name in FLEET_COUNTERS}


def _delta(metrics, before: dict) -> dict:
    return {name: metrics.get(name) - v for name, v in before.items()}


async def _drain(handle):
    tokens = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=120)
        if event["type"] == "token":
            tokens.append(event["token_id"])
        elif event["type"] == "done":
            return tokens, None
        else:
            return tokens, event


def _assert_teacher_forced(models, prompt, got, want):
    """The port's greedy stream equals the JAX one up to their first
    difference, and there the JAX forward's top-2 margin is a near tie."""
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


# --- rendezvous routing (no engines) -----------------------------------------

def test_routing_agrees_across_packages_on_seeded_keys():
    """The same replica for every key: rendezvous over blake2b on 5,000
    seeded keys and candidate lists of 1 to 8, and the CRC32 partition of
    5,000 seeded conversation ids at 1 to 64 partitions."""
    rng = np.random.default_rng(23)
    for _ in range(5000):
        key = "".join(chr(c) for c in rng.integers(32, 0x2FF, size=int(rng.integers(1, 24))))
        cands = [str(c) for c in rng.choice(64, size=int(rng.integers(1, 9)), replace=False)]
        assert tfleet.rendezvous_hash(key, cands) == jfleet.rendezvous_hash(key, cands)
        n = int(rng.integers(1, 65))
        assert partition_for_key(key, n) == jax_partition_for_key(key, n)
    assert tfleet.rendezvous_hash("k", []) is None


def test_rendezvous_loss_moves_only_the_lost_share():
    cands = [str(i) for i in range(4)]
    keys = [str(p) for p in range(64)]
    for mod in (tfleet, jfleet):
        before = {k: mod.rendezvous_hash(k, cands) for k in keys}
        survivors = [c for c in cands if c != "2"]
        after = {k: mod.rendezvous_hash(k, survivors) for k in keys}
        for k in keys:
            assert (after[k] != "2") if before[k] == "2" else (after[k] == before[k])
        assert {k: mod.rendezvous_hash(k, cands) for k in keys} == before
        moved = sum(1 for k in keys if before[k] == "2")
        assert 0 < moved < len(keys) / 2
    assert before == {k: tfleet.rendezvous_hash(k, cands) for k in keys}


def test_fleet_reshuffle_fraction_on_replica_loss(models):
    def scenario(side):
        fleet = side.stub_fleet(4)
        convs = [f"conv-{i}" for i in range(200)]
        before = {c: fleet.replica_for(c).replica_id for c in convs}
        victim = fleet.replicas[1]
        victim.state = side.fleet.OUT
        after = {c: fleet.replica_for(c).replica_id for c in convs}
        moved = [c for c in convs if after[c] != before[c]]
        assert all(before[c] == victim.replica_id for c in moved)
        assert all(after[c] != victim.replica_id for c in convs)
        assert len(moved) <= len(convs) * 2 / 4
        victim.state = side.fleet.LIVE
        assert {c: fleet.replica_for(c).replica_id for c in convs} == before
        return before, after

    out = _both_sync(models, scenario)
    assert out["port"] == out["jax"]


def test_routing_agrees_with_kafka_partition_assignment(models):
    def scenario(side):
        fleet = side.stub_fleet(4, num_partitions=8)
        by_partition: dict[int, str] = {}
        for i in range(100):
            conv = f"c{i}"
            part = side.partition_for_key(conv, 8)
            assert part == fleet.partition_for(conv)
            rid = fleet.replica_for(conv).replica_id
            assert rid == fleet.replica_for_partition(part).replica_id
            assert by_partition.setdefault(part, rid) == rid
        assert len(set(by_partition.values())) > 1
        return by_partition

    out = _both_sync(models, scenario)
    assert out["port"] == out["jax"]


def test_overprovisioned_fleet_warns(models, caplog):
    for name, side in _sides(models).items():
        logger = side.fleet.__name__
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            side.stub_fleet(5, num_partitions=4)
        assert any("NO traffic" in r.getMessage() for r in caplog.records), name
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            side.stub_fleet(4, num_partitions=4)
        assert not [r for r in caplog.records if r.name == logger], name


def test_no_live_replica_raises(models):
    for side in _sides(models).values():
        fleet = side.stub_fleet(2)
        for rep in fleet.replicas:
            rep.state = side.fleet.OUT
        assert fleet.replica_for("c") is None
        with pytest.raises(RuntimeError, match="no live engine replica"):
            fleet.agent_for("c")


def test_dedupe_ring_shared_and_forget_removes_ring_slot(models):
    def scenario(side):
        ring = side.fleet.DedupeRing(size=4)
        seen = [ring.seen("m1"), ring.seen("m1"), ring.seen("m2")]
        ring.forget("m2")
        seen.append(ring.seen("m2"))
        for i in range(10):
            ring.seen(f"fill-{i}")
        seen.append(ring.seen("m1"))
        return seen, list(ring._ring)

    out = _both_sync(models, scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [False, True, False, False, False]


def test_replica_labeled_metrics_render(models):
    def scenario(side):
        reg = side.registry()
        reg.labeled(replica="0").inc("finchat_preemptions_total")
        reg.labeled(replica="1").inc("finchat_preemptions_total", 2)
        reg.labeled(replica="1").set_gauge("finchat_breaker_state", 1)
        assert reg.get("finchat_preemptions_total", {"replica": "0"}) == 1
        assert reg.get("finchat_preemptions_total", {"replica": "1"}) == 2
        text = reg.render_prometheus()
        assert text.count("# TYPE finchat_preemptions_total counter") == 1
        assert 'finchat_preemptions_total{replica="1"} 2' in text
        assert 'finchat_breaker_state{replica="1"} 1' in text
        return text

    out = _both_sync(models, scenario)
    assert out["port"] == out["jax"]


def test_poll_gate_counts_only_live_replicas(models):
    def scenario(side):
        fleet = side.stub_fleet(4)
        stub = types.SimpleNamespace(
            cfg=types.SimpleNamespace(engine=types.SimpleNamespace(max_seqs=3)), fleet=fleet)
        seen = [side.App._max_inflight(stub)]
        fleet.replicas[0].state = side.fleet.OUT
        seen.append(side.App._max_inflight(stub))
        for rep in fleet.replicas:
            rep.state = side.fleet.OUT
        seen.append(side.App._max_inflight(stub))
        stub.fleet = None
        seen.append(side.App._max_inflight(stub))
        return seen

    out = _both_sync(models, scenario)
    assert out["port"] == out["jax"] == [12, 9, 3, 3]


def test_drain_sink_routes_by_conversation_not_role_key(models):
    def scenario(side):
        fleet = side.stub_fleet(4)
        adopted: list[str] = []
        imported: list[str] = []
        for rep in fleet.replicas:
            rep.scheduler.adopt = (lambda h, rid=rep.replica_id: (adopted.append(rid), True)[1])
            rep.scheduler.import_session_entry = (
                lambda p, rid=rep.replica_id: imported.append(rid) or True)
        source = fleet.replicas[0]

        def owner(key):
            return fleet.replica_for_partition(fleet.partition_for(key), exclude=source)

        conv = next(c for c in (f"conv-{i}" for i in range(500))
                    if owner(c) is not owner(side.session_key(c, "resp")))
        expected = owner(conv).replica_id
        sink = source.scheduler.drain_sink
        for role in SESSION_KEY_ROLES:
            handle = types.SimpleNamespace(conversation_id=side.session_key(conv, role),
                                           seq_id=f"s-{role}")
            assert sink(handle, {"conversation_id": handle.conversation_id})
        assert adopted == [expected] * 2
        assert imported == [expected] * 2
        return conv, expected

    out = _both_sync(models, scenario)
    assert out["port"] == out["jax"]


# --- real engines: drain, respawn, migration ----------------------------------

def test_drain_handoff_byte_identity_and_respawn(models):
    """One replica of three killed mid-stream (its decode and revive sites
    wedged until healed): every stream completes on a sibling with the
    tokens of an undisturbed run, no error; the victim goes OUT and respawns
    LIVE after the heal. The same victim, counters and gauges in both
    packages."""
    prompts = {f"conv-{i}": list(range(7 * i + 1, 7 * i + 15)) for i in range(6)}

    def scenario(fault):
        async def run(side):
            fleet = side.make_fleet(3)
            before = _fleet_counters(side.metrics)
            await fleet.start()
            out: dict = {"errors": 0}
            try:
                victim = next(rep for rep in fleet.replicas
                              if any(fleet.replica_for(c) is rep for c in prompts))
                out["victim"] = victim.replica_id
                handles = {}
                for conv, prompt in prompts.items():
                    rep = fleet.replica_for(conv)
                    handles[conv] = await rep.scheduler.submit(conv, prompt, side.greedy(10),
                                                               conversation_id=conv)
                tasks = {c: asyncio.create_task(_drain(h)) for c, h in handles.items()}
                if fault:
                    while any(h.generated < 2 for h in handles.values()
                              if fleet.replica_for(h.conversation_id) is victim):
                        await asyncio.sleep(0.002)
                    dead = [True]

                    def wedge(**ctx):
                        if dead[0] and ctx.get("replica") == victim.replica_id:
                            raise RuntimeError("drill: dead replica")

                    side.faults.arm("scheduler.decode", wedge)
                    side.faults.arm("engine.rebuild", wedge)
                results = {c: await t for c, t in tasks.items()}
                out["tokens"] = {c: toks for c, (toks, _e) in results.items()}
                out["errors"] = sum(1 for _t, e in results.values() if e is not None)
                if fault:
                    for i in range(6):
                        if victim.state != side.fleet.LIVE:
                            break
                        h = await victim.scheduler.submit(f"probe{i}",
                                                          list(range(50 + i, 62 + i)),
                                                          side.greedy(3))
                        _t, e = await _drain(h)
                        out["errors"] += 1 if e is not None else 0
                    for _ in range(2000):
                        if victim.state != side.fleet.LIVE:
                            break
                        await asyncio.sleep(0.01)
                    out["victim_out"] = victim.state != side.fleet.LIVE
                    out["live_during"] = int(side.metrics.get("finchat_fleet_replicas_live"))
                    dead[0] = False
                    for _ in range(2000):
                        if victim.state == side.fleet.LIVE:
                            break
                        await asyncio.sleep(0.01)
                    out["victim_respawned"] = victim.state == side.fleet.LIVE
                    out["live_after"] = int(side.metrics.get("finchat_fleet_replicas_live"))
                for rep in fleet.replicas:
                    rep.scheduler.allocator.check_invariants()
            finally:
                await fleet.stop()
                side.faults.disarm_all()
            out["delta"] = _delta(side.metrics, before)
            return out
        return run

    clean = _both(models, scenario(False))
    chaos = _both(models, scenario(True))
    for name in ("port", "jax"):
        c = chaos[name]
        assert c["errors"] == 0, name
        assert c["tokens"] == clean[name]["tokens"], f"{name}: the drain changed a stream"
        assert c["delta"]["finchat_fleet_drained_streams_total"] >= 1
        assert c["victim_out"] and c["live_during"] == 2
        assert c["victim_respawned"] and c["live_after"] == 3
    assert chaos["port"]["victim"] == chaos["jax"]["victim"]
    # the drained streams, the sessions handed over and the respawn agree;
    # how many probes the wedged replica still adopted out depends on when
    # its breaker gave up, the same rule in both packages
    assert chaos["port"]["delta"] == chaos["jax"]["delta"]
    for conv, prompt in prompts.items():
        _assert_teacher_forced(models, prompt, chaos["port"]["tokens"][conv],
                               chaos["jax"]["tokens"][conv])


def test_cancel_of_drained_handle_targets_adopter(models):
    def scenario(side):
        async def run():
            fleet = side.make_fleet(2)
            await fleet.start()
            try:
                a, b = fleet.replicas
                h = await a.scheduler.submit("drained", list(range(1, 14)), side.greedy(40))
                other = await a.scheduler.submit("bystander", list(range(30, 44)),
                                                 side.greedy(40))
                while h.generated < 2 or other.generated < 2:
                    await asyncio.sleep(0.002)
                a.scheduler._preempt(h, for_rebuild=True)
                a.scheduler.pending.remove(h)
                b.scheduler.adopt(h)
                assert h.owner is b.scheduler
                while h.slot < 0:
                    await asyncio.sleep(0.002)
                a.scheduler.cancel(h)
                for _ in range(500):
                    if h.finished and h.slot == -1:
                        break
                    await asyncio.sleep(0.01)
                assert h.finished
                g0 = other.generated
                for _ in range(500):
                    if other.generated > g0 or other.finished:
                        break
                    await asyncio.sleep(0.01)
                assert other.generated > g0 or other.finished
                toks, err = await _drain(other)
                assert err is None
                for rep in fleet.replicas:
                    rep.scheduler.allocator.check_invariants()
                assert len(b.scheduler.free_slots) == 3
                assert not b.scheduler.decoding
                return other.generated
            finally:
                await fleet.stop()
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == 40


def test_giveup_with_no_sibling_counts_each_drain_failure_once(models):
    def scenario(side):
        async def run():
            reps = [side.replica(str(i)) for i in range(2)]
            fleet = side.fleet.EngineFleet(reps, side.fleet_cfg(replicas=2, respawn=False),
                                           num_partitions=16)
            await fleet.start()
            out: dict = {}
            try:
                a, b = fleet.replicas
                fleet._mark_out(b)
                handles = [await a.scheduler.submit(
                    f"lone-{i}", list(range(3 * i + 1, 3 * i + 14)), side.greedy(40),
                    conversation_id=f"lone-{i}") for i in range(2)]
                while any(h.generated < 2 for h in handles):
                    await asyncio.sleep(0.002)
                before = _fleet_counters(side.metrics)
                side.faults.arm("scheduler.decode", lambda **ctx: (_ for _ in ()).throw(
                    RuntimeError("drill: no sibling")))
                results = [await _drain(h) for h in handles]
                out["errors"] = [e for _t, e in results]
                out["delta"] = _delta(side.metrics, before)
                out["queue_depth"] = side.metrics.get("finchat_queue_depth",
                                                      labels={"replica": "0"})
                out["state"] = (a.state, b.state)
            finally:
                await fleet.stop()
                side.faults.disarm_all()
            return out
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    for o in out.values():
        assert all(e is not None and e["code"] == "replica_out" and e["retryable"]
                   for e in o["errors"])
        assert o["delta"]["finchat_fleet_drain_failures_total"] == 2
        assert o["delta"]["finchat_fleet_drained_streams_total"] == 0
        assert o["queue_depth"] == 0
    assert out["port"] == out["jax"]


def test_adopt_honors_queue_bound_for_never_admitted_handles(models):
    def scenario(side):
        async def run():
            a = side.replica("0")
            b = side.replica("1", max_queue_depth=2)
            fleet = side.fleet.EngineFleet([a, b], side.fleet_cfg(replicas=2, respawn=False),
                                           num_partitions=16)
            for i in range(2):
                await b.scheduler.submit(f"b-{i}", list(range(1, 10)), side.greedy(8))
            fresh = await a.scheduler.submit("fresh", list(range(1, 10)), side.greedy(8),
                                             conversation_id="cv")
            seen = [b.scheduler.adopt(fresh), fresh.owner is a.scheduler,
                    len(b.scheduler.pending)]
            drained0 = side.metrics.get("finchat_fleet_drained_streams_total")
            sink = fleet._make_drain_sink(a)
            seen.append(sink(fresh, None))
            seen.append(side.metrics.get("finchat_fleet_drained_streams_total") - drained0)
            live = await a.scheduler.submit("live", list(range(1, 10)), side.greedy(8))
            live.preempted = True
            seen += [b.scheduler.adopt(live), live.owner is b.scheduler,
                     b.scheduler.pending[0] is live]
            return seen
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == [False, True, 2, False, 0, True, True, True]


def test_fail_prefix_job_resolves_future_when_reset_slot_raises(models):
    def scenario(side):
        async def run():
            sched = side.replica("0").scheduler
            pages = sched.allocator.allocate("__prefix_test__", 2)
            slot = sched.free_slots.pop()
            job = side.prefix_job(ids=list(range(16)), shared_len=16, owner="__prefix_test__",
                                  pages=pages, slot=slot,
                                  future=asyncio.get_running_loop().create_future())
            sched._prefix_jobs.append(job)

            def dead(_slot):
                raise RuntimeError("drill: device gone")

            sched.engine.reset_slot = dead
            sched._fail_prefix_job(job)
            sched.allocator.check_invariants()
            return (job.future.done() and job.future.result(), job in sched._prefix_jobs,
                    slot in sched.free_slots)
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == (0, False, True)


@pytest.mark.parametrize("how", ["revive_async", "revive"])
def test_revive_async_threads_rebuild_and_resolves_prefix_futures(models, how):
    """``revive_async`` rebuilds in a worker thread and ``revive`` on the
    caller's; either resolves a stranded prefix job with no device op and
    clears the give-up."""
    def scenario(side):
        async def run():
            sched = side.replica("0").scheduler
            pages = sched.allocator.allocate("__prefix_test__", 1)
            slot = sched.free_slots.pop()
            job = side.prefix_job(ids=list(range(8)), shared_len=8, owner="__prefix_test__",
                                  pages=pages, slot=slot,
                                  future=asyncio.get_running_loop().create_future())
            sched._prefix_jobs.append(job)
            sched.gave_up = True
            threads: list[int] = []
            real = sched.engine.rebuild_device_state

            def spying():
                threads.append(threading.get_ident())
                real()

            sched.engine.rebuild_device_state = spying
            ok = await sched.revive_async() if how == "revive_async" else sched.revive()
            sched.allocator.check_invariants()
            return (ok, (threads[0] != threading.get_ident()) == (how == "revive_async"),
                    job.future.done() and job.future.result(), len(sched._prefix_jobs),
                    sched.gave_up, len(sched.free_slots))
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == (True, True, 0, 0, False, 3)


def test_respawn_rechecks_giveup_before_marking_live(models):
    def scenario(side):
        async def run():
            fleet = side.make_fleet(2)
            await fleet.start()
            try:
                a, b = fleet.replicas
                rewedged = {"n": 0}

                def rewedge_once(rep):
                    if rep is b and rewedged["n"] == 0:
                        rewedged["n"] += 1
                        rep.scheduler.gave_up = True

                fleet.on_respawn.append(rewedge_once)
                b.scheduler.gave_up = True
                fleet._mark_out(b)
                for _ in range(1000):
                    if b.state == side.fleet.LIVE:
                        break
                    await asyncio.sleep(0.01)
                return b.state, rewedged["n"], b.scheduler.gave_up
            finally:
                await fleet.stop()
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == ("live", 1, False)


def test_session_migration_at_route_time(models):
    def scenario(kill_home):
        async def run(side):
            fleet = side.make_fleet(2)
            await fleet.start()
            try:
                conv = "mig-conv"
                home = fleet.replica_for(conv)
                t1_prompt = list(range(1, 14))
                h1 = await home.scheduler.submit("t1", t1_prompt, side.greedy(10),
                                                 conversation_id=conv)
                t1_tokens, err = await _drain(h1)
                assert err is None
                assert home.scheduler.session_cache.get(conv) is not None
                m0 = side.metrics.get("finchat_fleet_session_migrations_total")
                if kill_home:
                    home.state = side.fleet.OUT
                rep2 = fleet.replica_for(conv)
                if kill_home:
                    assert rep2 is not home
                    assert side.metrics.get("finchat_fleet_session_migrations_total") == m0 + 1
                    assert home.scheduler.session_cache.get(conv) is None
                    assert rep2.scheduler.session_cache.get(conv) is not None
                t2_prompt = t1_prompt + t1_tokens + [7, 8, 9]
                h2 = await rep2.scheduler.submit("t2", t2_prompt, side.greedy(8),
                                                 conversation_id=conv)
                t2_tokens, err = await _drain(h2)
                assert err is None
                return {"home": home.replica_id, "t1": t1_tokens, "t2": t2_tokens,
                        "t2_prompt": t2_prompt, "resumed": h2.resumed_len}
            finally:
                await fleet.stop()
        return run

    stay = _both(models, scenario(False))
    moved = _both(models, scenario(True))
    for name in ("port", "jax"):
        assert moved[name]["t2"] == stay[name]["t2"]
        assert moved[name]["resumed"] > 0
        assert moved[name]["resumed"] == stay[name]["resumed"]
    assert moved["port"]["home"] == moved["jax"]["home"]
    assert moved["port"]["resumed"] == moved["jax"]["resumed"]
    _assert_teacher_forced(models, list(range(1, 14)), moved["port"]["t1"], moved["jax"]["t1"])
    if moved["port"]["t1"] == moved["jax"]["t1"]:
        _assert_teacher_forced(models, moved["jax"]["t2_prompt"], moved["port"]["t2"],
                               moved["jax"]["t2"])


def test_route_time_migration_moves_role_suffixed_keys(models):
    def scenario(side):
        async def run():
            fleet = side.make_fleet(2)
            await fleet.start()
            try:
                conv = "prod-conv"
                key = side.session_key(conv, "resp")
                home = fleet.replica_for(conv)
                h1 = await home.scheduler.submit("t1", list(range(1, 14)), side.greedy(10),
                                                 conversation_id=key)
                _toks, err = await _drain(h1)
                assert err is None
                assert home.scheduler.session_cache.get(key) is not None
                m0 = side.metrics.get("finchat_fleet_session_migrations_total")
                home.state = side.fleet.OUT
                rep2 = fleet.replica_for(conv)
                return (rep2 is not home,
                        side.metrics.get("finchat_fleet_session_migrations_total") - m0,
                        home.scheduler.session_cache.get(key) is None,
                        rep2.scheduler.session_cache.get(key) is not None)
            finally:
                await fleet.stop()
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == (True, 1, True, True)


def test_session_import_relinks_shared_head_or_refuses(models):
    def scenario(side):
        async def run():
            fleet = side.make_fleet(2)
            await fleet.start()
            try:
                a, b = fleet.replicas
                head = list(range(1, 12))
                assert a.scheduler.register_prefix(head) >= 8
                payload = {"conversation_id": "hc", "token_ids": np.asarray(head[:8], np.int32),
                           "prefix_len": 8, "snap": None}
                r0 = side.metrics.get("finchat_fleet_session_import_refused_total")
                seen = [b.scheduler.import_session_entry(dict(payload)),
                        side.metrics.get("finchat_fleet_session_import_refused_total") - r0,
                        b.scheduler.session_cache.get("hc") is None]
                entry_a = a.scheduler._prefixes[0]
                refs0 = entry_a.refs
                seen.append(a.scheduler.import_session_entry(dict(payload)))
                got = a.scheduler.session_cache.get("hc")
                seen += [got is not None and got.prefix_entry is entry_a,
                         entry_a.refs - refs0]
                a.scheduler.session_cache.discard("hc")
                seen.append(entry_a.refs - refs0)
                return seen
            finally:
                await fleet.stop()
        return run()

    out = {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}
    assert out["port"] == out["jax"] == [False, 1, True, True, True, 1, 0]


# --- the app ----------------------------------------------------------------------

def test_drain_stops_fleet_supervisor_before_scheduler_drain():
    """The graceful drain takes the supervisor down before the replicas'
    shutdown drains (a respawn's rebuild racing ``shutdown_drain`` on the
    same engine could leave slots or pages behind), as the JAX app does."""
    from finchat_tpu.io.kafka import InMemoryBroker as JaxBroker
    from finchat_tpu.io.kafka import KafkaClient as JaxKafka
    from finchat_tpu.io.store import InMemoryStore as JaxStore
    from finchat_tpu.utils.config import load_config as jax_load_config
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.utils.config import load_config

    def order_of(app) -> list:
        order = []

        class FakeSched:
            async def shutdown_drain(self):
                order.append("shutdown_drain")

        class FakeFleet:
            replicas = [types.SimpleNamespace(scheduler=FakeSched())]

            async def stop_supervisor(self):
                order.append("stop_supervisor")

            async def stop(self):
                order.append("fleet_stop")

        async def run():
            await app.start(serve_http=False)
            app.fleet = FakeFleet()
            await app.drain_and_stop()

        asyncio.run(run())
        return order

    async def fake_retriever(**_kw):
        return []

    cfg = load_config(overrides={"model.preset": "stub"})
    port = tapp.build_app(cfg, store=InMemoryStore(),
                          kafka=KafkaClient(cfg.kafka, broker=InMemoryBroker()),
                          retriever=fake_retriever, device="cpu")
    jcfg = jax_load_config(overrides={"model.preset": "stub"})
    jax_app = japp.build_app(jcfg, store=JaxStore(),
                             kafka=JaxKafka(jcfg.kafka, broker=JaxBroker()),
                             retriever=fake_retriever)
    assert order_of(port) == order_of(jax_app) == ["stop_supervisor", "shutdown_drain",
                                                   "fleet_stop"]


# --- build_app's fleet -------------------------------------------------------------

# a small engine (no warmup, no shared heads: the byte tokenizer's rendered
# heads are thousands of tokens) and an all-1 mesh for the JAX app
FLEET_APP = {"fleet.replicas": 3, "fleet.roles": "prefill,decode,decode",
             "engine.max_seqs": 2, "engine.page_size": 16, "engine.num_pages": 32,
             "engine.max_seq_len": 256, "engine.prefill_chunk": 32,
             "engine.warmup_on_start": False, "engine.prefix_cache": False,
             "mesh.model": 1}


def _leaves(tree, prefix=""):
    """(name, tensor) of every parameter tensor, a quantized leaf's values
    and scales included."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    else:
        for f in ("q", "scale"):
            yield f"{prefix}{f}", getattr(tree, f)


@pytest.mark.parametrize("quant", ["", "int8"], ids=["bf16", "int8"])
def test_build_app_fleet_shares_one_parameter_tree(quant):
    """``build_app`` with three replicas of ``mini`` (bf16, and int8
    quantized as the tree is made): one parameter tree under every engine
    (``data_ptr`` equal leaf by leaf), a pool each, the roles parsed as the
    JAX app parses them, the disagg coordinator on the serving pool only,
    and every conversation routed to the replica the JAX app's fleet picks."""
    from finchat_tpu.io.kafka import InMemoryBroker as JaxBroker
    from finchat_tpu.io.kafka import KafkaClient as JaxKafka
    from finchat_tpu.io.store import InMemoryStore as JaxStore
    from finchat_tpu.utils.config import load_config as jax_load_config
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.utils.config import load_config

    async def no_rows(**_kw):
        return []

    overrides = {"model.preset": "mini", "model.quant": quant, **FLEET_APP}
    cfg = load_config(overrides=overrides)
    app = tapp.build_app(cfg, store=InMemoryStore(),
                         kafka=KafkaClient(cfg.kafka, broker=InMemoryBroker()),
                         retriever=no_rows, device="cpu")
    fleet = app.fleet
    assert isinstance(fleet, tfleet.EngineFleet) and len(fleet.replicas) == 3
    engines = [rep.scheduler.engine for rep in fleet.replicas]
    ref = dict(_leaves(engines[0].params))
    assert (type(engines[0].params["layers"]["attn_q"]).__name__ == "QTensor") == (quant == "int8")
    for eng in engines[1:]:
        leaves = dict(_leaves(eng.params))
        assert leaves.keys() == ref.keys()
        assert all(leaves[k].data_ptr() == ref[k].data_ptr() for k in ref)
        assert eng.state.k_pages.data_ptr() != engines[0].state.k_pages.data_ptr()
    assert app.scheduler is fleet.replicas[0].scheduler and app.agent is fleet.replicas[0].agent
    assert len({id(rep.agent) for rep in fleet.replicas}) == 3
    assert [rep.scheduler.replica_id for rep in fleet.replicas] == ["0", "1", "2"]

    jcfg = jax_load_config(overrides=overrides)
    jax_app = japp.build_app(jcfg, store=JaxStore(),
                             kafka=JaxKafka(jcfg.kafka, broker=JaxBroker()), retriever=no_rows)
    assert [r.role for r in fleet.replicas] == [r.role for r in jax_app.fleet.replicas] == [
        "prefill", "decode", "decode"]
    assert fleet.replicas[0].scheduler.disagg is None
    assert all(r.scheduler.disagg is fleet.disagg for r in fleet.replicas[1:])
    assert fleet.num_partitions == jax_app.fleet.num_partitions
    for i in range(64):
        conv = f"conv-{i}"
        agent = app._agent_for(conv)
        want = jax_app.fleet.replica_for(conv).replica_id
        assert agent is fleet._by_id[want].agent


# --- the session disk tier a replica ----------------------------------------

def test_replicas_keep_their_session_records_apart(models, tmp_path):
    """Two replicas over one ``session_cache_disk_path``, no fabric: each
    keeps its records in its own ``replica-<id>`` subdirectory, as the JAX
    scheduler does. A conversation retired on replica 0 is on disk under
    ``replica-0`` only, replica 1's RAM miss does not restore it (it starts
    cold), and ``finchat_durability_disk_restores_total`` moves on neither
    replica: the layout, the resumed lengths and the counters are equal
    across packages."""
    prompt = list(range(1, 30))

    async def scenario(side, name):
        root = tmp_path / name
        reps = [side.replica(f"d{i}", session_cache_disk_path=str(root)) for i in range(2)]
        name_ = "finchat_durability_disk_restores_total"
        before = [side.metrics.get(name_, {"replica": r.replica_id}) for r in reps]
        a, b = reps[0].scheduler, reps[1].scheduler
        await a.start()
        try:
            h = await a.submit("t1", prompt, side.greedy(6), conversation_id="conv-d")
            t1, err = await _drain(h)
            assert err is None
        finally:
            await a.stop()
        a.session_cache.disk.flush()
        layout = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        await b.start()
        try:
            assert b.session_cache.get("conv-d") is None
            h2 = await b.submit("t2", prompt + t1 + [3, 4], side.greedy(4),
                                conversation_id="conv-d")
            _t2, err = await _drain(h2)
            assert err is None
        finally:
            await b.stop()
        for r in reps:
            r.scheduler.session_cache.disk.close()
        restores = [side.metrics.get(name_, {"replica": r.replica_id}) - v
                    for r, v in zip(reps, before)]
        return dict(layout=layout, resumed=h2.resumed_len, restores=restores, t1=t1)

    out = {name: asyncio.run(scenario(side, name)) for name, side in _sides(models).items()}
    assert out["port"]["layout"] == out["jax"]["layout"]
    assert any(p.startswith("replica-d0/") and p.endswith(".skv")
               for p in out["port"]["layout"])
    assert not any(p.startswith("replica-d1/") and p.endswith(".skv")
                   for p in out["port"]["layout"])
    assert out["port"]["resumed"] == out["jax"]["resumed"] == 0
    assert out["port"]["restores"] == out["jax"]["restores"] == [0.0, 0.0]
    _assert_teacher_forced(models, prompt, out["port"]["t1"], out["jax"]["t1"])
