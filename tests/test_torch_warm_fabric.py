"""The port's warm-state fabric (engine/warm_fabric.py) against the JAX
package's, on CPU at fp32.

``WarmFabric`` on its own: the holder index (a replica-less note is
dropped, ``forget`` is holder-guarded), the heads' RAM LRU, a disk head
whose token ids differ from the asked ones is ignored, ``head_key`` equal
across packages on seeded heads, and one fabric directory serving both
packages (a head published by either is loaded by the other, bytes equal).

The four fabric cases of the JAX package's tests/test_disagg.py run on both
packages over the same converted ``tiny`` fp32 weights: a conversation
retired on one replica resumes warm on a replica that never saw it; the
shared head is prefilled once a fleet (a second replica's registration is a
fabric hit that runs no prefill, and serves the same stream); an int8-KV
head snapshot is refused by an fp32 replica, counted; and route-time
migration asks the holder index and keeps the shared record. Held across
packages: the counter deltas, the resumed lengths, and the greedy streams
under the teacher-forced contract; within each package the restored run
equals the prefilled one exactly.

Besides: ``build_app`` builds one fabric for ``fabric.enabled`` with a
path (shared by every replica, none for the stub preset), and an empty path
leaves it off, as the JAX package's ``make_warm_fabric`` does.
"""

import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401  (the leak audit)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine import warm_fabric as jwf  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.serve import fleet as jfleet  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.config import FleetConfig as JaxFleetConfig  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu_torch.engine import warm_fabric as twf  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.serve import fleet as tfleet  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig, FleetConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
# tests/test_disagg.py's replica
ENGINE = dict(max_seqs=3, page_size=8, num_pages=64, max_seq_len=256, prefill_chunk=16,
              session_cache=True, session_cache_bytes=16 << 20, breaker_max_rebuilds=1)


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

    def port_sched(rid, fabric=None, **over):
        eng = InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **over}), device="cpu")
        return ContinuousBatchingScheduler(eng, eos_id=-1, metrics=METRICS.labeled(replica=rid),
                                           replica_id=rid, fabric=fabric)

    def jax_sched(rid, fabric=None, **over):
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **over}), attn_backend="ref")
        return JaxScheduler(eng, eos_id=-1, metrics=JAX_METRICS.labeled(replica=rid),
                            replica_id=rid, fabric=fabric)

    def ns(wf, sched, fleet_mod, fleet_cfg, metrics, sampling):
        return SimpleNamespace(
            wf=wf, sched=sched, fleet=fleet_mod, fleet_cfg=fleet_cfg, metrics=metrics,
            get=lambda name, rid, **labels: metrics.get(name, {"replica": rid, **labels}),
            greedy=lambda n: sampling(temperature=0.0, max_new_tokens=n))

    return {"port": ns(twf, port_sched, tfleet, FleetConfig, METRICS, SamplingParams),
            "jax": ns(jwf, jax_sched, jfleet, JaxFleetConfig, JAX_METRICS, JaxSampling)}


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


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _snap(side_name: str, rng, n_pages: int = 2):
    """A small fp32 head snapshot in the package's own array type."""
    k = rng.standard_normal((2, n_pages, 8, 16), dtype=np.float32)
    v = rng.standard_normal((2, n_pages, 8, 16), dtype=np.float32)
    if side_name == "port":
        return (torch.from_numpy(k), torch.from_numpy(v), None, None)
    return (k, v, None, None)


# --- WarmFabric on its own -------------------------------------------------

def test_head_key_equal_across_packages():
    rng = np.random.default_rng(5)
    for _ in range(200):
        ids = [int(x) for x in rng.integers(0, 130_000, size=int(rng.integers(1, 400)))]
        assert twf.head_key(ids) == jwf.head_key(ids)
        assert twf.head_key(ids).startswith("__fabric_head__")
    assert twf.head_key([1, 2, 3]) != twf.head_key([1, 2, 4])


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_holder_index_is_guarded(side_name, tmp_path):
    wf = {"port": twf, "jax": jwf}[side_name]
    fabric = wf.WarmFabric(str(tmp_path), 1 << 20)
    try:
        fabric.note("c", None, 10)  # a cache with no replica id notes nothing
        assert fabric.holder("c") is None
        fabric.note("c", "0", 10)
        fabric.note("c", "1", 24)  # the last writer wins
        assert fabric.holder("c") == ("1", 24)
        fabric.forget("c", "0")  # not the holder: the target's claim stays
        assert fabric.holder("c") == ("1", 24)
        fabric.forget("c", "1")
        assert fabric.holder("c") is None
        fabric.forget("c", "1")  # already gone: no error
    finally:
        fabric.close()


def test_head_ram_lru_equal_across_packages(tmp_path):
    """33 heads stored: the oldest leaves RAM (the cap is 32), a load moves
    a head to the recent end; the RAM order is equal across packages, and
    the head that left RAM still loads from its record."""
    out = {}
    for name, wf in (("port", twf), ("jax", jwf)):
        rng = np.random.default_rng(1)
        fabric = wf.WarmFabric(str(tmp_path / name), 64 << 20)
        try:
            heads = [[i + 1] * 8 for i in range(wf._HEAD_RAM_CAP + 1)]
            for ids in heads:
                fabric.store_head(ids, _snap(name, rng))
            assert wf.head_key(heads[0]) not in fabric._heads
            assert fabric.load_head(heads[1]) is not None  # now the most recent
            fabric.flush()
            back = fabric.load_head(heads[0])  # from its disk record
            assert back is not None and _np(back[0]).shape == (2, 2, 8, 16)
            out[name] = list(fabric._heads)
        finally:
            fabric.close()
    assert out["port"] == out["jax"]
    assert len(out["port"]) == twf._HEAD_RAM_CAP


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_disk_head_with_other_ids_is_ignored(side_name, tmp_path):
    """A record under a head's key whose token ids are not the head's (a hash
    collision, a stale writer) is not trusted: a miss."""
    wf = {"port": twf, "jax": jwf}[side_name]
    ids = list(range(1, 17))
    fabric = wf.WarmFabric(str(tmp_path), 64 << 20)
    try:
        fabric.tier.spill(wf.head_key(ids), np.asarray(list(range(2, 18)), np.int32), 0,
                          _snap(side_name, np.random.default_rng(2)))
        fabric.flush()
        assert wf.head_key(ids) in fabric.tier
        assert fabric.load_head(ids) is None
        assert fabric.holder(wf.head_key(ids)) is None
    finally:
        fabric.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_one_fabric_directory_serves_both_packages(writer, tmp_path):
    """A head published by one package's fabric loads, byte for byte, from a
    fresh fabric of the other package over the same directory."""
    reader = "jax" if writer == "port" else "port"
    mods = {"port": twf, "jax": jwf}
    ids = list(range(3, 27))
    snap = _snap(writer, np.random.default_rng(3))
    w = mods[writer].WarmFabric(str(tmp_path), 64 << 20)
    w.store_head(ids, snap)
    w.close()
    r = mods[reader].WarmFabric(str(tmp_path), 64 << 20)
    try:
        got = r.load_head(ids)
        assert got is not None
        for a, b in zip(got, snap):
            assert (a is None) == (b is None)
            if a is not None:
                assert _np(a).tobytes() == _np(b).tobytes() and _np(a).shape == _np(b).shape
    finally:
        r.close()


# --- the four fabric cases of tests/test_disagg.py ---------------------------

def test_fabric_session_restore_on_never_seen_replica(models, tmp_path):
    """A conversation retired on one replica resumes warm on another that
    never saw it, through the shared tier: a fabric hit on the restoring
    replica, ``resumed_len > 0``, and the stream equal to the same turn run
    where the conversation lived."""
    prompt1 = list(range(1, 41))

    async def turn(sched, seq, prompt, conv, side):
        await sched.start()
        try:
            h = await sched.submit(seq, prompt, side.greedy(8), conversation_id=conv)
            toks, err = await _drain(h)
            assert err is None
            return toks, h.resumed_len
        finally:
            await sched.stop()

    def scenario(side, dirname, rids):
        fabric = side.wf.WarmFabric(str(tmp_path / dirname), 32 << 20)
        try:
            a = side.sched(rids[0], fabric)
            t1, _ = asyncio.run(turn(a, "t1", prompt1, "conv-f", side))
            fabric.flush()
            b = a if rids[1] == rids[0] else side.sched(rids[1], fabric)
            if b is not a:
                assert b.session_cache.get("conv-f") is None
            prompt2 = prompt1 + t1 + [9, 10, 11]
            hits0 = side.get("finchat_fabric_hits_total", rids[1])
            misses0 = side.get("finchat_fabric_misses_total", rids[1])
            t2, resumed = asyncio.run(turn(b, "t2", prompt2, "conv-f", side))
            return {"t1": t1, "t2": t2, "resumed": resumed,
                    "hits": side.get("finchat_fabric_hits_total", rids[1]) - hits0,
                    "misses": side.get("finchat_fabric_misses_total", rids[1]) - misses0}
        finally:
            fabric.close()

    out = {}
    for name, side in _sides(models).items():
        stay = scenario(side, f"{name}-stay", ("fa", "fa"))
        moved = scenario(side, f"{name}-move", ("fb", "fc"))
        assert moved["t2"] == stay["t2"]
        assert moved["resumed"] > 0 and moved["resumed"] == stay["resumed"]
        assert moved["hits"] == 1 and moved["misses"] == 0
        out[name] = moved
    assert out["port"]["resumed"] == out["jax"]["resumed"]
    assert out["port"]["hits"] == out["jax"]["hits"]
    _assert_teacher_forced(models, list(range(1, 41)), out["port"]["t1"], out["jax"]["t1"])
    if out["port"]["t1"] == out["jax"]["t1"]:
        prompt2 = list(range(1, 41)) + out["jax"]["t1"] + [9, 10, 11]
        _assert_teacher_forced(models, prompt2, out["port"]["t2"], out["jax"]["t2"])


def test_fabric_head_prefills_once_per_fleet(models, tmp_path):
    """The first replica to register a head prefills it and publishes it;
    a later replica restores the snapshot with one scatter, its prefill never
    called, and serves the same stream."""
    head = list(range(1, 49))  # 6 whole pages
    prompt = head + list(range(60, 72))

    async def gen(sched, seq, side):
        await sched.start()
        try:
            h = await sched.submit(seq, prompt, side.greedy(8))
            toks, err = await _drain(h)
            assert err is None
            return toks
        finally:
            await sched.stop()

    out = {}
    for name, side in _sides(models).items():
        fabric = side.wf.WarmFabric(str(tmp_path / name), 32 << 20)
        try:
            a = side.sched("ha", fabric)
            m0 = side.get("finchat_fabric_misses_total", "ha")
            assert a.register_prefix(head) == 48  # cold: local prefill, published
            misses = side.get("finchat_fabric_misses_total", "ha") - m0
            fabric.flush()
            b = side.sched("hb", fabric)
            real_prefill = b.engine.prefill
            calls = []
            b.engine.prefill = lambda *a_, _r=real_prefill, **k: (calls.append(1), _r(*a_, **k))[1]
            h0 = side.get("finchat_fabric_hits_total", "hb")
            n0 = side.metrics.snapshot().get('finchat_fabric_restore_seconds{replica="hb"}_count', 0)
            assert b.register_prefix(head) == 48  # a fabric hit: no prefill
            assert calls == []
            hits = side.get("finchat_fabric_hits_total", "hb") - h0
            restores = side.metrics.snapshot().get(
                'finchat_fabric_restore_seconds{replica="hb"}_count', 0) - n0
            ta = asyncio.run(gen(a, "ga", side))
            tb = asyncio.run(gen(b, "gb", side))
            assert ta == tb  # the restored head's KV is the prefilled head's
            out[name] = dict(misses=misses, hits=hits, restores=restores, ta=ta)
        finally:
            fabric.close()
    assert {k: v for k, v in out["port"].items() if k != "ta"} == {
        k: v for k, v in out["jax"].items() if k != "ta"} == dict(misses=1, hits=1, restores=1)
    _assert_teacher_forced(models, prompt, out["port"]["ta"], out["jax"]["ta"])


def test_fabric_crossmode_head_refused(models, tmp_path):
    """A head published by an int8-KV engine is refused by an fp32 replica,
    counted; the replica registers the head by its own prefill."""
    head = list(range(1, 25))
    out = {}
    for name, side in _sides(models).items():
        fabric = side.wf.WarmFabric(str(tmp_path / name), 32 << 20, kv_quant="int8")
        try:
            a = side.sched("xa", fabric, kv_quant="int8")
            assert a.register_prefix(head) == 24
            fabric.flush()
            b = side.sched("xb", fabric)
            r0 = side.get("finchat_fabric_import_refused_total", "xb")
            h0 = side.get("finchat_fabric_hits_total", "xb")
            assert b.register_prefix(head) == 24  # still registers, locally
            out[name] = (side.get("finchat_fabric_import_refused_total", "xb") - r0,
                         side.get("finchat_fabric_hits_total", "xb") - h0)
        finally:
            fabric.close()
    assert out["port"] == out["jax"] == (1, 0)


def test_fabric_migration_is_index_lookup_and_keeps_shared_record(models, tmp_path):
    """Route-time deeper-entry-wins over the fabric: the router asks the
    holder index, moves the RAM entry, and drops only the source's RAM copy,
    so the record both replicas share survives the migration; the next turn
    resumes on the target."""
    prompt = list(range(1, 41))

    async def scenario(side, name):
        fabric = side.wf.WarmFabric(str(tmp_path / name), 32 << 20)
        reps = [side.fleet.EngineReplica(replica_id=rid, scheduler=side.sched(rid, fabric))
                for rid in ("0", "1")]
        fleet = side.fleet.EngineFleet(reps, side.fleet_cfg(replicas=2, respawn=False),
                                       num_partitions=16)
        # a scan of the siblings would read their caches: the lookup does not
        scans = []
        for r in reps:
            real_get = r.scheduler.session_cache.get

            def get(key, _g=real_get, _rid=r.replica_id):
                scans.append(_rid)
                return _g(key)

            r.scheduler.session_cache.get = get
        await fleet.start()
        try:
            conv = "conv-m"
            home = fleet.replica_for(conv)
            other = next(r for r in reps if r is not home)
            h = await home.scheduler.submit("t1", prompt, side.greedy(8), conversation_id=conv)
            t1, err = await _drain(h)
            assert err is None
            assert fabric.holder(conv)[0] == home.replica_id
            m0 = side.metrics.get("finchat_fleet_session_migrations_total")
            home.state = side.fleet.OUT
            scans.clear()
            rep2 = fleet.replica_for(conv)
            assert rep2 is other
            migrated = side.metrics.get("finchat_fleet_session_migrations_total") - m0
            read = sorted(set(scans))
            assert home.scheduler.session_cache.get(conv) is None
            assert rep2.scheduler.session_cache.get(conv) is not None
            assert fabric.holder(conv)[0] == rep2.replica_id
            fabric.flush()
            assert conv in fabric.tier  # the shared record survived
            h2 = await rep2.scheduler.submit("t2", prompt + t1 + [3, 4], side.greedy(4),
                                             conversation_id=conv)
            t2, err = await _drain(h2)
            assert err is None
            return dict(migrated=migrated, resumed=h2.resumed_len, t1=t1, t2=t2,
                        holder=fabric.holder(conv), read=read)
        finally:
            await fleet.stop()
            fabric.close()

    out = {name: asyncio.run(scenario(side, name)) for name, side in _sides(models).items()}
    for k in ("migrated", "resumed", "holder", "read"):
        assert out["port"][k] == out["jax"][k], k
    assert out["port"]["migrated"] == 1 and out["port"]["resumed"] > 0
    _assert_teacher_forced(models, prompt, out["port"]["t1"], out["jax"]["t1"])


# --- build_app ---------------------------------------------------------------

def test_build_app_builds_one_fabric_for_every_replica(tmp_path):
    """``fabric.enabled`` with a path: one ``WarmFabric`` whose tier is every
    replica's session tier (labeled ``replica="fabric"``); an empty path, or
    the stub preset, builds none, as the JAX package's ``make_warm_fabric``."""
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.serve import app as tapp
    from finchat_tpu_torch.utils.config import load_config

    class NoRows:
        async def search(self, *a, **k):
            return []

    def build(**over):
        cfg = load_config(overrides={"model.preset": "tiny", "engine.max_seqs": 2,
                                     "engine.num_pages": 32, "engine.max_seq_len": 128,
                                     "engine.prefill_chunk": 16, "engine.prefix_cache": False,
                                     **over})
        return tapp.build_app(cfg, store=InMemoryStore(),
                              kafka=KafkaClient(cfg.kafka, broker=InMemoryBroker()),
                              retriever=NoRows(), device="cpu")

    app = build(**{"fleet.replicas": 2, "fabric.enabled": True, "fabric.path": str(tmp_path)})
    scheds = [rep.scheduler for rep in app.fleet.replicas]
    fabric = scheds[0].fabric
    assert isinstance(fabric, twf.WarmFabric)
    assert all(s.fabric is fabric and s.session_cache.disk is fabric.tier for s in scheds)
    assert [s.session_cache.fabric_replica for s in scheds] == ["0", "1"]
    fabric.close()
    one = build(**{"fabric.enabled": True, "fabric.path": str(tmp_path / "one")})
    assert isinstance(one.scheduler.fabric, twf.WarmFabric)
    one.scheduler.fabric.close()
    assert build(**{"fabric.enabled": True}).scheduler.fabric is None
    stub = build(**{"model.preset": "stub", "fabric.enabled": True, "fabric.path": str(tmp_path)})
    assert stub.scheduler is None
