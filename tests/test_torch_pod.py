"""The port's pod plane (serve/pod.py) against the JAX package's, on CPU
at fp32.

The cases of the JAX package's tests/test_pod.py run on both packages: the
per-partition journal cases that tests/test_torch_journal.py lacks (the
inherited-partition replay, the seq merge's recency, seqs across a restart,
appends after a legacy migration, the fsync and its relief valve, a torn
line in one partition file); the FPOD frame codec and its corruption
checks; the peer table's validation; the inproc and TCP liaisons; the
per-peer breaker; the heartbeat fault site with a peer's death and rejoin;
a host's death with the partition adoption and the exact replay of the
inherited journals into the dedupe ring; the session record crossing hosts
under {fp32, int8 KV} x {bounded, unbounded}; a record of the other KV mode
refused and counted; the pull end to end with its miss, corrupt and
unreachable cold starts; a peer-less coordinator changing nothing; and the
app building no coordinator with the plane off and one, attached to every
scheduler, with ``pod.host_id`` set.

Held across packages: FPOD frames byte for byte in both directions, the
counter deltas, the adoption's partitions and replayed ids, the resumed
lengths, and the greedy streams under the teacher-forced contract (within
each package a pulled turn equals the uninterrupted one exactly). A record
served over TCP by a JAX ``PodCoordinator`` is pulled and resumed by the
port's scheduler, with the JAX continuation's stream.
"""

import asyncio
import dataclasses
import json
import socket
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401  (the leak audit)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import finchat_tpu.io.journal as jjournal  # noqa: E402
import finchat_tpu.io.kafka as jkafka  # noqa: E402
import finchat_tpu.utils.config as jconfig  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.engine.session_cache import SessionDiskTier as JaxTier  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.serve import fleet as jfleet  # noqa: E402
from finchat_tpu.serve import pod as jpod  # noqa: E402
from finchat_tpu.utils import faults as jfaults  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
import finchat_tpu_torch.io.journal as tjournal  # noqa: E402
import finchat_tpu_torch.io.kafka as tkafka  # noqa: E402
import finchat_tpu_torch.utils.config as tconfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.engine.session_cache import SessionDiskTier  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.serve import fleet as tfleet  # noqa: E402
from finchat_tpu_torch.serve import pod as tpod  # noqa: E402
from finchat_tpu_torch.utils import faults as tfaults  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
POD_COUNTERS = ("finchat_pod_heartbeats_total", "finchat_pod_heartbeat_failures_total",
                "finchat_pod_peer_deaths_total", "finchat_pod_peer_rejoins_total",
                "finchat_pod_partition_adoptions_total", "finchat_pod_adopted_ids_replayed_total",
                "finchat_pod_session_pulls_total", "finchat_pod_pull_misses_total",
                "finchat_pod_breaker_trips_total")

SIDES = {
    "port": SimpleNamespace(pod=tpod, journal=tjournal, kafka=tkafka, config=tconfig,
                            fleet=tfleet, faults=tfaults, metrics=METRICS, tier=SessionDiskTier,
                            sampling=SamplingParams),
    "jax": SimpleNamespace(pod=jpod, journal=jjournal, kafka=jkafka, config=jconfig,
                           fleet=jfleet, faults=jfaults, metrics=JAX_METRICS, tier=JaxTier,
                           sampling=JaxSampling),
}


@pytest.fixture(autouse=True)
def _clean_pod_state():
    yield
    for side in SIDES.values():
        side.faults.disarm_all()
        side.pod._INPROC.clear()


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


def _make_scheduler(models, side_name, replica_id="0", kv_quant="", bounded=False):
    """tests/test_pod.py's scheduler."""
    jcfg, jparams, tcfg, tparams = models
    side = SIDES[side_name]
    cfg = side.config.EngineConfig(
        max_seqs=3, page_size=8, num_pages=96, max_seq_len=256, prefill_chunk=16,
        session_cache=True, kv_quant=kv_quant, kv_sink_pages=1 if bounded else 0,
        kv_window_pages=4 if bounded else 0)
    if side_name == "port":
        return ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, cfg, device="cpu"),
                                           eos_id=-1, replica_id=replica_id)
    return JaxScheduler(JaxEngine(jcfg, jparams, cfg, attn_backend="ref"), eos_id=-1,
                        replica_id=replica_id)


async def _collect(side, scheduler, seq_id, prompt_ids, n_new, conversation_id=None):
    handle = await scheduler.submit(seq_id, list(prompt_ids),
                                    side.sampling(temperature=0.0, max_new_tokens=n_new),
                                    conversation_id=conversation_id)
    tokens = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=120)
        if event["type"] == "token":
            tokens.append(event["token_id"])
        elif event["type"] == "done":
            return handle, tokens
        else:
            return handle, event


def _pod_record(side, sched, key):
    """A session entry as pod-transfer bytes (the tier's serialized record)."""
    payload = sched.export_session(key)
    assert payload is not None
    return side.tier._serialize(key, payload["token_ids"], payload["prefix_len"],
                                payload["snap"], payload["kv_gap"], payload["kv_sink"])


def _import_record(side, sched, raw):
    rec = side.tier._deserialize(raw)
    rec = sched.session_cache.fit_payload(rec)
    return rec is not None and sched.import_session_entry(rec)


def _pod_cfg(side, host, listen="", peers="", **kw):
    defaults = dict(heartbeat_interval_seconds=60.0, heartbeat_miss_threshold=2,
                    transfer_timeout_seconds=1.0, transfer_retries=1, retry_backoff_seconds=0.0,
                    breaker_threshold=3, breaker_cooldown_seconds=0.05)
    defaults.update(kw)
    return side.config.PodConfig(host_id=host, listen=listen, peers=peers, **defaults)


def _counters(side) -> dict:
    return {name: side.metrics.get(name) for name in POD_COUNTERS}


def _delta(side, before: dict) -> dict:
    return {name: side.metrics.get(name) - v for name, v in before.items()}


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


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- the per-partition journal: the cases tests/test_torch_journal.py lacks ---

@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_journal_per_partition_layout_and_inherited_replay(side_name, tmp_path):
    side = SIDES[side_name]
    J = side.journal.AnsweredJournal
    j = J(str(tmp_path), num_partitions=4)
    j.append("a0", partition=0)
    j.append("b0", partition=2)
    j.append("a1", partition=0)
    j.close()
    assert (tmp_path / side.journal.partition_filename(0)).exists()
    assert (tmp_path / side.journal.partition_filename(2)).exists()
    assert not (tmp_path / side.journal.partition_filename(1)).exists()
    assert side.journal.partition_filename(3) == jjournal.partition_filename(3)
    assert J(str(tmp_path)).partitions_on_disk() == [0, 2]
    assert J(str(tmp_path)).replay(partitions=[2], compact=False) == ["b0"]
    assert J(str(tmp_path)).replay(partitions=[0], compact=False) == ["a0", "a1"]
    assert J(str(tmp_path)).replay() == ["a0", "b0", "a1"]


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_journal_seq_merge_keeps_global_recency(side_name, tmp_path):
    J = SIDES[side_name].journal.AnsweredJournal
    j = J(str(tmp_path), num_partitions=4, keep=3)
    for mid, part in (("b0", 1), ("b1", 1), ("a0", 0), ("a1", 0), ("a2", 0)):
        j.append(mid, partition=part)
    j.close()
    assert J(str(tmp_path), keep=3).replay() == ["a0", "a1", "a2"]


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_journal_seq_survives_restart_and_adoption_order(side_name, tmp_path):
    J = SIDES[side_name].journal.AnsweredJournal
    j1 = J(str(tmp_path), num_partitions=2)
    j1.append("old", partition=0)
    j1.close()
    j2 = J(str(tmp_path), num_partitions=2)
    j2.replay()  # seeds the seq counter past everything on disk
    j2.append("new", partition=1)
    j2.close()
    assert J(str(tmp_path)).replay() == ["old", "new"]


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_journal_migration_appends_land_in_partition_files(side_name, tmp_path):
    J = SIDES[side_name].journal.AnsweredJournal
    body = json.dumps("m-old").encode()
    (tmp_path / J.FILENAME).write_bytes(b"v1 %08x " % zlib.crc32(body) + body + b"\n")
    j = J(str(tmp_path), num_partitions=4)
    j.append("m-new", partition=1)
    j.close()
    assert J(str(tmp_path)).replay() == ["m-old", "m-new"]


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_journal_fsync_before_return_and_relief_valve(side_name, tmp_path, monkeypatch):
    mod = SIDES[side_name].journal
    real_fsync = mod.os.fsync
    calls = []

    def spy(fd):
        calls.append(fd)
        real_fsync(fd)

    monkeypatch.setattr(mod.os, "fsync", spy)
    j = mod.AnsweredJournal(str(tmp_path), fsync=True, num_partitions=4)
    assert j.append("m1", partition=3) is True
    assert len(calls) == 1
    assert mod.AnsweredJournal(str(tmp_path)).replay(partitions=[3], compact=False) == ["m1"]
    calls.clear()
    j2 = mod.AnsweredJournal(str(tmp_path), fsync=False, num_partitions=4)
    assert j2.append("m2", partition=3) is True
    assert calls == []
    j.close()
    j2.close()


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_journal_torn_line_per_partition(side_name, tmp_path):
    side = SIDES[side_name]
    J = side.journal.AnsweredJournal
    j = J(str(tmp_path), num_partitions=4)
    j.append("p0-a", partition=0)
    j.append("p1-a", partition=1)
    j.append("p0-b", partition=0)
    j.close()
    with open(tmp_path / side.journal.partition_filename(0), "ab") as f:
        f.write(b"v2 dead")  # a crash mid-append
    q0 = side.metrics.get("finchat_durability_quarantines_total")
    assert J(str(tmp_path)).replay() == ["p0-a", "p1-a", "p0-b"]
    assert side.metrics.get("finchat_durability_quarantines_total") == q0 + 1


# --- the frame codec and the transports ---------------------------------------

FRAMES = [("ping", {"host_id": "hostB"}, b""),
          ("pull_session", {"key": "c#resp"}, b"payload-bytes"),
          ("record", {"key": "ü-✓ \"q\""}, bytes(range(256)) * 9),
          ("pong", {"host_id": "hostA", "member_id": None}, b""),
          ("error", {}, b"\x00")]


@pytest.mark.parametrize("op,meta,payload", FRAMES)
def test_frames_equal_across_packages_both_ways(op, meta, payload):
    raw = tpod.encode_frame(op, meta, payload)
    assert raw == jpod.encode_frame(op, meta, payload)
    assert tpod.decode_frame(jpod.encode_frame(op, meta, payload)) == (op, meta, payload)
    assert jpod.decode_frame(raw) == (op, meta, payload)


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_frame_codec_roundtrip_and_corruption_detection(side_name):
    pod = SIDES[side_name].pod
    raw = pod.encode_frame("pull_session", {"key": "c#resp"}, b"payload-bytes")
    op, meta, payload = pod.decode_frame(raw)
    assert (op, meta["key"], payload) == ("pull_session", "c#resp", b"payload-bytes")
    flipped = bytearray(raw)
    flipped[-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        pod.decode_frame(bytes(flipped))
    with pytest.raises(ValueError, match="truncated"):
        pod.decode_frame(raw[:-3])
    with pytest.raises(ValueError, match="magic"):
        pod.decode_frame(b"XPOD" + raw[4:])
    with pytest.raises(ValueError, match="version"):
        pod.decode_frame(raw[:4] + bytes([99]) + raw[5:])


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_parse_peers_validates_loudly(side_name):
    pod = SIDES[side_name].pod
    assert pod.parse_peers("b=tcp:127.0.0.1:9710, c=inproc:hostC") == {
        "b": "tcp:127.0.0.1:9710", "c": "inproc:hostC"}
    assert pod.parse_peers("") == {}
    for bad in ("no-address-here", "b=udp:127.0.0.1:1", "=tcp:1:2", "b=inproc:"):
        with pytest.raises(ValueError):
            pod.parse_peers(bad)
    assert pod.COLD_START_REASONS == jpod.COLD_START_REASONS


@pytest.mark.parametrize("side_name", ["port", "jax"])
async def test_inproc_liaison_ping_pull_miss_and_kill(side_name):
    side = SIDES[side_name]
    coord_a = side.pod.PodCoordinator(_pod_cfg(side, "hostA", listen="inproc:hostA"))
    await coord_a.start()
    coord_b = side.pod.PodCoordinator(_pod_cfg(side, "hostB", peers="hostA=inproc:hostA"))
    try:
        peer = coord_b.peers["hostA"]
        op, meta, _ = await coord_b.liaison.call(peer.addr, "ping", {})
        assert op == "pong" and meta["host_id"] == "hostA"
        op, _, _ = await coord_b.liaison.call(peer.addr, "pull_session", {"key": "nope"})
        assert op == "miss"  # no fleet on hostA: an honest miss
        op, meta, _ = await coord_b.liaison.call(peer.addr, "bogus", {})
        assert op == "error" and "bogus" in meta["message"]
        coord_a.kill()
        with pytest.raises(ConnectionError):
            await coord_b.liaison.call(peer.addr, "ping", {})
    finally:
        coord_a.kill()
        await coord_b.stop()


@pytest.mark.parametrize("server,client", [("port", "port"), ("jax", "port"), ("port", "jax")])
async def test_tcp_liaison_roundtrip_and_refused_dial(server, client):
    """Ping over loopback TCP within a package and across packages (each
    host dials the other's liaison), then a refused dial after the kill."""
    srv, cli = SIDES[server], SIDES[client]
    port = _free_port()
    coord_a = srv.pod.PodCoordinator(_pod_cfg(srv, "hostA", listen=f"tcp:127.0.0.1:{port}"))
    await coord_a.start()
    coord_b = cli.pod.PodCoordinator(_pod_cfg(cli, "hostB", peers=f"hostA=tcp:127.0.0.1:{port}"))
    try:
        peer = coord_b.peers["hostA"]
        op, meta, _ = await coord_b.liaison.call(peer.addr, "ping", {}, timeout=2.0)
        assert op == "pong" and meta == {"host_id": "hostA", "member_id": None}
        op, _, _ = await coord_b.liaison.call(peer.addr, "pull_session", {"key": "k"},
                                              timeout=2.0)
        assert op == "miss"
        coord_a.kill()
        with pytest.raises((ConnectionError, OSError, asyncio.TimeoutError)):
            await coord_b.liaison.call(peer.addr, "ping", {}, timeout=0.5)
    finally:
        coord_a.kill()
        await coord_b.stop()


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_breaker_opens_at_threshold_and_half_open_probe(side_name):
    side = SIDES[side_name]
    cfg = _pod_cfg(side, "hostB", breaker_threshold=2, breaker_cooldown_seconds=3600.0)
    peer = side.pod.PeerChannel("hostA", "inproc:hostA", cfg)
    trips0 = side.metrics.get("finchat_pod_breaker_trips_total")
    assert peer.breaker_allows()
    peer.record_failure()
    assert peer.breaker_allows()
    peer.record_failure()
    assert not peer.breaker_allows()
    assert side.metrics.get("finchat_pod_breaker_trips_total") == trips0 + 1
    peer.record_failure()  # further failures do not count the trip again
    assert side.metrics.get("finchat_pod_breaker_trips_total") == trips0 + 1
    peer._open_until = 0.0  # the cooldown elapsed: the half-open probe
    assert peer.breaker_allows()
    peer.record_success()
    assert peer.breaker_allows()


async def test_heartbeat_fault_site_death_and_rejoin():
    """``pod.heartbeat`` is armable; ``heartbeat_miss_threshold`` failures
    declare the peer dead (counted, the live gauge down), and a pong brings it
    back: every counter delta and state equal across packages."""
    out = {}
    for name, side in SIDES.items():
        coord_a = side.pod.PodCoordinator(_pod_cfg(side, "hostA", listen="inproc:hostA"))
        await coord_a.start()
        coord_b = side.pod.PodCoordinator(_pod_cfg(side, "hostB", peers="hostA=inproc:hostA"))
        peer = coord_b.peers["hostA"]
        trail = []
        try:
            c0 = _counters(side)
            await coord_b._heartbeat(peer)
            trail.append((peer.state, peer.misses))
            side.faults.arm("pod.heartbeat", side.faults.n_shot(2, RuntimeError("cable cut")))
            await coord_b._heartbeat(peer)
            trail.append((peer.state, peer.misses))
            await coord_b._heartbeat(peer)
            trail.append((peer.state, peer.misses, side.metrics.get("finchat_pod_hosts_live")))
            await coord_b._heartbeat(peer)
            trail.append((peer.state, side.metrics.get("finchat_pod_hosts_live")))
            out[name] = (trail, _delta(side, c0))
        finally:
            coord_a.kill()
            await coord_b.stop()
    assert out["port"] == out["jax"]
    trail, delta = out["port"]
    assert trail == [("LIVE", 0), ("LIVE", 1), ("DEAD", 2, 1.0), ("LIVE", 2.0)]
    assert delta["finchat_pod_peer_deaths_total"] == 1
    assert delta["finchat_pod_peer_rejoins_total"] == 1
    assert delta["finchat_pod_heartbeat_failures_total"] == 2


async def test_host_death_adoption_replays_inherited_journals_exactly(tmp_path):
    """hostA dies (its liaison killed), hostB's detector declares it dead,
    evicts its member, adopts exactly hostA's partitions and replays exactly
    those journals into its ring: a redelivered answered id is refused there.
    A rejoin under the old member id restores the mapping. Equal across
    packages: the partitions, the ring, the counters."""
    out = {}
    for name, side in SIDES.items():
        d = tmp_path / name
        broker = side.kafka.InMemoryBroker(num_partitions=8)
        kcfg = side.config.KafkaConfig(num_partitions=8)
        ka = side.kafka.KafkaClient(kcfg, broker=broker)
        kb = side.kafka.KafkaClient(kcfg, broker=broker)
        ka._member_id, kb._member_id = "member-hostA", "member-hostB"
        ka.setup_consumer([side.config.USER_MESSAGE_TOPIC])
        kb.setup_consumer([side.config.USER_MESSAGE_TOPIC])
        parts_a = {p for _t, p in ka.assignment()}
        parts_b = {p for _t, p in kb.assignment()}
        assert parts_a and parts_b and parts_a.isdisjoint(parts_b)
        ja = side.journal.AnsweredJournal(str(d), num_partitions=8)
        for p in sorted(parts_a):
            ja.append(f"mid-a{p}", partition=p)
        ja.close()
        coord_a = side.pod.PodCoordinator(_pod_cfg(side, "hostA", listen="inproc:hostA"),
                                          kafka=ka)
        await coord_a.start()
        ring_b = side.fleet.DedupeRing(size=64)
        jb = side.journal.AnsweredJournal(str(d), num_partitions=8)
        coord_b = side.pod.PodCoordinator(_pod_cfg(side, "hostB", peers="hostA=inproc:hostA"),
                                          kafka=kb, journal=jb, dedupe=ring_b)
        await coord_b.start()
        peer = coord_b.peers["hostA"]
        try:
            await coord_b._heartbeat(peer)  # learns hostA's member id
            assert peer.member_id == ka.member_id
            c0 = _counters(side)
            coord_a.kill()
            await coord_b._heartbeat(peer)
            await coord_b._heartbeat(peer)
            assert peer.state == side.pod.PEER_DEAD
            adopted = {p for _t, p in kb.assignment()}
            assert adopted == parts_a | parts_b
            assert coord_b._pull_partitions >= parts_a
            in_ring = sorted(m for m in ring_b._ids if str(m).startswith("mid-a"))
            assert in_ring == sorted(f"mid-a{p}" for p in parts_a)
            assert ring_b.seen(f"mid-a{min(parts_a)}")  # a redelivery is a duplicate
            delta = _delta(side, c0)
            ka.setup_consumer([side.config.USER_MESSAGE_TOPIC])  # the rejoin
            coord_a2 = side.pod.PodCoordinator(_pod_cfg(side, "hostA", listen="inproc:hostA"),
                                               kafka=ka)
            await coord_a2.start()
            await coord_b._heartbeat(peer)
            assert peer.state == side.pod.PEER_LIVE
            rejoin = ({p for _t, p in ka.assignment()}, {p for _t, p in kb.assignment()})
            coord_a2.kill()
            out[name] = dict(parts_a=parts_a, parts_b=parts_b, in_ring=in_ring, delta=delta,
                             rejoin=rejoin, pull_parts=sorted(coord_b._pull_partitions))
        finally:
            coord_a.kill()
            await coord_b.stop()
            jb.close()
    assert out["port"] == out["jax"]
    o = out["port"]
    assert o["rejoin"] == (o["parts_a"], o["parts_b"])
    assert o["delta"]["finchat_pod_partition_adoptions_total"] == len(o["parts_a"])
    assert o["delta"]["finchat_pod_adopted_ids_replayed_total"] == len(o["parts_a"])


def test_broker_evict_member_is_the_reference_rebalance():
    """``InMemoryBroker.evict_member``: the evicted member's partitions move
    to the survivors as the JAX broker moves them."""
    out = {}
    for name, side in SIDES.items():
        broker = side.kafka.InMemoryBroker(num_partitions=8)
        kcfg = side.config.KafkaConfig(num_partitions=8)
        clients = [side.kafka.KafkaClient(kcfg, broker=broker) for _ in range(3)]
        for i, c in enumerate(clients):
            c._member_id = f"member-{i}"
            c.setup_consumer([side.config.USER_MESSAGE_TOPIC])
        before = [sorted(p for _t, p in c.assignment()) for c in clients]
        broker.evict_member(side.config.GROUP_ID, "member-1")
        broker.evict_member(side.config.GROUP_ID, "member-unknown")  # a no-op
        after = [sorted(p for _t, p in c.assignment()) for c in (clients[0], clients[2])]
        out[name] = (before, after)
    assert out["port"] == out["jax"]
    assert sorted(sum(out["port"][1], [])) == list(range(8))


# --- the session record across hosts ------------------------------------------

@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("bounded", [False, True])
def test_wire_format_cross_host_compat_matrix(models, kv_quant, bounded):
    """A record exported under {fp32, int8 KV} x {bounded, unbounded} imports
    on another host's fresh engine and resumes as the uninterrupted original;
    the record's header bytes and resumed lengths equal across packages."""
    t1 = list(range(1, 29)) if bounded else list(range(1, 14))
    n1 = 20 if bounded else 8

    async def run(name):
        side = SIDES[name]
        sched_a = _make_scheduler(models, name, "hostA-0", kv_quant, bounded)
        await sched_a.start()
        _, toks1 = await _collect(side, sched_a, "a-t1", t1, n1, conversation_id="convM")
        raw = _pod_record(side, sched_a, "convM")
        rec = side.tier._deserialize(raw)
        if bounded:
            assert rec["kv_gap"] > 0
        t2 = t1 + toks1 + [7, 8, 9]
        h_ref, toks2_ref = await _collect(side, sched_a, "a-t2", t2, 8, conversation_id="convM")
        await sched_a.stop()
        sched_b = _make_scheduler(models, name, "hostB-0", kv_quant, bounded)
        await sched_b.start()
        assert _import_record(side, sched_b, raw)
        h_mig, toks2_mig = await _collect(side, sched_b, "b-t2", t2, 8, conversation_id="convM")
        await sched_b.stop()
        assert h_mig.resumed_len == h_ref.resumed_len > 0
        assert toks2_mig == toks2_ref
        sched_b.allocator.check_invariants()
        return dict(toks1=toks1, toks2=toks2_mig, resumed=h_mig.resumed_len,
                    header=(rec["conversation_id"], rec["prefix_len"], rec["kv_gap"],
                            rec["kv_sink"], np.asarray(rec["token_ids"]).tolist()))

    out = {name: asyncio.run(run(name)) for name in SIDES}
    _assert_teacher_forced(models, t1, out["port"]["toks1"], out["jax"]["toks1"])
    if out["port"]["toks1"] == out["jax"]["toks1"]:
        assert out["port"]["header"] == out["jax"]["header"]
        assert out["port"]["resumed"] == out["jax"]["resumed"]


def test_cross_mode_record_refused_and_counted(models):
    """An fp32-KV record arriving on an int8-KV host is refused and counted;
    the conversation starts cold and still answers."""
    t1 = list(range(1, 14))

    async def run(name):
        side = SIDES[name]
        sched_a = _make_scheduler(models, name, "hostA-0", kv_quant="")
        await sched_a.start()
        _, toks1 = await _collect(side, sched_a, "a-t1", t1, 8, conversation_id="convX")
        raw = _pod_record(side, sched_a, "convX")
        await sched_a.stop()
        sched_b = _make_scheduler(models, name, "hostB-0", kv_quant="int8")
        await sched_b.start()
        r0 = side.metrics.get("finchat_quant_dequant_fallbacks_total")
        assert not _import_record(side, sched_b, raw)
        refused = side.metrics.get("finchat_quant_dequant_fallbacks_total") - r0
        assert sched_b.session_cache.get("convX") is None
        h, toks = await _collect(side, sched_b, "b-t2", t1 + toks1 + [7, 8, 9], 8,
                                 conversation_id="convX")
        await sched_b.stop()
        return dict(refused=refused, resumed=h.resumed_len, answered=len(toks))

    out = {name: asyncio.run(run(name)) for name in SIDES}
    assert out["port"] == out["jax"] == dict(refused=1, resumed=0, answered=8)


# --- the pull through the liaison ----------------------------------------------

def _single_replica_fleet(side, sched):
    return side.fleet.EngineFleet(
        [side.fleet.EngineReplica(replica_id=sched.replica_id, scheduler=sched)],
        side.config.FleetConfig(replicas=1), num_partitions=8)


def test_pod_session_pull_end_to_end(models):
    """hostB's submit pulls the conversation's newest record from hostA over
    the liaison, imports it and resumes as hostA's uninterrupted turn; an
    unknown key is one counted miss (never pulled again), a corrupt transfer
    and an armed ``pod.transfer`` fault are counted cold starts that still
    answer. Counters, resumed lengths and streams equal across packages."""
    t1 = list(range(1, 14))

    async def run(name):
        side = SIDES[name]
        sched_a = _make_scheduler(models, name, "hostA-0")
        await sched_a.start()
        coord_a = side.pod.PodCoordinator(_pod_cfg(side, "hostA", listen="inproc:hostA"),
                                          fleet=_single_replica_fleet(side, sched_a))
        await coord_a.start()
        sched_b = _make_scheduler(models, name, "hostB-0")
        await sched_b.start()
        coord_b = side.pod.PodCoordinator(_pod_cfg(side, "hostB", peers="hostA=inproc:hostA"))
        sched_b.pod = coord_b
        cold = {r: side.metrics.get("finchat_pod_cold_starts_total", {"reason": r})
                for r in side.pod.COLD_START_REASONS}
        c0 = _counters(side)
        try:
            _, toks1 = await _collect(side, sched_a, "a-t1", t1, 8, conversation_id="convP")
            t2 = t1 + toks1 + [7, 8, 9]
            h_mig, toks2_mig = await _collect(side, sched_b, "b-t2", t2, 8,
                                              conversation_id="convP")
            _, toks2_ref = await _collect(side, sched_a, "a-t2", t2, 8, conversation_id="convP")
            assert h_mig.resumed_len > 0
            assert toks2_mig == toks2_ref
            await _collect(side, sched_b, "b-u1", t1, 4, conversation_id="convU")
            await _collect(side, sched_b, "b-u2", t1 + [9], 4, conversation_id="convU")

            async def corrupt_export(key):
                return b"garbage-not-a-record"

            coord_a.export_record = corrupt_export
            h_c, _ = await _collect(side, sched_b, "b-c1", t1, 4, conversation_id="convC")
            side.faults.arm("pod.transfer", side.faults.n_shot(8, RuntimeError("net")))
            h_f, _ = await _collect(side, sched_b, "b-f1", t1, 4, conversation_id="convF")
            return dict(
                toks1=toks1, toks2=toks2_mig, resumed=h_mig.resumed_len,
                cold_resumed=(h_c.resumed_len, h_f.resumed_len), counters=_delta(side, c0),
                cold={r: side.metrics.get("finchat_pod_cold_starts_total", {"reason": r}) - v
                      for r, v in cold.items()})
        finally:
            coord_a.kill()
            await coord_b.stop()
            await sched_a.stop()
            await sched_b.stop()
            sched_a.allocator.check_invariants()
            sched_b.allocator.check_invariants()

    out = {name: asyncio.run(run(name)) for name in SIDES}
    for k in ("resumed", "cold_resumed", "counters", "cold"):
        assert out["port"][k] == out["jax"][k], k
    o = out["port"]
    assert o["counters"]["finchat_pod_session_pulls_total"] == 1
    assert o["counters"]["finchat_pod_pull_misses_total"] == 1
    assert o["cold"] == {"breaker_open": 0, "peer_unreachable": 1, "transfer_corrupt": 1,
                         "import_refused": 0}
    assert o["cold_resumed"] == (0, 0)
    _assert_teacher_forced(models, t1, o["toks1"], out["jax"]["toks1"])
    if o["toks1"] == out["jax"]["toks1"]:
        _assert_teacher_forced(models, t1 + o["toks1"] + [7, 8, 9], o["toks2"],
                               out["jax"]["toks2"])


async def test_port_pulls_a_record_served_by_a_jax_host(models):
    """A JAX host serves a conversation's record over loopback TCP; the
    port's scheduler pulls it, imports it and resumes it with the JAX
    host's own continuation (teacher-forced), at the JAX resumed length."""
    jside, tside = SIDES["jax"], SIDES["port"]
    t1 = list(range(1, 14))
    port = _free_port()
    sched_a = _make_scheduler(models, "jax", "hostA-0")
    await sched_a.start()
    coord_a = jpod.PodCoordinator(_pod_cfg(jside, "hostA", listen=f"tcp:127.0.0.1:{port}"),
                                  fleet=_single_replica_fleet(jside, sched_a))
    await coord_a.start()
    sched_b = _make_scheduler(models, "port", "hostB-0")
    await sched_b.start()
    coord_b = tpod.PodCoordinator(_pod_cfg(tside, "hostB", peers=f"hostA=tcp:127.0.0.1:{port}",
                                           transfer_timeout_seconds=10.0))
    sched_b.pod = coord_b
    try:
        _, toks1 = await _collect(jside, sched_a, "a-t1", t1, 8, conversation_id="convJ")
        t2 = t1 + toks1 + [7, 8, 9]
        pulls0 = METRICS.get("finchat_pod_session_pulls_total")
        h_b, toks2_b = await _collect(tside, sched_b, "b-t2", t2, 8, conversation_id="convJ")
        assert METRICS.get("finchat_pod_session_pulls_total") == pulls0 + 1
        h_a, toks2_a = await _collect(jside, sched_a, "a-t2", t2, 8, conversation_id="convJ")
        assert h_b.resumed_len == h_a.resumed_len > 0
        _assert_teacher_forced(models, t2, toks2_b, toks2_a)
    finally:
        coord_a.kill()
        await coord_b.stop()
        await sched_a.stop()
        await sched_b.stop()
        sched_b.allocator.check_invariants()


def test_single_host_no_liaison_is_bit_identical(models):
    """With the plane off, and with a peer-less coordinator attached, one
    scheduler serves the same stream and no pod counter moves."""

    async def run(name):
        side = SIDES[name]
        sched = _make_scheduler(models, name, "solo-0")
        await sched.start()
        t1 = list(range(1, 14))
        c0 = _counters(side)
        assert sched.pod is None
        _, toks_off = await _collect(side, sched, "s-1", t1, 8, conversation_id="solo1")
        sched.pod = side.pod.PodCoordinator(_pod_cfg(side, "solo"))
        _, toks_pod = await _collect(side, sched, "s-2", t1, 8, conversation_id="solo2")
        await sched.stop()
        assert toks_pod == toks_off
        delta = _delta(side, c0)
        assert not any(delta.values())
        return toks_off

    out = {name: asyncio.run(run(name)) for name in SIDES}
    _assert_teacher_forced(models, list(range(1, 14)), out["port"], out["jax"])


# --- the app --------------------------------------------------------------------

def _stub_app(side_name, tmp_path, **over):
    side = SIDES[side_name]
    if side_name == "port":
        from finchat_tpu_torch.engine.generator import StubGenerator
        from finchat_tpu_torch.io.store import InMemoryStore
        from finchat_tpu_torch.serve.app import build_app
    else:
        from finchat_tpu.engine.generator import StubGenerator
        from finchat_tpu.io.store import InMemoryStore
        from finchat_tpu.serve.app import build_app
    cfg = side.config.load_config(overrides={"model.preset": "stub", **over})
    kw = {"device": "cpu"} if side_name == "port" else {}
    return build_app(cfg, store=InMemoryStore(),
                     kafka=side.kafka.KafkaClient(cfg.kafka, broker=side.kafka.InMemoryBroker()),
                     tool_generator=StubGenerator(default="No tool call"),
                     response_generator=StubGenerator(default="fine"), **kw)


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_pod_off_in_app_config_builds_no_coordinator(side_name, tmp_path):
    app = _stub_app(side_name, tmp_path)
    assert app.cfg.pod.host_id == ""
    assert app.pod is None
    for sched in app._all_schedulers():
        assert getattr(sched, "pod", None) is None


def test_app_with_a_host_id_runs_the_pod_plane(models, tmp_path):
    """``pod.host_id`` set: ``build_app`` builds a ``PodCoordinator`` over the
    app's Kafka client, journal and dedupe ring, attached to every scheduler
    of a fleet; ``start`` takes the partition assignment after the consumer
    is set up and opens the liaison, ``stop`` closes it."""
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.serve.app import build_app
    from finchat_tpu_torch.utils.config import load_config

    class NoRows:
        async def search(self, *a, **k):
            return []

    name = "pod-app-a"
    cfg = load_config(overrides={
        "model.preset": "tiny", "fleet.replicas": 2, "engine.max_seqs": 2,
        "engine.num_pages": 32, "engine.max_seq_len": 128, "engine.prefill_chunk": 16,
        "engine.prefix_cache": False, "journal.path": str(tmp_path / "journal"),
        "pod.host_id": "hostA", "pod.listen": f"inproc:{name}",
        "pod.peers": "hostB=inproc:pod-app-b", "pod.heartbeat_interval_seconds": 60.0})
    broker = tkafka.InMemoryBroker()
    kafka = tkafka.KafkaClient(cfg.kafka, broker=broker)
    app = build_app(cfg, store=InMemoryStore(), kafka=kafka, retriever=NoRows(), device="cpu")
    pod = app.pod
    assert isinstance(pod, tpod.PodCoordinator) and pod.host_id == "hostA"
    assert pod.fleet is app.fleet and pod.kafka is kafka
    assert pod.journal is app._journal and pod.dedupe is app._dedupe is app.fleet.dedupe
    assert all(s.pod is pod for s in app._all_schedulers())
    assert list(pod.peers) == ["hostB"]

    async def lifecycle():
        await app.start(serve_http=False)
        try:
            assert tpod._INPROC.get(name) is pod.liaison
            assert pod._prev_assignment == set(kafka.assignment()) != set()
            assert pod._pull_partitions == {p for _t, p in kafka.assignment()}
        finally:
            await app.stop()
        assert name not in tpod._INPROC

    asyncio.run(lifecycle())
