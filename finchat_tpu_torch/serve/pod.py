"""The multi-host pod plane (own copy of the JAX package's serve/pod.py).

One process is one HOST, one failure domain. Inside a host an
``EngineFleet`` runs N replicas over one weight tree; across hosts this
module makes the pod cohere:

- **Routing is partition assignment.** Each host's App is ONE member of the
  Kafka consumer group, so the broker's partition assignment is the
  cross-host routing table. A host's death is a group rebalance: only its
  partition share moves, and a rejoin restores the exact prior mapping
  (the assignment is positional over the sorted member ids).
- **The liaison channel.** A length-prefixed frame protocol (``FPOD`` magic,
  a version byte, a JSON header with the payload's CRC32) over asyncio TCP
  or the in-process registry (``inproc:``, the simulated-pod and test
  transport), carrying two operations: ``ping``/``pong`` heartbeats (the
  failure detector; a pong also tells the peer's Kafka member id) and
  ``pull_session`` (the newest record of a conversation, in the session
  disk tier's own checksummed v2 record format: the drain handoff's wire
  format, going across hosts unchanged). Every call has a timeout and
  retries with exponential backoff, and each peer has a circuit breaker
  (``pod.breaker_threshold`` consecutive failures open the channel; a
  half-open probe rides the next call after ``pod.breaker_cooldown_seconds``).
  The fault sites ``pod.heartbeat`` and ``pod.transfer`` are armable.
- **Host-death adoption.** ``pod.heartbeat_miss_threshold`` consecutive
  missed heartbeats declare a peer dead: the coordinator evicts its group
  member (what a real broker's ``session.timeout.ms`` does; the memory
  broker has no timer, so the pod's verdict drives it), diffs its own
  assignment to find the partitions it inherited, and replays exactly those
  per-partition journals into the dedupe ring
  (``AnsweredJournal.replay(partitions=..., compact=False)``): journal
  ownership follows partition ownership, so a redelivery after a host's
  kill -9 is not answered twice. The dead host's conversations then resume
  on the adopter through the normal admission: warm from the shared fabric
  (engine/warm_fabric.py) when one is configured, warm through a liaison
  pull from a live prior owner otherwise, else a cold start.
- **Graceful degradation.** An empty ``pod.host_id`` never builds this
  module: the app is the plain fleet. An unreachable peer, a transfer that
  fails its checksum, an import refusal (a record of the other KV mode is
  refused and counted by ``import_session_entry`` itself): every failure of
  the pod path is a cold start counted on
  ``finchat_pod_cold_starts_total{reason=...}``, never a user error.

Per-partition journal files make the adoption's replay exact only when the
adopter can read the dead host's files: in a real pod the journal directory
lives on the shared fabric's storage; simulated pods in one process share a
local directory, which is the same thing.

The frames and the records are byte-identical to the JAX package's, so a
host of either package pulls from a host of the other.
"""

from __future__ import annotations

import asyncio
import json
import time
import zlib

from finchat_tpu_torch.engine.session_cache import SessionDiskTier, conversation_of
from finchat_tpu_torch.utils.config import GROUP_ID, PodConfig
from finchat_tpu_torch.utils.faults import inject
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS
from finchat_tpu_torch.utils.tracing import TRACER

logger = get_logger(__name__)

MAGIC = b"FPOD"
VERSION = 1

PEER_LIVE = "LIVE"
PEER_DEAD = "DEAD"

# the reasons of finchat_pod_cold_starts_total, pre-seeded:
# breaker_open     — the peer's liaison channel is open; no pull attempted
# peer_unreachable — a transport failure through every retry
# transfer_corrupt — a frame or record failed its checksum or shape checks
# import_refused   — the record arrived whole but the engine refused it
#                    (the other KV mode, an unmatched shared head, over budget)
COLD_START_REASONS = ("breaker_open", "peer_unreachable", "transfer_corrupt", "import_refused")

# bound on the memo of conversations already pulled or missed
_PULL_MEMO_CAP = 65536


# --- frame codec -----------------------------------------------------------

def encode_frame(op: str, meta: dict | None = None, payload: bytes = b"") -> bytes:
    """``FPOD | u8 version | u32 header_len | header JSON | payload``: the
    session disk tier's length-prefixed, checksummed shape, so a torn or
    bit-flipped frame is always detected, never misparsed."""
    header = json.dumps({
        "op": op,
        "meta": meta or {},
        "payload_len": len(payload),
        "crc": zlib.crc32(payload),
    }).encode()
    return MAGIC + bytes([VERSION]) + len(header).to_bytes(4, "big") + header + payload


def decode_frame(raw: bytes) -> tuple[str, dict, bytes]:
    """(op, meta, payload); raises ValueError on any anomaly."""
    if raw[:4] != MAGIC:
        raise ValueError("bad liaison frame magic")
    if raw[4] != VERSION:
        raise ValueError(f"unknown liaison frame version {raw[4]}")
    hlen = int.from_bytes(raw[5:9], "big")
    header = json.loads(raw[9:9 + hlen].decode())
    payload = raw[9 + hlen:]
    if len(payload) != header["payload_len"]:
        raise ValueError("truncated liaison frame")
    if zlib.crc32(payload) != header["crc"]:
        raise ValueError("liaison frame checksum mismatch")
    return header["op"], header.get("meta") or {}, payload


async def _read_frame(reader: asyncio.StreamReader) -> tuple[str, dict, bytes]:
    head = await reader.readexactly(9)
    if head[:4] != MAGIC:
        raise ValueError("bad liaison frame magic")
    hlen = int.from_bytes(head[5:9], "big")
    header_bytes = await reader.readexactly(hlen)
    payload_len = json.loads(header_bytes.decode())["payload_len"]
    payload = await reader.readexactly(payload_len)
    return decode_frame(head + header_bytes + payload)


def _parse_addr(addr: str) -> tuple[str, str]:
    """``tcp:host:port`` / ``inproc:name`` → (kind, rest)."""
    kind, sep, rest = addr.partition(":")
    if not sep or kind not in ("tcp", "inproc") or not rest:
        raise ValueError(f"bad liaison address {addr!r} "
                         "(expected tcp:<host>:<port> or inproc:<name>)")
    return kind, rest


def parse_peers(spec: str) -> dict[str, str]:
    """``pod.peers`` ("hostB=tcp:127.0.0.1:9710,hostC=inproc:hostC") →
    {host_id: addr}. Raises ValueError on a malformed entry: a mistyped peer
    table fails loudly at startup instead of dropping a host from the
    failure detector."""
    out: dict[str, str] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        host, sep, addr = item.partition("=")
        if not sep or not host.strip():
            raise ValueError(f"bad pod.peers entry {item!r} (expected <host_id>=<addr>)")
        _parse_addr(addr.strip())
        out[host.strip()] = addr.strip()
    return out


# --- in-process transport --------------------------------------------------

# the inproc liaison registry: name -> PodLiaison. Requests still round-trip
# through the codec on both sides, so the frames (and their CRC) are
# exercised as over TCP
_INPROC: dict[str, "PodLiaison"] = {}


class PodLiaison:
    """The host's liaison endpoint: serves ``ping`` and ``pull_session`` for
    its peers and dials theirs. All I/O is asyncio: no blocking socket call
    touches the event loop."""

    def __init__(self, cfg: PodConfig, coordinator: "PodCoordinator"):
        self.cfg = cfg
        self.coordinator = coordinator
        self._server: asyncio.AbstractServer | None = None
        self._inproc_name: str | None = None
        self._closed = False

    async def start(self) -> None:
        if not self.cfg.listen:
            return
        kind, rest = _parse_addr(self.cfg.listen)
        if kind == "inproc":
            _INPROC[rest] = self
            self._inproc_name = rest
        else:
            host, _, port = rest.rpartition(":")
            self._server = await asyncio.start_server(self._serve_conn, host or "127.0.0.1",
                                                      int(port))
        logger.info("pod: liaison for %s listening on %s", self.coordinator.host_id,
                    self.cfg.listen)

    def kill(self) -> None:
        """Drop off the wire with no goodbye (also the kill -9 simulation:
        peers see timeouts and refusals, never a clean close)."""
        self._closed = True
        if self._inproc_name is not None:
            _INPROC.pop(self._inproc_name, None)
            self._inproc_name = None
        if self._server is not None:
            self._server.close()
            self._server = None

    # --- server side -----------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    op, meta, payload = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                except ValueError as e:
                    logger.warning("pod: dropping corrupt liaison frame: %s", e)
                    break
                rop, rmeta, rpayload = await self._handle(op, meta, payload)
                writer.write(encode_frame(rop, rmeta, rpayload))
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    async def _handle(self, op: str, meta: dict, payload: bytes) -> tuple[str, dict, bytes]:
        if self._closed:
            raise ConnectionError("liaison is down")
        if op == "ping":
            return "pong", self.coordinator.identity(), b""
        if op == "pull_session":
            rec = await self.coordinator.export_record(meta.get("key", ""))
            if rec is None:
                return "miss", {}, b""
            return "record", {"key": meta.get("key", "")}, rec
        return "error", {"message": f"unknown liaison op {op!r}"}, b""

    # --- client side -----------------------------------------------------
    async def call(self, addr: str, op: str, meta: dict | None = None, payload: bytes = b"",
                   timeout: float = 5.0) -> tuple[str, dict, bytes]:
        kind, rest = _parse_addr(addr)
        if kind == "inproc":
            target = _INPROC.get(rest)
            if target is None:
                raise ConnectionError(f"inproc liaison {rest!r} not listening")
            # both frames round-trip through the codec, as over TCP
            rop, rmeta, rpayload = decode_frame(encode_frame(op, meta, payload))
            reply = await asyncio.wait_for(target._handle(rop, rmeta, rpayload), timeout)
            return decode_frame(encode_frame(*reply))
        host, _, port = rest.rpartition(":")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host or "127.0.0.1", int(port)), timeout)
        try:
            writer.write(encode_frame(op, meta, payload))
            await writer.drain()
            return await asyncio.wait_for(_read_frame(reader), timeout)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass


# --- peer bookkeeping ------------------------------------------------------

class PeerChannel:
    """One peer host: its liveness verdict and its circuit breaker."""

    def __init__(self, host_id: str, addr: str, cfg: PodConfig):
        self.host_id = host_id
        self.addr = addr
        self.cfg = cfg
        self.state = PEER_LIVE  # until the detector says otherwise
        self.misses = 0
        self.member_id: str | None = None  # learned from pongs
        self._consec_failures = 0
        self._open_until = 0.0

    def breaker_allows(self) -> bool:
        """Closed, or open with its cooldown elapsed (the half-open probe:
        one call rides through; a failure opens it again)."""
        if self._consec_failures < self.cfg.breaker_threshold:
            return True
        return time.monotonic() >= self._open_until

    def record_success(self) -> None:
        self._consec_failures = 0

    def record_failure(self) -> None:
        self._consec_failures += 1
        if self._consec_failures == self.cfg.breaker_threshold:
            METRICS.inc("finchat_pod_breaker_trips_total")
            logger.warning("pod: liaison breaker to %s opened after %d consecutive failures",
                           self.host_id, self._consec_failures)
        if self._consec_failures >= self.cfg.breaker_threshold:
            self._open_until = time.monotonic() + self.cfg.breaker_cooldown_seconds


class PodCoordinator:
    """The host's pod plane: heartbeats its peer table, adopts a dead peer's
    partitions (the journal replay into the dedupe ring with them), serves
    and makes cross-host session pulls."""

    def __init__(self, cfg: PodConfig, *, fleet=None, kafka=None, journal=None, dedupe=None):
        self.cfg = cfg
        self.host_id = cfg.host_id
        self.fleet = fleet
        self.kafka = kafka
        self.journal = journal
        self.dedupe = dedupe
        self.liaison = PodLiaison(cfg, self)
        self.peers: dict[str, PeerChannel] = {
            host: PeerChannel(host, addr, cfg) for host, addr in parse_peers(cfg.peers).items()
        }
        self._hb_task: asyncio.Task | None = None
        self._prev_assignment: set[tuple[str, int]] = set()
        # partitions whose conversations may have lived on another host
        # (everything owned at join time, and everything adopted since)
        self._pull_partitions: set[int] = set()
        # conversations already pulled or missed: one liaison round a
        # conversation, not one a turn
        self._pull_done: set[str] = set()
        self.on_peer_dead: list = []  # callbacks (host_id, PeerChannel)
        self.on_peer_alive: list = []
        for name in ("finchat_pod_heartbeats_total", "finchat_pod_heartbeat_failures_total",
                     "finchat_pod_peer_deaths_total", "finchat_pod_peer_rejoins_total",
                     "finchat_pod_partition_adoptions_total",
                     "finchat_pod_adopted_ids_replayed_total", "finchat_pod_session_pulls_total",
                     "finchat_pod_pull_misses_total", "finchat_pod_breaker_trips_total"):
            METRICS.inc(name, 0.0)
        for reason in COLD_START_REASONS:
            METRICS.inc("finchat_pod_cold_starts_total", 0.0, labels={"reason": reason})

    def identity(self) -> dict:
        return {"host_id": self.host_id, "member_id": getattr(self.kafka, "member_id", None)}

    # --- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        await self.liaison.start()
        if self.kafka is not None:
            self._prev_assignment = set(self.kafka.assignment())
            if self.peers:
                # a host joining a pod presumes any partition of its own may
                # have been served elsewhere before (a rejoin after a kill, a
                # scale-out into a running pod): the first contact with each
                # conversation gets one pull round
                self._pull_partitions = {p for _t, p in self._prev_assignment}
        self._publish_hosts_live()
        if self.peers:
            self._hb_task = asyncio.create_task(self._heartbeat_loop())

    async def stop(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except asyncio.CancelledError:
                pass
            self._hb_task = None
        self.liaison.kill()

    def kill(self) -> None:
        """The kill -9 simulation: no drain, no goodbye. The liaison drops off
        the wire and the heartbeat task dies mid-flight."""
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None
        self.liaison.kill()

    def _publish_hosts_live(self) -> None:
        live = 1 + sum(1 for p in self.peers.values() if p.state == PEER_LIVE)
        METRICS.set_gauge("finchat_pod_hosts_live", live)

    # --- failure detector ------------------------------------------------
    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.heartbeat_interval_seconds)
            for peer in list(self.peers.values()):
                await self._heartbeat(peer)

    async def _heartbeat(self, peer: PeerChannel) -> None:
        try:
            inject("pod.heartbeat", peer=peer.host_id, host=self.host_id)
            op, meta, _ = await self.liaison.call(peer.addr, "ping", {"host_id": self.host_id},
                                                  timeout=self.cfg.transfer_timeout_seconds)
            if op != "pong":
                raise ConnectionError(f"unexpected heartbeat reply {op!r}")
            METRICS.inc("finchat_pod_heartbeats_total")
            peer.misses = 0
            peer.record_success()
            if meta.get("member_id"):
                peer.member_id = meta["member_id"]
            if peer.state == PEER_DEAD:
                self._peer_rejoined(peer)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            METRICS.inc("finchat_pod_heartbeat_failures_total")
            peer.misses += 1
            peer.record_failure()
            if peer.state == PEER_LIVE and peer.misses >= self.cfg.heartbeat_miss_threshold:
                self._peer_died(peer, reason=str(e))

    def _peer_died(self, peer: PeerChannel, reason: str = "") -> None:
        peer.state = PEER_DEAD
        METRICS.inc("finchat_pod_peer_deaths_total")
        logger.error("pod: host %s declared dead after %d missed heartbeats (%s); adopting "
                     "its partition share", peer.host_id, peer.misses, reason)
        TRACER.anomaly("pod_host_lost", args={"host": peer.host_id, "misses": peer.misses})
        self._publish_hosts_live()
        for cb in list(self.on_peer_dead):
            try:
                cb(peer.host_id, peer)
            except Exception as e:
                logger.error("pod: on_peer_dead hook failed: %s", e)
        self._evict_peer_member(peer)
        self._adopt_new_partitions(dead_host=peer.host_id)

    def _peer_rejoined(self, peer: PeerChannel) -> None:
        peer.state = PEER_LIVE
        peer.misses = 0
        METRICS.inc("finchat_pod_peer_rejoins_total")
        logger.info("pod: host %s is back; its partition share returns on the next rebalance",
                    peer.host_id)
        self._publish_hosts_live()
        for cb in list(self.on_peer_alive):
            try:
                cb(peer.host_id, peer)
            except Exception as e:
                logger.error("pod: on_peer_alive hook failed: %s", e)
        if self.kafka is not None:
            # the next death's adoption diffs against the restored mapping,
            # not the widened one in between
            self._prev_assignment = set(self.kafka.assignment())

    def _evict_peer_member(self, peer: PeerChannel) -> None:
        """Memory-broker pods: the broker has no session timer, so the pod's
        verdict evicts the member (a real broker does it itself at
        ``session.timeout.ms``). No member id learned yet (the peer died
        before its first pong) leaves nothing to evict."""
        broker = getattr(self.kafka, "_broker", None)
        if broker is None or not peer.member_id:
            return
        try:
            broker.evict_member(GROUP_ID, peer.member_id)
        except Exception as e:
            logger.error("pod: evicting %s (%s) from the group failed: %s", peer.host_id,
                         peer.member_id, e)

    # --- partition adoption ----------------------------------------------
    def _adopt_new_partitions(self, dead_host: str = "") -> None:
        if self.kafka is None:
            return
        new = set(self.kafka.assignment())
        inherited = sorted({p for _t, p in new - self._prev_assignment})
        self._prev_assignment = new
        if not inherited:
            return
        METRICS.inc("finchat_pod_partition_adoptions_total", len(inherited))
        self._pull_partitions.update(inherited)
        # the first contact with an inherited conversation gets a fresh pull
        # round, even one that missed before the rebalance
        self._pull_done.clear()
        replayed = 0
        if self.journal is not None and self.dedupe is not None:
            try:
                # compact=False: these files were the dead host's a heartbeat
                # ago; read them, never rewrite them while the handoff settles
                ids = self.journal.replay(partitions=inherited, compact=False)
                replayed = self.dedupe.preload(ids)
                if ids:
                    METRICS.inc("finchat_pod_adopted_ids_replayed_total", len(ids))
            except Exception as e:
                logger.error("pod: journal replay for adopted partitions %s failed: %s",
                             inherited, e)
        logger.info("pod: %s adopted partition(s) %s from %s (%d answered id(s) replayed into "
                    "the dedupe ring)", self.host_id, inherited, dead_host or "the group",
                    replayed)
        TRACER.event("pod_adopt", track="fleet",
                     args={"host": dead_host, "partitions": inherited, "replayed": replayed})

    # --- session transfer: server side -----------------------------------
    async def export_record(self, key: str) -> bytes | None:
        """A peer's ``pull_session``: the conversation's newest record as
        session-disk-tier v2 bytes, from the deepest RAM entry across this
        host's replicas (exported through the scheduler, which honours the
        shared-head bookkeeping), else the local disk tier's record. None =
        this host has nothing for the key."""
        if not key or self.fleet is None:
            return None
        best = None
        best_sched = None
        for rep in self.fleet.replicas:
            sched = rep.scheduler
            cache = getattr(sched, "session_cache", None)
            if cache is None:
                continue
            entry = cache.get(key)
            if entry is not None and (best is None or entry.n_tokens > best.n_tokens):
                best, best_sched = entry, sched
        if best is not None:
            payload = best_sched.export_session(key)
            if payload is not None:
                return SessionDiskTier._serialize(
                    key, payload["token_ids"], payload["prefix_len"], payload["snap"],
                    payload["kv_gap"], payload["kv_sink"])
        for rep in self.fleet.replicas:
            cache = getattr(rep.scheduler, "session_cache", None)
            disk = cache.disk if cache is not None else None
            if disk is not None and key in disk:
                # a blocking record read: off the loop, like every disk I/O
                payload = await asyncio.to_thread(disk.load, key)
                if payload is not None:
                    return SessionDiskTier._serialize(
                        key, payload["token_ids"], payload["prefix_len"], payload["snap"],
                        payload["kv_gap"], payload["kv_sink"])
                return None  # quarantined: nothing whole to serve
        return None

    # --- session transfer: client side ------------------------------------
    async def maybe_pull(self, sched, conversation_id: str, trace_id: str | None = None) -> None:
        """Called by a serving scheduler's ``submit`` before admission (as the
        disagg hook is): when the conversation's partition was, or may have
        been, served by another host and nothing local resumes it warm, pull
        its newest record from a live peer and import it. Best-effort: every
        failure is a counted cold start, nothing here raises into submit."""
        if not conversation_id or not self.peers:
            return
        cache = getattr(sched, "session_cache", None)
        if cache is None:
            return
        if cache.get(conversation_id) is not None:
            return  # warm here already
        if cache.disk is not None and conversation_id in cache.disk:
            return  # the local (or fabric) disk restore covers it
        if conversation_id in self._pull_done:
            return
        if self.kafka is not None and self._pull_partitions:
            part = self.kafka.partition_for(conversation_of(conversation_id))
            if part not in self._pull_partitions:
                return
        if len(self._pull_done) >= _PULL_MEMO_CAP:
            self._pull_done.clear()
        self._pull_done.add(conversation_id)
        live = [p for p in self.peers.values() if p.state == PEER_LIVE]
        for peer in live:
            if await self._pull_from(peer, sched, cache, conversation_id, trace_id):
                return

    async def _pull_from(self, peer: PeerChannel, sched, cache, key: str,
                         trace_id: str | None) -> bool:
        """One peer's pull: True = settled (imported, or refused for good);
        False = try the next peer (a miss, or unreachable)."""
        if not peer.breaker_allows():
            METRICS.inc("finchat_pod_cold_starts_total", labels={"reason": "breaker_open"})
            return False
        t0 = time.perf_counter()
        for attempt in range(self.cfg.transfer_retries + 1):
            try:
                inject("pod.transfer", peer=peer.host_id, key=key, attempt=attempt)
                op, _meta, payload = await self.liaison.call(
                    peer.addr, "pull_session", {"key": key},
                    timeout=self.cfg.transfer_timeout_seconds)
                peer.record_success()
                if op == "miss":
                    METRICS.inc("finchat_pod_pull_misses_total")
                    return False
                if op != "record":
                    raise ValueError(f"unexpected pull reply {op!r}")
                rec = SessionDiskTier._deserialize(payload)
                rec = cache.fit_payload(rec)
                ok = rec is not None and sched.import_session_entry(rec)
                if not ok:
                    # refused for good (the other KV mode, no matching head,
                    # over budget): a retry cannot change it
                    METRICS.inc("finchat_pod_cold_starts_total",
                                labels={"reason": "import_refused"})
                    return True
                METRICS.inc("finchat_pod_session_pulls_total")
                METRICS.observe("finchat_pod_transfer_seconds", time.perf_counter() - t0)
                TRACER.event("pod_session_pull", trace_id, track="fleet",
                             args={"peer": peer.host_id, "key": key, "bytes": len(payload)})
                logger.info("pod: pulled %s warm from %s (%d bytes)", key, peer.host_id,
                            len(payload))
                return True
            except asyncio.CancelledError:
                raise
            except ValueError as e:
                # a corrupt frame or record: the bytes are wrong, not the
                # wire, and a retry would fetch the same corruption
                METRICS.inc("finchat_pod_cold_starts_total", labels={"reason": "transfer_corrupt"})
                logger.warning("pod: pull of %s from %s corrupt (%s) — cold start", key,
                               peer.host_id, e)
                return True
            except Exception as e:
                peer.record_failure()
                if attempt < self.cfg.transfer_retries:
                    await asyncio.sleep(self.cfg.retry_backoff_seconds * (2 ** attempt))
                    continue
                METRICS.inc("finchat_pod_cold_starts_total", labels={"reason": "peer_unreachable"})
                logger.warning("pod: pull of %s from %s failed after %d attempt(s): %s — cold "
                               "start", key, peer.host_id, attempt + 1, e)
                return False
        return False
