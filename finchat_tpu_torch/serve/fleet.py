"""The engine fleet: several engine replicas under one serving plane (own
copy of the JAX package's ``serve/fleet.py``).

- Replicas: ``fleet.replicas`` engines, each with its own scheduler, KV page
  pool and session cache, over one parameter tree (the engines hold the
  same tensors: N replicas cost N pools, not N models). Each scheduler
  emits through ``METRICS.labeled(replica=...)``, so every family comes out
  per replica.
- Conversation-affinity routing: a conversation goes to the replica that
  rendezvous-hashes highest for its Kafka partition (``io/kafka.py
  partition_for_key``, the broker's own key placement), so session entries
  and prefix heads stay local and routing agrees with partition assignment.
  A replica leaving moves only its own partitions; rejoining moves exactly
  those back.
- Drain on trip: a replica's breaker trip preempts its live streams to the
  host and offers each to the drain sink, which routes it to a sibling with
  its conversation's session bytes; the handle's event queue goes with it,
  so the client's stream continues there while the tripped replica
  rebuilds.
- Give-up, OUT, supervised respawn: a breaker give-up drains what is live,
  marks the replica OUT (the router drops it) and the supervisor revives
  it in the background (``scheduler.revive_async``: the device state rebuilt
  from a clean slate, the prompt heads registered again) with exponential
  backoff. On rejoin its partitions route back.
- Session migration: session entries are host bytes keyed by conversation.
  A drain hands them over with the stream, and ``replica_for`` moves them
  at route time, so a conversation whose bytes sit on a sibling resumes
  warm on its next turn. An entry riding a shared head re-links against the
  importer's own registration of it.
- Disaggregated serving (serve/disagg.py): with a prefill-role replica the
  serving pool's schedulers run cold prompts' prefill there first.

One process, one event loop: handles and their event queues cross
schedulers freely. Migration scans the siblings' RAM tiers, or, with the
warm-state fabric (engine/warm_fabric.py), asks its holder index and drops
only the source's RAM copy, keeping the record the replicas share.

``DedupeRing`` is the answered-``message_id`` ring at the router level: one
ring for the whole fleet, so a replica's loss and Kafka's redelivery to a
sibling cannot answer a message twice.
"""

from __future__ import annotations

import asyncio
import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from finchat_tpu_torch.engine.session_cache import SESSION_KEY_ROLES, conversation_of, session_key
from finchat_tpu_torch.io.kafka import DEFAULT_NUM_PARTITIONS, partition_for_key
from finchat_tpu_torch.serve.disagg import (
    FALLBACK_REASONS,
    ROLE_DECODE,
    ROLE_MIXED,
    ROLE_PREFILL,
    DisaggCoordinator,
)
from finchat_tpu_torch.utils.config import FleetConfig
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS
from finchat_tpu_torch.utils.tracing import TRACER

logger = get_logger(__name__)

# replica lifecycle: LIVE (routed to), OUT (breaker gave up; the router
# skips it), RESPAWNING (the supervisor is reviving it; still skipped)
LIVE = "live"
OUT = "out"
RESPAWNING = "respawning"


def rendezvous_hash(key: str, candidates: list[str]) -> str | None:
    """Highest-random-weight choice of ``candidates`` for ``key``: each
    (key, candidate) pair weighs the first 8 bytes of its blake2b digest and
    the heaviest wins (ties to the smaller name). Removing a candidate moves
    only the keys it owned, each to its runner-up; adding it back restores
    the old mapping."""
    if not candidates:
        return None
    best, best_w = None, -1
    for cand in candidates:
        w = int.from_bytes(
            hashlib.blake2b(f"{key}\x00{cand}".encode(), digest_size=8).digest(), "big")
        if w > best_w or (w == best_w and (best is None or cand < best)):
            best, best_w = cand, w
    return best


class DedupeRing:
    """Bounded ring of answered (or in-flight) ``message_id``s. A Kafka
    redelivery of an id in the ring is not answered again. Across
    processes, the answered-message journal (io/journal.py) replays into it
    at startup through ``preload``."""

    def __init__(self, size: int = 1024):
        self.size = size
        self._ids: set = set()
        self._ring: deque = deque()

    def seen(self, message_id) -> bool:
        """True when ``message_id`` was already recorded; records it
        otherwise."""
        if message_id in self._ids:
            return True
        self._ids.add(message_id)
        self._ring.append(message_id)
        if len(self._ring) > self.size:
            self._ids.discard(self._ring.popleft())
        return False

    def preload(self, message_ids) -> int:
        """Seed the ring with journaled answered ids at startup, oldest
        first, so ring recency matches journal recency. Returns how many
        were new."""
        return sum(1 for mid in message_ids if not self.seen(mid))

    def forget(self, message_id) -> None:
        """Drop an id whose handling failed (never answered), ring slot
        included, so a producer retry is reprocessed and a stale slot
        cannot age the re-added id out early."""
        self._ids.discard(message_id)
        try:
            self._ring.remove(message_id)
        except ValueError:
            pass


@dataclass
class EngineReplica:
    """One engine replica: scheduler, generator and (bound by the serving
    layer) agent. ``registered_heads`` is the set of shared prompt heads
    live on this replica's scheduler: a registration belongs to one device
    state, so each replica registers again after its own rebuilds. ``role``
    is its pool (serve/disagg.py): a ``prefill`` replica owns no
    conversation; drain, OUT and respawn are the same for every role."""

    replica_id: str
    scheduler: Any
    generator: Any = None
    agent: Any = None
    state: str = LIVE
    registered_heads: set = field(default_factory=set)
    role: str = ROLE_MIXED


class EngineFleet:
    """The router, the drain plumbing and the supervisor over a replica
    list."""

    def __init__(self, replicas: list[EngineReplica], cfg: FleetConfig | None = None,
                 num_partitions: int = DEFAULT_NUM_PARTITIONS, metrics=None):
        assert replicas, "a fleet needs at least one replica"
        self.replicas = list(replicas)
        self.cfg = cfg or FleetConfig()
        self.num_partitions = num_partitions
        if len(self.replicas) > num_partitions:
            # the partition is the routing unit: at most one replica a
            # partition is ever chosen, the others idle with a full pool
            logger.warning(
                "fleet: %d replicas but only %d Kafka partitions — routing can address at "
                "most one replica per partition, the rest will receive NO traffic; raise "
                "kafka.num_partitions", len(self.replicas), num_partitions)
        self.metrics = metrics if metrics is not None else METRICS
        self.dedupe = DedupeRing()
        self._by_id = {r.replica_id: r for r in self.replicas}
        self._running = False
        self._supervisor_task: asyncio.Task | None = None
        # strong references to the respawns in flight (an unreferenced task
        # may be collected mid-flight); stop() cancels them
        self._respawn_tasks: set[asyncio.Task] = set()
        # serving-layer hooks run after a respawn (the app registers its
        # prompt heads again); sync or async callables taking the replica
        self.on_respawn: list[Callable[[EngineReplica], Any]] = []
        for rep in self.replicas:
            self._wire(rep)
        # with a prefill-role replica, the serving pool's schedulers route
        # cold prefills through the coordinator; all-prefill could serve
        # nothing and runs all-mixed instead
        self.disagg: DisaggCoordinator | None = None
        if all(r.role == ROLE_PREFILL for r in self.replicas):
            logger.error("fleet: every replica has role=prefill — no serving pool; running "
                         "all replicas mixed")
            for rep in self.replicas:
                rep.role = ROLE_MIXED
        if any(r.role == ROLE_PREFILL for r in self.replicas):
            self.disagg = DisaggCoordinator(self)
            for rep in self.replicas:
                if rep.role != ROLE_PREFILL:
                    rep.scheduler.disagg = self.disagg
        for rep in self.replicas:
            self._seed_disagg_metrics(rep)
        self._publish_live_gauge()

    # --- wiring ---------------------------------------------------------
    def _wire(self, rep: EngineReplica) -> None:
        sched = rep.scheduler
        if self.cfg.drain_on_trip and len(self.replicas) > 1:
            sched.drain_sink = self._make_drain_sink(rep)
        sched.on_give_up.append(lambda rep=rep: self._mark_out(rep))

    def _seed_disagg_metrics(self, rep: EngineReplica) -> None:
        """The disagg families at zero for each replica, with the role gauge
        naming its pool (skipped for a scheduler with no metrics view)."""
        m = getattr(rep.scheduler, "metrics", None)
        if m is None:
            return
        m.set_gauge("finchat_disagg_role",
                    {ROLE_MIXED: 0, ROLE_PREFILL: 1, ROLE_DECODE: 2}[rep.role])
        m.inc("finchat_disagg_handoffs_total", 0.0)
        for reason in FALLBACK_REASONS:
            m.inc("finchat_disagg_fallbacks_total", 0.0, labels={"reason": reason})

    def _publish_live_gauge(self) -> None:
        self.metrics.set_gauge("finchat_fleet_replicas_live",
                               sum(1 for r in self.replicas if r.state == LIVE))

    def _mark_out(self, rep: EngineReplica) -> None:
        if rep.state == LIVE:
            logger.error("fleet: replica %s is OUT (breaker give-up); reassigning its "
                         "partitions", rep.replica_id)
            rep.state = OUT
            self._publish_live_gauge()

    # --- routing --------------------------------------------------------
    def live_replicas(self) -> list[EngineReplica]:
        return [r for r in self.replicas if r.state == LIVE]

    def serving_replicas(self) -> list[EngineReplica]:
        """The pool conversations route over: live decode and mixed
        replicas, or every live replica when none of those is (a prefill
        replica serving decode beats shedding; counted where it lands)."""
        live = self.live_replicas()
        pool = [r for r in live if r.role != ROLE_PREFILL]
        return pool if pool else live

    def partition_for(self, conversation_id: str) -> int:
        return partition_for_key(conversation_id, self.num_partitions)

    def replica_for_partition(self, partition: int,
                              exclude: EngineReplica | None = None) -> EngineReplica | None:
        """The live serving replica owning a Kafka partition."""
        ids = [r.replica_id for r in self.serving_replicas() if r is not exclude]
        rid = rendezvous_hash(str(partition), ids)
        if rid is None:
            return None
        target = self._by_id[rid]
        if target.role == ROLE_PREFILL:
            # the empty-serving-pool fallback, counted a message on the
            # replica taking the decode load
            m = getattr(target.scheduler, "metrics", None)
            if m is not None:
                m.inc("finchat_disagg_fallbacks_total", labels={"reason": "serving_pool_empty"})
        return target

    def replica_for(self, conversation_id: str,
                    exclude: EngineReplica | None = None) -> EngineReplica | None:
        """Route a conversation to the live replica of its partition, first
        moving its session bytes there from a sibling that holds deeper
        ones, so admission resumes from them."""
        target = self.replica_for_partition(self.partition_for(conversation_id), exclude=exclude)
        if target is None:
            return None
        if len(self.replicas) > 1:
            if any(r is not target and r.state != LIVE for r in self.replicas):
                # the affinity owner may be out: count messages routed away
                # from the all-live assignment while a sibling is down
                all_ids = [r.replica_id for r in self.replicas]
                home = rendezvous_hash(str(self.partition_for(conversation_id)), all_ids)
                if home is not None and home != target.replica_id:
                    self.metrics.inc("finchat_fleet_reroutes_total")
            self._migrate_session(conversation_id, target)
        return target

    def agent_for(self, conversation_id: str):
        """The routed replica's agent. Raises when no replica is live (the
        caller answers a retryable error)."""
        rep = self.replica_for(conversation_id)
        if rep is None or rep.agent is None:
            raise RuntimeError("no live engine replica")
        return rep.agent

    # --- session migration ----------------------------------------------
    def _migrate_session(self, conversation_id: str, target: EngineReplica) -> None:
        """Move a conversation's session entries to its routed replica when
        a sibling holds deeper ones: the bare id (direct submissions) and
        each LLM role's key (``conv#tool``, ``conv#resp``). Best-effort: a
        refused import means a cold resume."""
        if getattr(target.scheduler, "session_cache", None) is None:
            return
        self._migrate_key(conversation_id, target)
        for role in SESSION_KEY_ROLES:
            self._migrate_key(session_key(conversation_id, role), target)

    def _migrate_key(self, key: str, target: EngineReplica) -> None:
        t_cache = target.scheduler.session_cache
        have = t_cache.get(key)
        have_n = have.n_tokens if have is not None else 0
        fabric = getattr(t_cache, "fabric", None)
        if fabric is not None:
            # the warm-state fabric: deeper-entry-wins is one lookup in its
            # holder index. No holder, or a shallower one, leaves nothing to
            # move: the shared tier serves any replica's record at admission,
            # so the scan's other job (finding disk-only bytes) is moot
            hold = fabric.holder(key)
            if hold is None:
                return
            rid, n_tokens = hold
            if rid == target.replica_id or n_tokens <= have_n:
                return
            rep = self._by_id.get(rid)
            if rep is not None and rep is not target:
                self._move_entry(rep, target, key)
            return
        for rep in self.replicas:
            if rep is target:
                continue
            s_cache = getattr(rep.scheduler, "session_cache", None)
            if s_cache is None:
                continue
            entry = s_cache.get(key)
            if entry is None or entry.n_tokens <= have_n:
                continue
            if self._move_entry(rep, target, key) is not None:
                return

    def _move_entry(self, rep: EngineReplica, target: EngineReplica, key: str) -> bool | None:
        """Export ``key`` from ``rep``'s RAM tier into ``target``'s. Returns
        the import's verdict, or None when there was nothing to export."""
        payload = rep.scheduler.export_session(key)
        if payload is None:
            return None
        try:
            imported = target.scheduler.import_session_entry(payload)
        except Exception as e:
            logger.error("session migration %s→%s failed for %s: %s", rep.replica_id,
                         target.replica_id, key, e)
            return False
        s_cache = rep.scheduler.session_cache
        if imported and s_cache.fabric is not None:
            # the shared tier: the target's put just refreshed the record,
            # and deleting it here would erase the target's own copy (both
            # ride the tier's one writer); only the RAM copy goes
            s_cache.drop_local(key)
        else:
            # the source's copy goes either way: a stale twin could serve
            # diverged KV if routing ever flips back
            s_cache.discard(key)
        if imported:
            self.metrics.inc("finchat_fleet_session_migrations_total")
            if TRACER.enabled:
                TRACER.event("session_migrate", track="fleet",
                             args={"key": key, "source": rep.replica_id,
                                   "target": target.replica_id})
            logger.info("fleet: migrated session %s %s→%s (%d tokens)", key, rep.replica_id,
                        target.replica_id, payload["token_ids"].shape[0])
        return imported

    # --- drain ----------------------------------------------------------
    def _make_drain_sink(self, source: EngineReplica):
        """The tripped replica's breaker calls this with each preempted
        handle and its conversation's exported session bytes; a sibling
        adopts both and the stream goes on there."""

        def sink(handle, session_payload) -> bool:
            # routed by the conversation, not the per-role key the handle
            # carries: the adopter must be where the next turns route
            key = conversation_of(handle.conversation_id or handle.seq_id)
            target = self.replica_for_partition(self.partition_for(key), exclude=source)
            if target is None:
                # not counted here: a refused handle replays locally after a
                # trip, and at give-up the pending-fail loop counts it once
                return False
            if not target.scheduler.adopt(handle):
                # the adopter is at its queue bound and the handle was never
                # admitted: refused like a fresh submit. adopt runs before the
                # import, so a refusal leaves no twin of the bytes behind
                return False
            if session_payload is not None:
                try:
                    if target.scheduler.import_session_entry(session_payload):
                        self.metrics.inc("finchat_fleet_session_handoffs_total")
                except Exception as e:
                    logger.error("session handoff to %s failed for %s: %s", target.replica_id,
                                 key, e)
            self.metrics.inc("finchat_fleet_drained_streams_total")
            trace_id = getattr(handle, "trace_id", None)
            if TRACER.enabled and trace_id is not None:
                TRACER.event("drain_handoff", trace_id, track="fleet",
                             args={"source": source.replica_id, "target": target.replica_id})
            logger.info("fleet: drained %s (%s) %s→%s", handle.seq_id, key, source.replica_id,
                        target.replica_id)
            return True

        return sink

    # --- lifecycle ------------------------------------------------------
    async def start(self) -> None:
        for rep in self.replicas:
            await rep.scheduler.start()
        self._running = True
        if self.cfg.respawn and len(self.replicas) > 1:
            self._supervisor_task = asyncio.create_task(self._supervise())

    async def stop_supervisor(self) -> None:
        """Cancel the supervisor and the respawns in flight without stopping
        the replicas: the graceful drain calls this before each replica's
        ``shutdown_drain``, so a respawn's rebuild cannot race the drain on
        the same engine. A rebuild already running on its worker thread
        finishes there; its cancelled task never commits the revive."""
        self._running = False
        for task in (*self._respawn_tasks,
                     *([self._supervisor_task] if self._supervisor_task else ())):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._respawn_tasks.clear()
        self._supervisor_task = None

    async def stop(self) -> None:
        await self.stop_supervisor()
        for rep in self.replicas:
            await rep.scheduler.stop()

    async def _supervise(self) -> None:
        """Respawn OUT replicas while the fleet keeps serving."""
        while self._running:
            for rep in self.replicas:
                if rep.state == OUT:
                    rep.state = RESPAWNING
                    task = asyncio.get_running_loop().create_task(self._respawn(rep))
                    self._respawn_tasks.add(task)
                    task.add_done_callback(self._respawn_tasks.discard)
            await asyncio.sleep(self.cfg.supervisor_interval_seconds)

    async def _respawn(self, rep: EngineReplica) -> None:
        delay = max(0.05, self.cfg.respawn_backoff_seconds)
        while self._running:
            try:
                # the rebuild runs in a worker thread (seconds of pool
                # allocation at full size): the siblings keep serving
                ok = await rep.scheduler.revive_async()
            except Exception as e:
                logger.error("respawn of %s raised: %s", rep.replica_id, e)
                ok = False
            if ok:
                rep.registered_heads = set()
                for cb in list(self.on_respawn):
                    try:
                        result = cb(rep)
                        if asyncio.iscoroutine(result):
                            await result
                    except Exception as e:
                        logger.error("on_respawn hook failed for %s: %s", rep.replica_id, e)
                if getattr(rep.scheduler, "gave_up", False):
                    # the hooks' head registration wedged it again (a give-up
                    # while RESPAWNING, which _mark_out ignores): marking it
                    # LIVE would route to a wedged engine; retry instead
                    logger.error("fleet: replica %s re-wedged during respawn (give-up while "
                                 "RESPAWNING); retrying", rep.replica_id)
                    ok = False
            if ok:
                rep.state = LIVE
                self._publish_live_gauge()
                self.metrics.inc("finchat_fleet_respawns_total")
                logger.info("fleet: replica %s respawned and LIVE", rep.replica_id)
                return
            await asyncio.sleep(delay)
            delay = min(delay * 2, 10.0)
        rep.state = OUT  # shutting down mid-respawn: it stays out
