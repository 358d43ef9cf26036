"""Disaggregated prefill/decode serving (own copy of the JAX package's
``serve/disagg.py``).

Prefill is a compute burst that holds the device for whole chunks; decode is
a steady run of small steps whose latency users feel a token at a time. On a
mixed replica a long cold prompt stalls every stream in flight for its
chunks. Role-typed pools split the two:

- ``fleet.roles`` gives each replica ``prefill``, ``decode`` or ``mixed``.
  The router's rendezvous hash runs over the serving pool (decode and
  mixed) only: prefill replicas own no conversation.
- When a serving replica admits a turn whose cold residue (prompt tokens not
  covered by a shared head, its RAM session entry or a disk record) is at
  least one prefill chunk, the ``DisaggCoordinator`` first runs the prompt
  on a prefill replica (an ordinary submission with ``max_new_tokens=1``,
  chunked like any prefill), then hands the KV to the serving replica over
  the drain handoff's wire format (``export_session`` then
  ``import_session_entry``: ``kv_gap`` and ``kv_sink`` travel, a shared
  head re-links against the importer's own registration). The stream is
  the one a mixed replica serves.
- Clean fallback: an empty, drained or tripped prefill pool, a prefill
  error (a breaker trip racing the pass included) or a refused import leave
  the serving replica prefilling locally, the mixed behaviour. Every
  fallback is counted by reason on ``finchat_disagg_fallbacks_total``.

The coordinator is attached (by ``EngineFleet``) to serving-pool schedulers
only, so a prefill replica's own submissions never recurse. A conversation's
prefill replica is chosen by ``io/kafka.py partition_for_key`` over the
pool, so its cold turns keep landing on the same one.

After the handoff the prefill replica's copy of the entry is discarded, or,
with the warm-state fabric (engine/warm_fabric.py), only its RAM copy is
dropped: the serving replica's import refreshed the shared record.
"""

from __future__ import annotations

import time

import numpy as np

from finchat_tpu_torch.engine.sampler import SamplingParams
from finchat_tpu_torch.io.kafka import partition_for_key
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.tracing import TRACER

logger = get_logger(__name__)

# replica pool roles (EngineReplica.role)
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)

# finchat_disagg_fallbacks_total reasons, pre-seeded per replica:
# no_prefill_replica — the prefill pool is empty, drained or all tripped
# prefill_error      — the prefill pass failed or left nothing to export
# import_refused     — the serving replica refused the exported entry
# serving_pool_empty — every decode/mixed replica is down: a prefill replica
#                      took the routed message itself (serve/fleet.py)
FALLBACK_REASONS = ("no_prefill_replica", "prefill_error", "import_refused",
                    "serving_pool_empty")


def parse_roles(spec: str, n: int) -> list[str]:
    """``fleet.roles`` ("prefill,decode,decode,mixed") to one role a
    replica. An empty spec, or one that leaves no serving replica (all
    prefill), gives all-mixed (the latter logged). A short spec pads with
    mixed; a long one is cut."""
    if not spec.strip():
        return [ROLE_MIXED] * n
    roles = [r.strip().lower() or ROLE_MIXED for r in spec.split(",")]
    for r in roles:
        if r not in ROLES:
            raise ValueError(f"fleet.roles: unknown role {r!r} (expected one of {ROLES})")
    roles = (roles + [ROLE_MIXED] * n)[:n]
    if all(r == ROLE_PREFILL for r in roles):
        logger.error("fleet.roles=%r leaves no serving replica; running all replicas mixed "
                     "instead", spec)
        return [ROLE_MIXED] * n
    return roles


class DisaggCoordinator:
    """One a fleet: runs cold prompts on the prefill pool and hands the KV
    to the submitting serving replica before admission."""

    def __init__(self, fleet):
        self.fleet = fleet
        # conversations with a prefill pass in flight: a second turn
        # submitted meanwhile goes on without its own handoff
        self._inflight: set[str] = set()
        self._n_passes = 0

    def prefill_pool(self) -> list:
        """Live prefill replicas that have not given up."""
        return [r for r in self.fleet.live_replicas()
                if getattr(r, "role", ROLE_MIXED) == ROLE_PREFILL
                and not getattr(r.scheduler, "gave_up", False)]

    def _cold_residue(self, sched, conversation_id: str, prompt_ids: list[int]) -> int:
        """Prompt tokens the serving replica would prefill cold: all but the
        last (which decodes) less the deepest page-floored cover of its
        shared heads and session tiers. A disk record counts as whole cover:
        admission restores it locally."""
        page = sched.engine.page_size
        _entry, covered = sched._match_prefix(prompt_ids)
        cache = sched.session_cache
        if cache is not None:
            e = cache.get(conversation_id)
            if e is None:
                if cache.disk is not None and conversation_id in cache.disk:
                    return 0
            else:
                m = min(e.n_tokens, len(prompt_ids) - 1)
                a = np.asarray(e.token_ids[:m], np.int32)
                b = np.asarray(prompt_ids[:m], np.int32)
                neq = np.nonzero(a != b)[0]
                common = int(neq[0]) if neq.size else m
                covered = max(covered, (common // page) * page)
        return len(prompt_ids) - 1 - covered

    async def maybe_prefill(self, sched, prompt_ids: list[int], conversation_id: str,
                            trace_id: str | None = None) -> None:
        """Called by a serving scheduler's ``submit`` before admission.
        Best-effort: every early return leaves the caller on the local
        (mixed) path, and nothing here raises into ``submit``."""
        if sched.session_cache is None:
            return  # no session tier: no wire format for the handoff
        residue = self._cold_residue(sched, conversation_id, prompt_ids)
        if residue < sched.engine.engine_cfg.prefill_chunk:
            return  # under one chunk of cold work: the local prefill is fine
        metrics = sched.metrics
        pool = self.prefill_pool()
        if not pool:
            metrics.inc("finchat_disagg_fallbacks_total", labels={"reason": "no_prefill_replica"})
            return
        if conversation_id in self._inflight:
            return
        self._inflight.add(conversation_id)
        t0 = time.perf_counter()
        try:
            rep = pool[partition_for_key(conversation_id, len(pool))]
            if rep.scheduler is sched:  # attached to a prefill replica by mistake
                return
            payload = await self._prefill_pass(rep, prompt_ids, conversation_id, trace_id)
            if payload is None:
                metrics.inc("finchat_disagg_fallbacks_total", labels={"reason": "prefill_error"})
                return
            # the drain handoff's wire format: a snapshot of the other KV
            # mode or a head that does not re-link is refused (and counted)
            # inside import_session_entry
            try:
                ok = sched.import_session_entry(payload)
            except Exception as e:
                logger.error("disagg: import into %s failed for %s: %s",
                             sched.replica_id, conversation_id, e)
                ok = False
            src = rep.scheduler.session_cache
            if src is not None:
                if ok and src.fabric is not None:
                    # the shared tier: the target's put just refreshed the
                    # record, only the source's RAM copy goes
                    src.drop_local(conversation_id)
                else:
                    # a stale twin could serve diverged KV
                    src.discard(conversation_id)
            if not ok:
                metrics.inc("finchat_disagg_fallbacks_total", labels={"reason": "import_refused"})
                return
            metrics.inc("finchat_disagg_handoffs_total")
            metrics.observe("finchat_disagg_handoff_seconds", time.perf_counter() - t0)
            if TRACER.enabled:
                TRACER.event("disagg_handoff", trace_id, track="fleet",
                             args={"source": rep.replica_id, "target": sched.replica_id,
                                   "tokens": int(len(payload["token_ids"]))})
            logger.info("disagg: prefilled %s on %s, handed %d tokens to %s", conversation_id,
                        rep.replica_id, len(payload["token_ids"]), sched.replica_id)
        except Exception as e:
            logger.error("disagg: handoff for %s failed: %s", conversation_id, e)
            metrics.inc("finchat_disagg_fallbacks_total", labels={"reason": "prefill_error"})
        finally:
            self._inflight.discard(conversation_id)

    async def _prefill_pass(self, rep, prompt_ids: list[int], conversation_id: str,
                            trace_id: str | None) -> dict | None:
        """Run the prompt on the prefill replica and export the retired
        session entry: a greedy submission with ``max_new_tokens=1``, whose
        retirement offloads every page-whole prompt token into the replica's
        session cache (the one generated token is cut by the importer's
        divergence truncation on the real turn)."""
        self._n_passes += 1
        psched = rep.scheduler
        try:
            handle = await psched.submit(
                f"__disagg_{self._n_passes}__", list(prompt_ids),
                SamplingParams(temperature=0.0, max_new_tokens=1),
                conversation_id=conversation_id, trace_id=trace_id,
            )
        except Exception as e:  # backpressure or the length bound on the pool
            logger.warning("disagg: prefill submit on %s refused: %s", rep.replica_id, e)
            return None
        while True:
            ev = await handle.events.get()
            if ev["type"] == "error":
                # a breaker trip mid-pass may have drained the handle to a
                # serving sibling, its session bytes with it: the export
                # below then finds nothing, counted as a fallback
                logger.warning("disagg: prefill pass for %s errored: %s", conversation_id,
                               ev.get("message"))
                break
            if ev["type"] == "done":
                break
        if psched.session_cache is None:
            return None
        return psched.export_session(conversation_id)
