"""The fleet's warm-state fabric: one shared session tier, a holder index
and the shared prompt heads' KV (the JAX package's engine/warm_fabric.py).

Without it each replica keeps its own ``replica-<id>`` session directory,
prefills the system prompt on its own device state, and route-time
migration finds a sibling's deeper entry by scanning every replica. The
bytes are device-independent (``export_entry`` is the wire format), so the
fabric makes warm state a resource of the fleet:

- **One backing store**: ONE ``SessionDiskTier`` (one directory, one
  write-behind worker) in place of the per-replica subdirectories. Every
  replica's session cache writes through to it and restores from it, so any
  replica resumes any conversation warm through the ordinary RAM-miss, disk
  restore path, even one it never saw. Its durability metrics are labeled
  ``replica="fabric"``.
- **A holder index**: ``note`` / ``forget`` / ``holder`` track which
  replica's RAM cache holds each session key and how deep, so the router's
  deeper-entry-wins migration (serve/fleet.py) is one lookup, and the
  source's RAM copy is dropped without deleting the shared record the
  target just refreshed (``SessionKVCache.drop_local``).
- **Shared prompt heads**: the first replica to prefill a registered head
  snapshots its pages (``engine.offload_pages``) into the fabric, keyed by a
  SHA-1 of the head's token ids as int32 bytes (the same key in both
  packages, so one fabric directory serves either). Every later
  registration of the head (sibling replicas at boot, a respawned replica)
  restores the pages with one scatter (``engine.restore_pages``) instead of
  the prefill: the system prompt's prefill is paid once a fleet.

Hits, misses and refusals are counted by the callers (the scheduler's
``register_prefix`` and ``_restore_session_from_disk``) on their replica's
metrics view; the fabric is passive storage, and a disk record of the other
KV mode is refused by the tier itself, counted on
``finchat_quant_dequant_fallbacks_total{replica="fabric"}``.

Head snapshots are published on the synchronous ``register_prefix`` only;
``register_prefix_async`` restores from the fabric but never writes it (its
chunked job fills the pages piece by piece, and a partial snapshot would be
garbage).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from finchat_tpu_torch.engine.session_cache import SessionDiskTier
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS

logger = get_logger(__name__)

# the key prefix of a head's record: apart from conversation ids, which are
# user-derived and could otherwise collide
_HEAD_NS = "__fabric_head__"

# head snapshots kept in RAM a process (LRU): a fleet registers a handful of
# heads, so this bounds churn, it is no budget
_HEAD_RAM_CAP = 32


def head_key(ids: list[int]) -> str:
    """The fabric key of a shared prompt head: a hash of its token ids as
    int32 bytes. The ids are the deterministic tokenization of the rendered
    chat prefix, so equal prefixes give equal keys across replicas,
    restarts and packages."""
    raw = np.asarray(ids, np.int32).tobytes()
    return _HEAD_NS + hashlib.sha1(raw).hexdigest()


class WarmFabric:
    """One a process; every replica's scheduler holds it."""

    def __init__(self, path: str, budget_bytes: int, kv_quant: str = ""):
        # the one shared tier every replica spills to and restores from
        self.tier = SessionDiskTier(path, budget_bytes, metrics=METRICS.labeled(replica="fabric"),
                                    kv_quant=kv_quant)
        # session key -> (replica id, tokens): which replica's RAM cache
        # holds the key, and how deep (SessionKVCache's put and drop keep it)
        self._index: dict[str, tuple[str, int]] = {}
        # head key -> its host snapshot (offload_pages' tuple)
        self._heads: OrderedDict[str, tuple] = OrderedDict()
        # the replicas share one event loop, but the tier's writer and the
        # rebuild threads exist: a cheap lock, never held across I/O
        self._lock = threading.Lock()

    # --- session index ---------------------------------------------------
    def note(self, key: str, replica_id: str | None, n_tokens: int) -> None:
        """``replica_id``'s RAM cache now holds ``key`` at ``n_tokens``
        (the last writer wins: puts replace)."""
        if replica_id is None:
            return
        with self._lock:
            self._index[key] = (replica_id, int(n_tokens))

    def forget(self, key: str, replica_id: str | None) -> None:
        """Clear ``key``'s entry if ``replica_id`` still holds it: a
        migration's source dropping its copy cannot erase the target's
        fresher claim (the target's put noted first)."""
        with self._lock:
            cur = self._index.get(key)
            if cur is not None and cur[0] == replica_id:
                del self._index[key]

    def holder(self, key: str) -> tuple[str, int] | None:
        """(replica id, tokens) of the RAM holder, or None."""
        with self._lock:
            return self._index.get(key)

    # --- shared prompt heads ---------------------------------------------
    def load_head(self, ids: list[int]) -> tuple | None:
        """The head's host KV snapshot, or None (a miss). RAM first; a disk
        record is trusted only when it carries exactly these token ids (a
        hash collision or a truncated record). A record of the other KV mode
        is refused by the tier (counted there); the caller checks a RAM
        hit's mode."""
        key = head_key(ids)
        with self._lock:
            snap = self._heads.get(key)
            if snap is not None:
                self._heads.move_to_end(key)
                return snap
        if key not in self.tier:
            return None
        payload = self.tier.load(key)
        if payload is None or payload["snap"] is None:
            return None
        if not np.array_equal(payload["token_ids"], np.asarray(ids, np.int32)):
            logger.warning("warm fabric: head record %s carries different token ids; ignoring",
                           key)
            return None
        snap = payload["snap"]
        self._keep_head(key, snap)
        return snap

    def store_head(self, ids: list[int], snap: tuple | None) -> None:
        """Publish a freshly prefilled head's snapshot to the fleet: RAM for
        the replicas of this process, a write-behind record for restarts and
        for a replica whose RAM copy aged out."""
        if snap is None:
            return
        key = head_key(ids)
        self._keep_head(key, snap)
        # prefix_len 0: the head's snapshot is the whole record (no shared
        # head below it); no gap, heads are clamped to the sink already
        self.tier.spill(key, np.asarray(ids, np.int32), 0, snap)

    def _keep_head(self, key: str, snap: tuple) -> None:
        with self._lock:
            self._heads[key] = snap
            self._heads.move_to_end(key)
            while len(self._heads) > _HEAD_RAM_CAP:
                self._heads.popitem(last=False)

    # --- lifecycle -------------------------------------------------------
    def flush(self) -> None:
        self.tier.flush()

    def close(self) -> None:
        self.tier.close()
