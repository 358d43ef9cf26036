"""The fleet's answered-message dedupe ring and replica states (the part
of the JAX package's ``serve/fleet.py`` that the single-engine app uses).

``EngineFleet`` (several engine replicas behind a conversation-affinity
router) is not ported yet: ``build_app`` refuses ``fleet.replicas`` > 1.
The app takes its dedupe ring from here, as the reference's does, so the
ring's size has one default for the single-engine app and a fleet alike.
"""

from __future__ import annotations

from collections import deque

# replica lifecycle: LIVE (routed to), OUT (breaker gave up; the router
# skips it), RESPAWNING (the supervisor is reviving it; still skipped)
LIVE = "live"
OUT = "out"
RESPAWNING = "respawning"


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
