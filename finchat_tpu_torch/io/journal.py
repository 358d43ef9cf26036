"""Answered-message journal (own copy of the JAX package's ``io/journal.py``;
its files are byte for byte the reference's, and each package replays the
other's).

The at-least-once plane dedupes redelivered ``message_id``s through an
in-memory ring (serve/fleet.py ``DedupeRing``), which dies with the
process; this journal closes the crash-plus-redelivery window:

- ``append(message_id, partition=p)`` writes one checksummed line to the
  partition's file and fsyncs BEFORE the app commits the message's Kafka
  offset (serve/app.py ``_done``). If the process dies between the answer
  and the commit, the redelivered message finds its id in the replayed
  journal and is skipped. The id is appended only after the stream
  completed.
- Failed / shed / timed-out ids are never journaled (the app journals only
  answered ones), so a producer retrying a retryable error is reprocessed.
- ``replay()`` at startup parses the journal files, skipping corrupt
  records (a torn final line after a crash is expected; each skip is
  counted on ``finchat_durability_quarantines_total`` and the rest of the
  file is still honored), compacts the files to the most recent ``keep``
  distinct ids (the dedupe ring's bound) and returns them, oldest first,
  for the caller to seed the ring.

One file per Kafka partition (``answered-p0007.journal``), so journal
ownership follows partition ownership. A legacy single ``answered.journal``
is split into per-partition files on first startup (one-way, logged): each
id lands in the partition ``partition_for_key`` gives its JSON form, which
is where a redelivery of that id is consumed.

Line format: ``v2 <crc32 hex> <seq hex16> <json message_id>\\n``. The CRC
covers ``<seq hex16> <json>``, so a half-written or bit-flipped line never
replays as a different record. ``seq`` is a monotonic per-writer append
stamp (``max(counter, time_ns)``) that interleaves several partition files
by true append order at replay. Legacy ``v1 <crc32 hex> <json>`` lines
still decode, with ``seq=0``, and sort before every v2 line.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from pathlib import Path

from finchat_tpu_torch.utils.faults import inject
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS

logger = get_logger(__name__)

_BAD = object()


def partition_filename(partition: int) -> str:
    return "answered-p%04d.journal" % partition


class AnsweredJournal:
    """Append-only, fsync-before-commit record of answered message ids,
    one file per owned Kafka partition."""

    FILENAME = "answered.journal"  # legacy single-file layout

    def __init__(self, dir_path: str, *, fsync: bool = True, keep: int = 1024,
                 metrics=None, num_partitions: int = 1):
        self.dir = Path(dir_path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.keep = keep
        self.num_partitions = max(1, int(num_partitions))
        self.metrics = metrics if metrics is not None else METRICS
        self._files: dict[int, object] = {}  # partition -> open handle
        # per-writer monotonic append stamp; seeded from the wall clock so
        # stamps stay ordered across restarts too (approximate across
        # hosts, exact per writer — good enough to interleave adopted
        # journals by append order)
        self._seq = 0
        # in-process compaction bound: the ring only ever holds ``keep``
        # ids, so journals much larger than that are pure dead weight
        self._appends_since_compact = 0
        self._migrate_legacy()

    # --- record codec ----------------------------------------------------
    def _next_seq(self) -> int:
        seq = max(self._seq, time.time_ns())
        self._seq = seq + 1
        return seq

    @staticmethod
    def _encode(message_id, seq: int) -> bytes:
        body = b"%016x " % seq + json.dumps(message_id).encode()
        return b"v2 %08x " % zlib.crc32(body) + body + b"\n"

    @staticmethod
    def _decode(line: bytes):
        """``(seq, id)``, or the ``_BAD`` sentinel for a corrupt/torn
        record. v1 lines (no seq stamp) decode with ``seq=0``."""
        parts = line.split(b" ", 2)
        if len(parts) != 3 or parts[0] not in (b"v1", b"v2"):
            return _BAD
        try:
            if int(parts[1], 16) != zlib.crc32(parts[2]):
                return _BAD
            if parts[0] == b"v1":
                return (0, json.loads(parts[2].decode()))
            seq_hex, _, payload = parts[2].partition(b" ")
            if len(seq_hex) != 16 or not payload:
                return _BAD
            return (int(seq_hex, 16), json.loads(payload.decode()))
        except (ValueError, UnicodeDecodeError):
            return _BAD

    # --- file layout ------------------------------------------------------
    def _part_path(self, partition: int) -> Path:
        return self.dir / partition_filename(partition)

    def partitions_on_disk(self) -> list[int]:
        """Partition indices that have a journal file (sorted)."""
        out = []
        for p in self.dir.glob("answered-p*.journal"):
            try:
                out.append(int(p.stem[len("answered-p"):]))
            except ValueError:
                continue
        return sorted(out)

    # --- legacy migration ------------------------------------------------
    def _migrate_legacy(self) -> None:
        """One-way: split a legacy single ``answered.journal`` into
        per-partition files on first startup. Each id is placed where the
        broker's CRC32 partitioner puts its JSON form, so the partition
        that will see the redelivery owns the dedupe line. Stamped with
        fresh increasing seqs in file order (they are the oldest records,
        and order among them is preserved); the legacy file is removed
        only after the split files are durably written."""
        legacy = self.dir / self.FILENAME
        if not legacy.exists():
            return
        try:
            from finchat_tpu_torch.io.kafka import partition_for_key
            records = self._read_file(legacy)
            buckets: dict[int, list] = {}
            for _seq, mid in records:
                part = partition_for_key(json.dumps(mid), self.num_partitions)
                buckets.setdefault(part, []).append((self._next_seq(), mid))
            for part, pairs in sorted(buckets.items()):
                existing = self._read_file(self._part_path(part))
                # existing per-partition lines are NEWER than legacy ones
                self._rewrite(part, pairs + existing)
            os.unlink(legacy)
            logger.info(
                "answered journal: migrated legacy %s (%d record(s)) into "
                "%d per-partition file(s) — one-way", legacy, len(records),
                len(buckets),
            )
        except Exception as e:
            logger.error("answered journal: legacy migration failed "
                         "(will retry next startup): %s", e)

    # --- write path ------------------------------------------------------
    def append(self, message_id, partition: int = 0) -> bool:  # finchat-lint: disable=event-loop-blocking -- fsync-BEFORE-commit IS the at-least-once contract; one ~70-byte line per answered message, journal.fsync=false is the relief valve
        """Durably record an ANSWERED id under its partition's file.
        Best-effort by contract: a failure (disk full, injected
        ``journal.append`` fault) logs and returns False — the answer
        already streamed, and refusing to commit over a journal error
        would wedge the partition; the cost of the miss is one possible
        duplicate answer after a crash, exactly the pre-journal trade."""
        partition = max(0, int(partition))
        try:
            inject("journal.append", message_id=message_id,
                   partition=partition)
            fh = self._files.get(partition)
            if fh is None:
                fh = self._files[partition] = open(self._part_path(partition),
                                                  "ab")
            fh.write(self._encode(message_id, self._next_seq()))
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        except Exception as e:
            logger.error("answered journal: append of %r (p%d) failed: %s",
                         message_id, partition, e)
            self.metrics.inc("finchat_durability_journal_append_failures_total")
            return False
        self.metrics.inc("finchat_durability_journal_appends_total")
        self._appends_since_compact += 1
        if self._appends_since_compact >= 8 * self.keep:
            self._compact()
        return True

    # --- startup / maintenance -------------------------------------------
    def _read_file(self, path: Path) -> list:
        """Parse every intact ``(seq, id)`` in file order; corrupt records
        are skipped and counted (a torn tail after a crash is the normal
        case, a corrupt middle record the injected one)."""
        if not path.exists():
            return []
        pairs: list = []
        corrupt = 0
        for line in path.read_bytes().split(b"\n"):
            if not line:
                continue
            rec = self._decode(line)
            if rec is _BAD:
                corrupt += 1
                continue
            pairs.append(rec)
        if corrupt:
            logger.warning(
                "answered journal: skipped %d corrupt record(s) at %s "
                "(torn tail after a crash is expected; the intact records "
                "still replay)", corrupt, path,
            )
            self.metrics.inc("finchat_durability_quarantines_total", corrupt)
        return pairs

    @staticmethod
    def _last_distinct(pairs: list, keep: int) -> list:
        """Most recent ``keep`` distinct ``(seq, id)``s, oldest-first (a
        re-answered retry's LATEST append wins its slot, matching ring
        recency). ``pairs`` must already be in merged append order."""
        seen: dict = {}
        for i, (_seq, mid) in enumerate(pairs):
            seen[json.dumps(mid)] = i
        order = sorted(seen.values())[-keep:]
        return [pairs[i] for i in order]

    def _scan(self, partitions: list[int]) -> dict[int, list]:
        """One read pass: ``{partition: [(seq, id)]}`` intact records
        (corrupt-line counting happens exactly once per file per scan)."""
        return {p: self._read_file(self._part_path(p)) for p in partitions}

    @staticmethod
    def _merged(per_part: dict[int, list]) -> list:
        """The scanned records interleaved by the seq stamp into true
        append order (stable: equal seqs — every v1 line — keep
        per-partition file order, grouped by partition)."""
        pairs: list = []
        for part in sorted(per_part):
            pairs.extend(per_part[part])
        pairs.sort(key=lambda rec: rec[0])
        return pairs

    def _rewrite(self, partition: int, pairs: list) -> None:  # finchat-lint: disable=event-loop-blocking -- compaction rewrites <= keep (~1024) 70-byte lines once per 8*keep appends; amortized microseconds per answer, and the fsync-before-commit ordering must hold through it
        path = self._part_path(partition)
        tmp = path.with_suffix(".tmp")
        fh = self._files.pop(partition, None)
        if fh is not None:
            fh.close()
        with open(tmp, "wb") as f:
            for seq, mid in pairs:
                f.write(self._encode(mid, seq))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _compact(self, partitions: list[int] | None = None,
                 per_part: dict[int, list] | None = None) -> None:
        """Compact the given partitions (default: the ones this instance
        has written — never a partition some OTHER host owns) down to the
        globally most recent ``keep`` distinct ids. ``per_part`` lets a
        caller that already scanned the files (replay) skip the re-read."""
        try:
            parts = sorted(self._files) if partitions is None else partitions
            if not parts:
                return
            if per_part is None:
                per_part = self._scan(parts)
            survivors = self._last_distinct(self._merged(per_part), self.keep)
            live_keys = {json.dumps(mid) for _seq, mid in survivors}
            for part in parts:
                self._rewrite(part, [rec for rec in per_part.get(part, [])
                                     if json.dumps(rec[1]) in live_keys])
            self._appends_since_compact = 0
        except Exception as e:
            logger.error("answered journal: compaction failed: %s", e)

    def replay(self, partitions: list[int] | None = None,
               compact: bool = True) -> list:
        """The most recent ``keep`` distinct answered ids of the given
        partitions (default: every partition file on disk), oldest-first
        in true cross-file append order — seed them into the dedupe ring
        in order so ring recency matches journal recency. Startup callers
        leave ``compact=True`` (drops aged-out ids and the torn tail);
        partition ADOPTION passes ``compact=False`` — the adopter reads
        journals it is only just inheriting and must not rewrite them
        while the ownership handoff races."""
        parts = self.partitions_on_disk() if partitions is None else sorted(partitions)
        per_part = self._scan(parts)
        survivors = self._last_distinct(self._merged(per_part), self.keep)
        if survivors:
            self._seq = max(self._seq, survivors[-1][0] + 1)
        if compact:
            self._compact(parts, per_part)
        ids = [mid for _seq, mid in survivors]
        if ids:
            self.metrics.inc("finchat_durability_journal_replayed_total",
                             len(ids))
            logger.info("answered journal: replayed %d answered message "
                        "id(s) from %d partition file(s) into the dedupe "
                        "ring", len(ids), len(parts))
        return ids

    def close(self) -> None:
        for fh in self._files.values():
            fh.close()
        self._files.clear()
