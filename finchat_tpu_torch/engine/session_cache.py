"""Session KV cache: a byte-budgeted host-RAM tier, with a disk tier below
it, for resuming a conversation's next turn from its own KV pages (the JAX
package's ``engine/session_cache.py``, ported).

- OFFLOAD: when a sequence retires normally (eos/length), the scheduler
  snapshots its KV pages to the host (``InferenceEngine.offload_pages``)
  BEFORE the pages are freed, keyed by ``conversation_id``.
- RESUME: when the conversation's next turn arrives, admission matches the
  new prompt against the stored token stream (longest common token prefix,
  floored to whole pages), allocates fresh pages, copies the matched pages
  back (``InferenceEngine.restore_pages``) and starts prefill at the
  matched offset.
- DIVERGENCE TRUNCATION: a turn whose history was edited matches only up to
  the divergence point, and the entry is cut there, so stale KV is never
  served.
- COMPOSITION with the shared-prefix cache: an entry whose sequence rode a
  refcounted shared head (scheduler ``_PrefixEntry``) records those pages BY
  REFERENCE, holding a reference so retirement cannot free them, and
  snapshots only the sequence's OWN pages.
- LRU under a byte budget: host bytes are the sum of the entries' snapshot
  bytes; inserting past ``budget_bytes`` evicts the least recently used
  conversations first.
- DISK TIER: with ``session_cache_disk_path`` set, every stored entry is
  also written through to a checksummed, versioned record file (FSKV v2,
  atomic write and rename), the disk tier keeps its own byte-budgeted LRU,
  and a RAM miss at admission falls through to disk (scheduler
  ``_restore_session_from_disk``). A corrupt or truncated record is
  quarantined and the conversation starts cold.

Snapshots are tuples ``(k, v, k_scales | None, v_scales | None)`` of CPU
tensors, each ``[L, n_pages, ...]`` (``kv_cache.gather_pages_host``); a bf16
snapshot is a ``torch.bfloat16`` tensor. A record holds the same bytes, in
the same format, as the JAX package's, so each package reads the other's.

The cache never owns device pages: snapshots are host copies taken while
the retiring sequence still owns its pages, and restores write into pages
freshly allocated to the admitted sequence. The only device pages an entry
points at are a shared head's, owned by their ``__prefix_*__`` owner and
protected by the entry's reference.

The disk tier's fault sites are the reference's: ``disk.spill`` (a failed
record write is logged and counted, and never fails the retiring stream)
and ``disk.restore`` (a failed read quarantines the record and the
conversation starts cold).

- BOUNDED KV: an entry written under a bounded policy carries ``kv_gap``
  (the evicted tokens) and ``kv_sink``; its snapshot holds only the
  surviving pages while ``token_ids`` spans the absolute range. It resumes
  whole when the prompt extends past its span unchanged, or on divergence
  salvages the pre-gap sink region as an ordinary gap-free prefix.

- THE WARM-STATE FABRIC (engine/warm_fabric.py): with ``fabric`` set, the
  cache's ``disk`` is the fleet's one shared tier, and the cache keeps the
  fabric's holder index current: ``put`` notes this replica as the key's
  RAM holder, a drop forgets it (holder-guarded), and ``drop_local`` drops
  the RAM copy only, leaving the shared record a migration's target just
  refreshed.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from finchat_tpu_torch.utils.faults import inject
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS
from finchat_tpu_torch.utils.tracing import TRACER

logger = get_logger(__name__)

# Cache-key convention: an agent keys each LLM role's entry separately (the
# two roles render different prompts for one conversation), and routing maps
# any such key back to its conversation.
SESSION_KEY_ROLES = ("tool", "resp")


def session_key(conversation_id: str, role: str) -> str:
    """The session-cache key for one LLM role of a conversation."""
    return f"{conversation_id}#{role}"


def conversation_of(key: str) -> str:
    """Inverse of :func:`session_key`: the conversation a cache key belongs
    to. Keys without a recognised role suffix are their own conversation."""
    base, sep, role = key.rpartition("#")
    return base if sep and role in SESSION_KEY_ROLES else key


def snap_kv_mode(snap: tuple | None) -> str:
    """The KV quant mode a snapshot was taken under: "int8" when it carries
    scale planes, "" (native dtype) otherwise. ``None`` snapshots
    (prefix-only entries) restore under either mode."""
    if snap is None or len(snap) < 3 or snap[2] is None:
        return ""
    return "int8"


def _dtype_name(dt: torch.dtype) -> str:
    """A dtype's serializable name: 'bfloat16', 'float32', 'int8' — the
    names the JAX package's records carry."""
    return str(dt).removeprefix("torch.")


def resolve_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`_dtype_name`, also accepting version-1 records'
    numpy dtype strings ('<f4' etc.). An unknown name raises ValueError
    (the caller quarantines the record)."""
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return torch.from_numpy(np.empty(0, np.dtype(name))).dtype
    except (TypeError, ValueError) as e:
        raise ValueError(f"unknown record dtype {name!r}") from e


def _snap_nbytes(snap: tuple | None) -> int:
    if snap is None:
        return 0
    return sum(a.numel() * a.element_size() for a in snap if a is not None)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's raw bytes in C order (bf16 included: numpy has no
    bf16, so the bytes go through a uint8 view)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _head(a: torch.Tensor, n_pages: int) -> torch.Tensor:
    """The first ``n_pages`` pages of a snapshot plane as a compact copy: a
    view would pin the whole buffer."""
    return a[:, :n_pages].clone(memory_format=torch.contiguous_format)


def concat_snaps(head: tuple | None, n_head_pages: int, tail: tuple | None) -> tuple | None:
    """The first ``n_head_pages`` pages of ``head`` followed by all of
    ``tail``: the incremental-offload splice (a retiring turn reuses the
    previous entry's host bytes for pages it restored and never rewrote).
    Always copies, so the result never aliases the soon-dropped head."""
    if n_head_pages == 0 or head is None:
        return tail
    if tail is None:
        return tuple(_head(a, n_head_pages) if a is not None else None for a in head)
    return tuple(
        torch.cat([a[:, :n_head_pages], b], dim=1) if a is not None else None
        for a, b in zip(head, tail)
    )


def _slice_snap(snap: tuple | None, n_pages: int) -> tuple | None:
    """First ``n_pages`` pages of a snapshot, compacted so truncation really
    releases host RAM."""
    if snap is None or n_pages == 0:
        return None
    return tuple(_head(a, n_pages) if a is not None else None for a in snap)


class SessionDiskTier:
    """Byte-budgeted LRU of session-KV record files under one directory.

    Record format (version 2; version 1 records stay readable):

        b"FSKV" | u8 version | u32 header_len | header JSON | payload

    The header carries the cache key, ``prefix_len``, the array specs
    (dtype by name and shape per array; a shared head's device pages are
    never stored, so a restore re-links against the restoring scheduler's
    own live head), the snapshot's KV quant mode (``kv``), the bounded-KV
    fields ``kv_gap``/``kv_sink``, the payload length and a CRC32 of the
    payload. Writes go to a ``.tmp`` sibling, fsync, then ``os.replace``:
    a record is whole or absent. Any read-side anomaly (bad magic, version,
    truncation, CRC mismatch) QUARANTINES the file (``*.quarantine``) and
    the conversation starts cold.

    A tier constructed with ``kv_quant`` refuses records whose snapshot was
    taken under the other page-pool dtype: they are set aside as
    ``*.crossmode`` (valid, just for another serving mode), counted on
    ``finchat_quant_dequant_fallbacks_total``, and the conversation starts
    cold. The startup sweep applies the same check.

    Startup sweeps the directory: ``.tmp`` orphans are deleted, records
    whose header or size do not parse are quarantined, and the rest rebuild
    the key index (LRU-ordered by mtime).

    Writes are WRITE-BEHIND: ``spill`` and ``discard`` enqueue onto ONE
    worker thread (FIFO, so a discard can never be overtaken by an older
    write of the same key) and return at once. Snapshot tensors are never
    mutated in place (truncation replaces them), so they are safe to hand
    across. ``load`` barriers on a queued write of its own key, and
    ``flush`` drains the queue. A closed tier (``close``) writes inline.

    The bounded-KV fields carry the entry's gap and sink, so a gapped
    record reads back as it was written (an unbounded scheduler refuses it
    at import).
    """

    MAGIC = b"FSKV"
    VERSION = 2
    READABLE_VERSIONS = (1, 2)
    SUFFIX = ".skv"

    def __init__(self, path: str, budget_bytes: int, metrics=None, kv_quant: str = ""):
        if budget_bytes <= 0:
            raise ValueError("session disk tier needs a positive byte budget")
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.budget_bytes = budget_bytes
        self.kv_quant = kv_quant
        self.metrics = metrics if metrics is not None else METRICS
        # key -> (filename, nbytes), LRU order (oldest first); guarded by
        # _lock, the writer thread updates it as records land
        self._index: OrderedDict[str, tuple[str, int]] = OrderedDict()
        self._resident = 0
        # key -> queued operations: the index holds only LANDED records, so
        # membership must also see queued writes
        self._pending: dict[str, int] = {}
        self._lock = threading.Lock()
        self._writer: ThreadPoolExecutor | None = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="skv-spill")
        self._sweep()

    # --- introspection ---------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._index or key in self._pending

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def _publish_gauges(self) -> None:
        self.metrics.set_gauge("finchat_durability_disk_resident_bytes", self._resident)
        self.metrics.set_gauge("finchat_durability_disk_entries", len(self._index))

    @staticmethod
    def _fname(key: str) -> str:
        # the key is user-derived: hash it so it cannot escape the directory
        return hashlib.sha1(key.encode()).hexdigest() + SessionDiskTier.SUFFIX

    # --- record (de)serialization ---------------------------------------
    @staticmethod
    def _serialize(key: str, token_ids: np.ndarray, prefix_len: int,
                   snap: tuple | None, kv_gap: int = 0, kv_sink: int = 0) -> bytes:
        token_ids = np.ascontiguousarray(token_ids, np.int32)
        chunks = [token_ids.tobytes()]
        specs: list[dict | None] | None = None
        if snap is not None:
            specs = []
            for a in snap:
                if a is None:
                    specs.append(None)
                    continue
                specs.append({"dtype": _dtype_name(a.dtype), "shape": list(a.shape)})
                chunks.append(_tensor_bytes(a))
        payload = b"".join(chunks)
        header = json.dumps({
            "key": key,
            "prefix_len": int(prefix_len),
            "n_tokens": int(token_ids.shape[0]),
            "snap": specs,
            "kv": snap_kv_mode(snap),
            "kv_gap": int(kv_gap),
            "kv_sink": int(kv_sink),
            "payload_len": len(payload),
            "crc": zlib.crc32(payload),
        }).encode()
        return (SessionDiskTier.MAGIC + bytes([SessionDiskTier.VERSION])
                + len(header).to_bytes(4, "big") + header + payload)

    @staticmethod
    def _read_header(raw: bytes) -> tuple[dict, int]:
        """(header, payload offset); raises ValueError on any anomaly."""
        if raw[:4] != SessionDiskTier.MAGIC:
            raise ValueError("bad magic")
        if raw[4] not in SessionDiskTier.READABLE_VERSIONS:
            raise ValueError(f"unknown record version {raw[4]}")
        hlen = int.from_bytes(raw[5:9], "big")
        header = json.loads(raw[9 : 9 + hlen].decode())
        off = 9 + hlen
        if len(raw) - off != header["payload_len"]:
            raise ValueError("truncated record")
        return header, off

    @staticmethod
    def _header_kv_mode(header: dict) -> str:
        """A record's KV quant mode: the v2 ``kv`` stamp, or (v1 records)
        whether scale-plane specs are present."""
        if "kv" in header:
            return header["kv"]
        specs = header.get("snap")
        if specs and len(specs) > 2 and specs[2] is not None:
            return "int8"
        return ""

    @staticmethod
    def _deserialize(raw: bytes) -> dict:
        header, off = SessionDiskTier._read_header(raw)
        # one writable copy of the payload: every snapshot tensor is a view
        # of it (torch.frombuffer keeps the buffer alive)
        payload = bytearray(memoryview(raw)[off:])
        if zlib.crc32(payload) != header["crc"]:
            raise ValueError("payload checksum mismatch")
        n = header["n_tokens"]
        token_ids = np.frombuffer(payload, np.int32, count=n)
        pos = n * 4
        snap = None
        if header["snap"] is not None:
            arrs: list[torch.Tensor | None] = []
            for spec in header["snap"]:
                if spec is None:
                    arrs.append(None)
                    continue
                dt = resolve_dtype(spec["dtype"])
                count = int(np.prod(spec["shape"])) if spec["shape"] else 1
                if count == 0:
                    arrs.append(torch.empty(spec["shape"], dtype=dt))
                    continue
                arrs.append(torch.frombuffer(payload, dtype=dt, count=count, offset=pos)
                            .reshape(spec["shape"]))
                pos += count * torch.empty((), dtype=dt).element_size()
            snap = tuple(arrs)
        return {
            "conversation_id": header["key"],
            "token_ids": token_ids,
            "prefix_len": int(header["prefix_len"]),
            "snap": snap,
            "kv_gap": int(header.get("kv_gap", 0)),
            "kv_sink": int(header.get("kv_sink", 0)),
        }

    # --- write path ------------------------------------------------------
    def spill(self, key: str, token_ids: np.ndarray, prefix_len: int,
              snap: tuple | None, kv_gap: int = 0, kv_sink: int = 0) -> bool:
        """Record one entry (atomic write and rename), then LRU-evict records
        past the byte budget. Write-behind: the work runs on the writer
        thread and this returns at once (True = accepted); a failed write
        logs and counts on ``finchat_durability_spill_failures_total`` —
        serving never fails, and never waits, on durability I/O."""
        if self._writer is not None:
            with self._lock:
                self._pending[key] = self._pending.get(key, 0) + 1
            self._writer.submit(self._write_record, key, token_ids, prefix_len, snap, kv_gap,
                                kv_sink)
            return True
        return self._write_record(key, token_ids, prefix_len, snap, kv_gap, kv_sink)

    def _unpend_locked(self, key: str) -> None:
        n = self._pending.get(key, 0) - 1
        if n <= 0:
            self._pending.pop(key, None)
        else:
            self._pending[key] = n

    def _unpend(self, key: str) -> None:
        """One queued operation for ``key`` finished (landed or failed)."""
        with self._lock:
            self._unpend_locked(key)

    def _write_record(self, key: str, token_ids: np.ndarray, prefix_len: int,
                      snap: tuple | None, kv_gap: int = 0, kv_sink: int = 0) -> bool:
        """The writer thread's body (inline once the tier is closed)."""
        fname = self._fname(key)
        final = self.path / fname
        tmp = self.path / (fname + ".tmp")
        try:
            inject("disk.spill", key=key)
            blob = self._serialize(key, token_ids, prefix_len, snap, kv_gap, kv_sink)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except Exception as e:  # durability is best-effort: log, count, go on
            logger.error("session disk tier: spill of %s failed: %s", key, e)
            self.metrics.inc("finchat_durability_spill_failures_total")
            tmp.unlink(missing_ok=True)
            self._unpend(key)
            return False
        victims: list[tuple[str, str, int]] = []
        with self._lock:
            old = self._index.pop(key, None)
            if old is not None:
                self._resident -= old[1]
            self._index[key] = (fname, len(blob))
            self._resident += len(blob)
            self._unpend_locked(key)
            while self._resident > self.budget_bytes and len(self._index) > 1:
                victim_key, (victim_fname, victim_bytes) = next(iter(self._index.items()))
                del self._index[victim_key]
                self._resident -= victim_bytes
                victims.append((victim_key, victim_fname, victim_bytes))
        self.metrics.inc("finchat_durability_spills_total")
        self.metrics.inc("finchat_durability_spilled_bytes_total", len(blob))
        for victim_key, victim_fname, victim_bytes in victims:
            (self.path / victim_fname).unlink(missing_ok=True)
            self.metrics.inc("finchat_durability_disk_evictions_total")
            logger.debug("session disk tier: evicted %s (LRU, %d bytes)",
                         victim_key, victim_bytes)
        self._publish_gauges()
        return True

    def discard(self, key: str) -> None:
        """Drop a key's record. Rides the writer queue (FIFO), so an older
        queued write of the same key cannot overtake it."""
        if self._writer is not None:
            with self._lock:
                self._pending[key] = self._pending.get(key, 0) + 1
            self._writer.submit(self._discard_now, key)
        else:
            self._discard_now(key)

    def _discard_now(self, key: str) -> None:
        with self._lock:
            entry = self._index.pop(key, None)
            if entry is not None:
                self._resident -= entry[1]
        self._unpend(key)
        if entry is not None:
            (self.path / entry[0]).unlink(missing_ok=True)
            self._publish_gauges()

    def flush(self) -> None:
        """Wait for every queued write and discard to land. The single
        worker makes one no-op submission a full drain."""
        if self._writer is not None:
            self._writer.submit(lambda: None).result()  # finchat-lint: disable=event-loop-blocking -- FIFO barrier by contract: reached only from the graceful drain (which must leave the tier durable) and the per-key pending-write restore gate

    def close(self) -> None:
        if self._writer is not None:
            self._writer.shutdown(wait=True)
            self._writer = None

    # --- read path -------------------------------------------------------
    def load(self, key: str) -> dict | None:
        """Read, verify and decode one record: an ``export_entry``-shaped
        payload, or None (absent or set aside). A hit refreshes LRU
        recency; the record stays on disk."""
        with self._lock:
            pending = key in self._pending
        if pending:
            # barrier only when THIS key has a queued operation
            self.flush()
        with self._lock:
            entry = self._index.get(key)
        if entry is None:
            return None
        try:
            inject("disk.restore", key=key)
            raw = (self.path / entry[0]).read_bytes()
            header, _off = self._read_header(raw)
            if header.get("snap") and self._header_kv_mode(header) != self.kv_quant:
                self._refuse_crossmode(key, self._header_kv_mode(header))
                return None
            payload = self._deserialize(raw)
            if payload["conversation_id"] != key:
                raise ValueError("record key mismatch")
        except Exception as e:  # any unreadable record: quarantine, start cold
            logger.error("session disk tier: record for %s unreadable (%s); quarantining — "
                         "conversation cold-starts", key, e)
            self._quarantine(key)
            return None
        with self._lock:
            if key in self._index:
                self._index.move_to_end(key)
        return payload

    def _refuse_crossmode(self, key: str, record_mode: str, fname: str | None = None) -> None:
        """Set aside a valid record written under the OTHER KV quant mode
        (``*.crossmode``, counted as a dequant fallback)."""
        with self._lock:
            entry = self._index.pop(key, None)
            if entry is not None:
                fname, nbytes = entry
                self._resident -= nbytes
        if fname is not None:
            src = self.path / fname
            try:
                os.replace(src, self.path / (fname + ".crossmode"))
            except OSError:
                src.unlink(missing_ok=True)
        logger.warning("session disk tier: record for %s was written under kv_quant=%r, this "
                       "engine serves kv_quant=%r; set aside — conversation cold-starts",
                       key, record_mode, self.kv_quant)
        self.metrics.inc("finchat_quant_dequant_fallbacks_total")
        self._publish_gauges()

    def _quarantine(self, key: str, fname: str | None = None) -> None:
        with self._lock:
            entry = self._index.pop(key, None)
            if entry is not None:
                fname, nbytes = entry
                self._resident -= nbytes
        if fname is not None:
            src = self.path / fname
            try:
                os.replace(src, self.path / (fname + ".quarantine"))
            except OSError:
                src.unlink(missing_ok=True)
        self.metrics.inc("finchat_durability_quarantines_total")
        # a corrupt record is silent data loss to the client (a cold
        # resume): the flight recorder keeps which key, when, and what the
        # serving plane was doing
        TRACER.anomaly("record_quarantine", args={"key": key, "file": fname})
        self._publish_gauges()

    # --- startup ---------------------------------------------------------
    def _sweep(self) -> None:
        """Rebuild the index from the directory: delete ``.tmp`` orphans,
        quarantine records whose header or size do not parse (the CRC is
        checked at load), set aside records of the other KV mode, index the
        rest LRU-ordered by mtime."""
        found: list[tuple[float, str, str, int]] = []  # (mtime, key, fname, nbytes)
        for p in self.path.iterdir():
            name = p.name
            if name.endswith(".tmp"):
                p.unlink(missing_ok=True)  # an orphaned partial write
                continue
            if not name.endswith(self.SUFFIX):
                continue  # set aside, or a foreign file
            try:
                with open(p, "rb") as f:
                    head = f.read(9)
                    if head[:4] != self.MAGIC or head[4] not in self.READABLE_VERSIONS:
                        raise ValueError("bad magic/version")
                    hlen = int.from_bytes(head[5:9], "big")
                    header = json.loads(f.read(hlen).decode())
                size = p.stat().st_size
                if size != 9 + hlen + header["payload_len"]:
                    raise ValueError("size mismatch")
                if header.get("snap") and self._header_kv_mode(header) != self.kv_quant:
                    self._refuse_crossmode(header["key"], self._header_kv_mode(header),
                                           fname=name)
                    continue
                found.append((p.stat().st_mtime, header["key"], name, size))
            except Exception as e:  # any unparsable record: quarantine it
                logger.error("session disk tier: sweeping out bad record %s (%s)", name, e)
                try:
                    os.replace(p, self.path / (name + ".quarantine"))
                except OSError:
                    p.unlink(missing_ok=True)
                self.metrics.inc("finchat_durability_quarantines_total")
        for _mtime, key, fname, nbytes in sorted(found):
            self._index[key] = (fname, nbytes)
            self._resident += nbytes
        if self._index:
            logger.info("session disk tier: %d resumable records (%d bytes) at %s",
                        len(self._index), self._resident, self.path)
        self._publish_gauges()


@dataclass
class SessionEntry:
    """One retired conversation's resumable KV.

    ``token_ids`` holds the tokens whose KV the entry covers — a whole-page
    multiple, split as ``[0, prefix_len)`` in the referenced shared-prefix
    pages and ``[prefix_len, n_tokens)`` in the host snapshot.
    ``prefix_entry`` (a scheduler ``_PrefixEntry`` or None) carries one
    reference held for the entry's lifetime; the cache's ``on_drop``
    callback releases it.

    ``kv_gap`` (bounded KV): tokens the eviction policy dropped between the
    pinned sink (``kv_sink`` absolute tokens) and the surviving window when
    the sequence retired. The snapshot then covers only the surviving
    pages, ``n_tokens - kv_gap - prefix_len`` tokens, while ``token_ids``
    spans the absolute range (the evicted tokens' ids must match the next
    turn's prompt for the surviving KV to be valid). Such an entry resumes
    whole when the prompt extends past its span unchanged; on divergence
    the windowed remainder is unusable (it attended to the mismatched
    history), and ``match`` salvages at most the pre-gap sink region as an
    ordinary gap-free prefix.
    """

    conversation_id: str
    token_ids: np.ndarray  # int32 [n_tokens]
    prefix_entry: Any | None = None
    prefix_pages: list[int] = field(default_factory=list)  # device page ids, referenced
    prefix_len: int = 0  # tokens covered by prefix_pages (page multiple)
    snap: tuple | None = None  # host pages covering [prefix_len, n_tokens)
    kv_gap: int = 0  # bounded-KV evicted tokens (page multiple; 0 = exact)
    # the absolute position the gap starts at (the sink's end; a page
    # multiple): tokens below it attended only earlier sink tokens, so they
    # stay a valid prefix when the windowed remainder is stale. 0 when
    # kv_gap is 0
    kv_sink: int = 0

    @property
    def n_tokens(self) -> int:
        return len(self.token_ids)

    @property
    def nbytes(self) -> int:
        return _snap_nbytes(self.snap)

    def own_pages_for(self, matched: int, page_size: int) -> int:
        """How many snapshot pages a ``matched``-token resume restores (the
        evicted gap has no pages)."""
        return max(0, matched - self.prefix_len - self.kv_gap) // page_size


class SessionKVCache:
    """Host-RAM LRU of ``SessionEntry`` keyed by conversation id.

    Single-task by design (the scheduler loop is the only caller), so no
    locking; the byte budget counts host snapshot bytes only — referenced
    shared-prefix pages live on the device under their own owner.
    """

    def __init__(self, budget_bytes: int, page_size: int,
                 on_drop: Callable[[SessionEntry], None] | None = None,
                 metrics=None, disk: SessionDiskTier | None = None,
                 fabric=None, fabric_replica: str | None = None):
        if budget_bytes <= 0 or page_size <= 0:
            raise ValueError("session cache needs a positive byte budget and page size")
        self.budget_bytes = budget_bytes
        self.page_size = page_size
        self._on_drop = on_drop
        self.metrics = metrics if metrics is not None else METRICS
        # entries write THROUGH to the disk tier at put; None = RAM only
        self.disk = disk
        # the warm-state fabric: ``disk`` is then its shared tier, and puts
        # and drops keep its holder index (which replica's RAM holds a key,
        # how deep) current for the router's migration lookup
        self.fabric = fabric
        self.fabric_replica = fabric_replica
        self._entries: OrderedDict[str, SessionEntry] = OrderedDict()
        self._resident_bytes = 0
        self._publish_gauges()

    # --- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    def get(self, conversation_id: str) -> SessionEntry | None:
        return self._entries.get(conversation_id)

    def _publish_gauges(self) -> None:
        self.metrics.set_gauge("finchat_session_cache_resident_bytes", self._resident_bytes)
        self.metrics.set_gauge("finchat_session_cache_entries", len(self._entries))

    # --- write path ------------------------------------------------------
    def put(self, entry: SessionEntry, *, spill: bool = True) -> bool:
        """Insert (replacing any previous entry for the conversation), then
        LRU-evict others until the byte budget holds. Returns False — and
        drops nothing from RAM — when the entry alone exceeds the budget.
        With a disk tier the entry writes through either way (an
        over-budget entry stays resumable from disk, trimmed by
        ``fit_payload``). ``spill=False`` is the disk-restore path: the
        bytes just came off that record."""
        if spill:
            self._spill(entry)
        if entry.nbytes > self.budget_bytes:
            logger.warning("session cache: entry for %s (%d bytes) exceeds budget %d; "
                           "not stored", entry.conversation_id, entry.nbytes, self.budget_bytes)
            return False
        old = self._entries.pop(entry.conversation_id, None)
        if old is not None:
            self._drop(old)
        self._entries[entry.conversation_id] = entry
        self._resident_bytes += entry.nbytes
        while self._resident_bytes > self.budget_bytes:
            victim_id, victim = next(iter(self._entries.items()))
            del self._entries[victim_id]
            self._drop(victim)
            self.metrics.inc("finchat_session_cache_evictions_total")
            logger.debug("session cache: evicted %s (LRU, %d bytes)", victim_id, victim.nbytes)
        if self.fabric is not None and entry.conversation_id in self._entries:
            # the insert itself may have been evicted by the LRU pass
            self.fabric.note(entry.conversation_id, self.fabric_replica, entry.n_tokens)
        self._publish_gauges()
        return True

    def discard(self, conversation_id: str) -> None:
        """Drop a conversation's entry from both tiers: its bytes moved to
        another replica (a fleet migration or drain handoff), and a twin
        left here could later resume a turn that no longer routes here."""
        if self.disk is not None:
            self.disk.discard(conversation_id)
        entry = self._entries.pop(conversation_id, None)
        if entry is not None:
            self._drop(entry)
            self._publish_gauges()

    def drop_local(self, conversation_id: str) -> None:
        """Drop the RAM copy only: the fabric's counterpart of ``discard``.
        The bytes moved to a replica whose put wrote through to the shared
        tier, so deleting the record here would erase the one the target
        just refreshed (both ride the tier's one writer)."""
        entry = self._entries.pop(conversation_id, None)
        if entry is not None:
            self._drop(entry)
            self._publish_gauges()

    def discard_if(self, pred: Callable[[SessionEntry], bool]) -> int:
        """Drop every RAM entry matching ``pred``; returns how many (prefix
        retirement: an entry referencing a retired head would pin its pages
        though the head can never match again)."""
        victims = [e for e in self._entries.values() if pred(e)]
        for entry in victims:
            del self._entries[entry.conversation_id]
            self._drop(entry)
        if victims:
            self._publish_gauges()
        return len(victims)

    def _drop(self, entry: SessionEntry) -> None:
        self._resident_bytes -= entry.nbytes
        entry.snap = None
        if self._on_drop is not None:
            self._on_drop(entry)
        if self.fabric is not None:
            # holder-guarded: a migration's target that noted its copy first
            # keeps its claim when the source drops here
            self.fabric.forget(entry.conversation_id, self.fabric_replica)

    # --- disk tier -------------------------------------------------------
    def _spill(self, entry: SessionEntry) -> bool:
        """Write one entry's record through to the disk tier (no-op
        without one). ``prefix_len`` travels, the head's device pages never
        do."""
        if self.disk is None or entry.n_tokens == 0:
            return False
        return self.disk.spill(entry.conversation_id, entry.token_ids, entry.prefix_len,
                               entry.snap, entry.kv_gap, entry.kv_sink)

    def spill_all(self) -> int:
        """Re-spill every resident entry and flush the write-behind queue
        (graceful shutdown: puts already wrote through, so this retries any
        failed write). Returns how many records were queued."""
        n = sum(1 for e in self._entries.values() if self._spill(e))
        if self.disk is not None:
            self.disk.flush()
        return n

    def fit_payload(self, payload: dict) -> dict | None:
        """Trim a disk or exported payload to the largest page-whole prefix
        whose host bytes fit the RAM budget, so an over-budget record still
        resumes partly. Returns the payload untouched when it fits, a
        trimmed copy when a prefix does, or None when nothing does."""
        snap = payload["snap"]
        nbytes = _snap_nbytes(snap)
        if nbytes <= self.budget_bytes:
            return payload
        if payload.get("kv_gap"):
            # a bounded entry is whole or not: trimming would cut the window
            # its gap depends on (a bounded snapshot is at most sink + window
            # pages, so one over the RAM budget is a configuration problem)
            return None
        prefix_len = int(payload["prefix_len"])
        own_pages = (len(payload["token_ids"]) - prefix_len) // self.page_size
        keep = int(own_pages * self.budget_bytes // nbytes)
        if keep <= 0 and prefix_len <= 0:
            return None
        trimmed = dict(payload)
        trimmed["token_ids"] = np.asarray(payload["token_ids"], np.int32)[
            : prefix_len + keep * self.page_size]
        trimmed["snap"] = _slice_snap(snap, keep)
        logger.warning("session cache: disk record for %s (%d bytes) exceeds RAM budget %d; "
                       "trimmed to %d of %d own pages for a partial warm resume",
                       payload["conversation_id"], nbytes, self.budget_bytes, keep, own_pages)
        return trimmed

    # --- transfer --------------------------------------------------------
    def export_entry(self, conversation_id: str) -> dict | None:
        """Device-independent image of one conversation's entry: token ids
        and the host snapshot. A shared head's device pages are not
        exported — only ``prefix_len`` — so an importer re-links against its
        own live registration of the same head. Snapshot tensors are shared
        by reference (never mutated in place)."""
        entry = self._entries.get(conversation_id)
        if entry is None or entry.n_tokens == 0:
            return None
        return {
            "conversation_id": conversation_id,
            "token_ids": np.array(entry.token_ids, copy=True),
            "prefix_len": int(entry.prefix_len),
            "snap": entry.snap,
            "kv_gap": int(entry.kv_gap),
            "kv_sink": int(entry.kv_sink),
        }

    def import_entry(self, payload: dict, *, prefix_entry: Any | None = None,
                     prefix_pages: list[int] | None = None, spill: bool = True) -> bool:
        """Adopt an exported entry. ``prefix_entry``/``prefix_pages`` is the
        importer's own live twin of the exported shared head, covering
        exactly ``payload['prefix_len']`` tokens; both empty only when the
        payload has no head. Returns ``put``'s verdict."""
        prefix_len = int(payload["prefix_len"])
        if (prefix_len == 0) != (prefix_entry is None):
            raise ValueError("a payload with a shared head needs the importer's live head")
        entry = SessionEntry(
            conversation_id=payload["conversation_id"],
            token_ids=np.asarray(payload["token_ids"], np.int32),
            prefix_entry=prefix_entry,
            prefix_pages=list(prefix_pages or []),
            prefix_len=prefix_len,
            snap=payload["snap"],
            kv_gap=int(payload.get("kv_gap", 0)),
            kv_sink=int(payload.get("kv_sink", 0)),
        )
        return self.put(entry, spill=spill)

    # --- read path -------------------------------------------------------
    def match(self, conversation_id: str,
              prompt_ids: list[int]) -> tuple[SessionEntry | None, int]:
        """Longest resumable prefix of ``prompt_ids`` held for this
        conversation: the common token prefix with the entry, floored to
        whole pages, capped so at least one prompt token remains to prefill.
        A hit refreshes LRU recency.

        Divergence is handled here: if the new turn's tokens split from the
        stored stream before its end, the entry is truncated to the common
        prefix. A gapped entry resumes whole (``matched`` is its whole span)
        when the prompt extends past it unchanged, is kept as it is when the
        prompt merely stops short, and on divergence keeps only its pre-gap
        sink region, as a gap-free entry."""
        entry = self._entries.get(conversation_id)
        if entry is None or not prompt_ids:
            return None, 0
        page = self.page_size
        prompt = np.asarray(prompt_ids, np.int32)
        n = min(entry.n_tokens, len(prompt))
        neq = np.nonzero(entry.token_ids[:n] != prompt[:n])[0]
        common = int(neq[0]) if neq.size else n
        if entry.kv_gap:
            if not neq.size:
                if common >= entry.n_tokens and len(prompt) - 1 >= entry.n_tokens:
                    self._entries.move_to_end(conversation_id)
                    return entry, entry.n_tokens
                # a prompt that stops short cannot use the entry but has
                # not staled it: it waits for the turn that extends past it
                return None, 0
            # divergence: the windowed remainder attended to the evicted
            # tokens and is stale; the sink tokens attended only earlier sink
            # tokens, so they truncate into an ordinary gap-free entry
            salvage = (min(common, entry.kv_sink) // page) * page
            entry.kv_gap = 0
            entry.kv_sink = 0
            self._truncate(entry, min(salvage, entry.n_tokens))
            if entry.n_tokens == 0:
                return None, 0
            common = min(common, entry.n_tokens)
        if common < entry.n_tokens:
            self._truncate(entry, (common // page) * page)
            if entry.n_tokens == 0:
                return None, 0
        cap = ((len(prompt) - 1) // page) * page
        matched = min((common // page) * page, cap)
        if matched <= 0:
            return None, 0
        self._entries.move_to_end(conversation_id)
        return entry, matched

    def _truncate(self, entry: SessionEntry, n_tokens: int) -> None:
        """Cut an entry down to a page-aligned token count (divergence). An
        entry truncated to nothing is dropped."""
        if n_tokens % self.page_size or n_tokens > entry.n_tokens:
            raise ValueError(f"cannot truncate a {entry.n_tokens}-token entry to {n_tokens}")
        self.metrics.inc("finchat_session_cache_truncations_total")
        before = entry.nbytes
        entry.token_ids = entry.token_ids[:n_tokens]
        if n_tokens <= entry.prefix_len:
            # the divergence falls inside the shared head: keep only the
            # matched whole head pages (still referenced, still read-only)
            entry.prefix_len = n_tokens
            entry.prefix_pages = entry.prefix_pages[: n_tokens // self.page_size]
            entry.snap = None
        else:
            entry.snap = _slice_snap(entry.snap, (n_tokens - entry.prefix_len) // self.page_size)
        self._resident_bytes += entry.nbytes - before
        if entry.n_tokens == 0:
            del self._entries[entry.conversation_id]
            self._drop(entry)
        self._publish_gauges()
