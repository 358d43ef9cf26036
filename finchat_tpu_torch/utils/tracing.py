"""Request tracing and the anomaly flight recorder (own copy of the JAX
package's ``utils/tracing.py``, its device plane in torch's idiom).

Three planes:

1. **Host spans**: :class:`RequestSpan`, per-request lifecycle marks
   (queue, admission, prefill, first token, done) recorded into the
   metrics registry and, when the request carries a ``trace_id``, into the
   process trace ring below.
2. **Structured trace events**: :class:`Tracer`, a bounded per-process ring
   of ``(ts, trace_id, name, dur, track, args)`` tuples. Dispatch events
   record which ``[slot, trace_id, mode]`` rows rode each model dispatch,
   so a request's device time is attributable even when many requests
   share one ragged dispatch. Events stamp only host data the code already
   holds: an append is a deque append and adds no host sync.
   ``Tracer.export(trace_id)`` gives one request's timeline as Chrome
   trace-event JSON (opens in Perfetto).
3. **Flight recorder**: on an anomaly (breaker trip, shed, replica give-up,
   record quarantine, ...) the anomaly is recorded as an event and the
   whole ring is dumped to a checksummed file under ``flight_dir``. Dumps
   are written in a worker thread and rate-limited per anomaly kind;
   ``flush_dumps`` joins the writers.

And the device plane: ``named_scope`` is a ``torch.profiler.record_function``
range while a profiler runs and nothing otherwise (a JAX scope is free at
run time, an eager torch range is paid on every layer of a host-bound
step), and ``device_trace`` captures a ``torch.profiler`` trace.

Every ``mark()`` and event name must come from the registries below: a
misspelt name otherwise vanishes from every timeline without an error
(tests/test_torch_lint.py checks the literals statically).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import torch

from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS, MetricsRegistry

logger = get_logger(__name__)

# ---------------------------------------------------------------------------
# the span/event name registries (the source of truth of span discipline:
# every ``span.mark(...)`` / ``TRACER.event(...)`` /
# ``TRACER.anomaly(...)`` literal must appear here)
# ---------------------------------------------------------------------------

#: RequestSpan lifecycle marks (scheduler + agent planes). The registries
#: are the JAX package's sets, so a timeline of either package reads the
#: same; names of planes this port does not carry stay declared.
SPAN_MARKS = frozenset({
    # scheduler lifecycle (engine/scheduler.py)
    "admitted", "prefill_done", "first_token", "done",
    # agent/tool plane (agent/graph.py, agent/streamparse.py)
    "decide_start", "name_commit", "tool_launch", "tool_adopted",
    "response_prefill_hold",
})

#: Structured events that are not per-request span marks.
TRACE_EVENTS = frozenset({
    "ingress",          # request entered the serving plane (Kafka/HTTP)
    "dispatch",         # one model dispatch; args.rows = [[slot, tid, mode]]
    "preempt",          # recompute preemption (page pressure / breaker)
    "adopt",            # fleet sibling adopted a drained handle
    "drain_handoff",    # breaker drain handed a stream to a sibling
    "session_migrate",  # session-cache bytes moved between replicas
    "request",          # whole-request complete span (emitted at finish)
    # a membership epoch invalidated an in-flight free-run capture: the
    # drain discarded stale residual ring tokens (replayed exactly once
    # via preempt/replay) — the capture/replay boundary on the timeline
    "freerun_epoch_break",
    # bounded-KV eviction wave: args carry the evicted page
    # count and the affected slots — page occupancy drops are attributable
    # on the timeline without any per-token cost
    "boundedkv_evict",
    # disaggregated serving: a prefill-pool replica ran a cold
    # prompt and handed its KV to the serving replica before admission —
    # args carry source/target replicas and the token count
    "disagg_handoff",
    # warm-state fabric hit: a shared-head or session restore
    # served from the cluster-wide fabric instead of a local prefill —
    # args.kind distinguishes "head" from "session"
    "fabric_hit",
    # pod plane: a survivor adopted a dead host's partitions —
    # args carry the dead host, the inherited partitions, and how many
    # journaled ids replayed into the dedupe ring
    "pod_adopt",
    # pod plane: a conversation's session bytes were pulled
    # from a liaison peer and imported warm — args carry peer and bytes
    "pod_session_pull",
})

#: Anomaly kinds — each records an event AND triggers a flight dump.
ANOMALY_KINDS = frozenset({
    "breaker_trip", "watchdog_timeout", "shed", "replica_give_up",
    "record_quarantine", "sigterm_drain",
    # free-run ring replay mismatch: a captured round emitted where the
    # staged descriptor plan never armed a row — the drain
    # refuses the unarmed cells and dumps the black box
    "freerun_divergence",
    # pod plane: a liaison peer missed enough heartbeats to be
    # declared dead — the host failure domain tripped; partition adoption
    # follows
    "pod_host_lost",
})

TRACE_EVENT_NAMES = SPAN_MARKS | TRACE_EVENTS | ANOMALY_KINDS

#: Per-row modes a ``dispatch`` event's ``args.rows`` may carry (the third
#: element of each ``[slot, trace_id, mode]`` row) — declared so timeline
#: consumers and tests have one source of truth.
DISPATCH_ROW_MODES = frozenset({
    "prefill", "prefix", "decode", "decode_loop", "spec", "constrained",
    "ring", "freerun",
})

#: Serving quant-mode labels a ``dispatch`` event's ``args.quant`` may
#: carry: the engine's weight mode ("bf16" = unquantized
#: native dtype, "int8", "int4") with "+kv8" appended when the KV page
#: pool is int8 — ``InferenceEngine.quant_label`` must stay inside this
#: set, so traced timelines can
#: always distinguish bf16 from quantized dispatches.
QUANT_MODES = frozenset({
    "bf16", "int8", "int4", "bf16+kv8", "int8+kv8", "int4+kv8",
})

_FLIGHT_MAGIC = "FINCHAT-FLIGHT v1"
# per-kind dump rate limit: an anomaly storm (e.g. a shed wave) records
# every EVENT but writes at most one black box per kind per window
_DUMP_MIN_INTERVAL_S = 5.0


def _chrome_event(ev: tuple) -> dict:
    """One ring tuple → one Chrome trace-event object (Perfetto-loadable:
    ``X`` complete events for spans with a duration, ``i`` instants
    otherwise; timestamps in µs on the perf_counter clock)."""
    ts, trace_id, name, dur, track, args = ev
    out: dict = {
        "name": name,
        "cat": "finchat",
        "ph": "X" if dur is not None else "i",
        "ts": round(ts * 1e6, 1),
        "pid": 0,
        "tid": str(track),
        "args": dict(args) if args else {},
    }
    if trace_id is not None:
        out["args"]["trace_id"] = trace_id
    if dur is not None:
        out["dur"] = round(dur * 1e6, 1)
    else:
        out["s"] = "t"  # instant scope: thread
    return out


def _event_carries(ev: tuple, trace_id: str) -> bool:
    """Does this ring tuple belong on ``trace_id``'s timeline? Either it
    is stamped with the id, or it is a dispatch event whose row list
    carries the id (many requests share one ragged dispatch, and the round's
    rows are host-known)."""
    if ev[1] == trace_id:
        return True
    args = ev[5]
    if args:
        rows = args.get("rows")
        if rows:
            return any(r[1] == trace_id for r in rows)
    return False


class Tracer:
    """Process-global bounded trace ring + flight recorder.

    Appends are a single ``deque.append`` of a pre-built tuple — safe from
    the event loop and worker threads alike (CPython deque appends are
    atomic), no locks on the hot path. Everything heavier (export, dumps)
    snapshots the ring first.
    """

    def __init__(self, ring_events: int = 65536):
        self.enabled = True
        self.flight_dir = ""
        self._ring: deque = deque(maxlen=max(16, ring_events))
        self._lock = threading.Lock()  # config + dump bookkeeping only
        self._dump_seq = 0
        self._last_dump: dict[str, float] = {}
        self._dump_threads: list[threading.Thread] = []

    # --- configuration ---------------------------------------------------
    def configure(self, enabled: bool | None = None,
                  ring_events: int | None = None,
                  flight_dir: str | None = None) -> None:
        """Apply the ``tracing.*`` knobs (utils/config.py TracingConfig).
        Resizing the ring keeps the most recent events."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if flight_dir is not None:
                self.flight_dir = flight_dir
            if ring_events is not None and ring_events != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(16, ring_events))

    def clear(self) -> None:
        self._ring.clear()

    # --- event recording -------------------------------------------------
    def event(self, name: str, trace_id: str | None = None, *,
              ts: float | None = None, dur: float | None = None,
              track: str = "main", args: dict | None = None) -> None:
        """Append one event to the ring. ``ts``/``dur`` are perf_counter
        seconds; ``dur`` set → a complete ("X") span, else an instant.
        ``name`` must come from the tracing registries.
        No-op when tracing is disabled — callers on hot paths should
        additionally guard row-building with ``TRACER.enabled``."""
        if not self.enabled:
            return
        self._ring.append((
            ts if ts is not None else time.perf_counter(),
            trace_id, name, dur, track, args,
        ))

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str | None = None, *,
             track: str = "main", args: dict | None = None) -> Iterator[None]:
        """Record a complete ("X") event spanning the with-block."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.event(name, trace_id, ts=t0,
                       dur=time.perf_counter() - t0, track=track, args=args)

    def anomaly(self, kind: str, trace_id: str | None = None,
                args: dict | None = None) -> None:
        """Record an anomaly event and dump the ring alongside it (the
        flight recorder). No-op with tracing disabled (an empty/stale ring
        is not a black box); the dump is rate-limited per kind and written
        off-loop."""
        if not self.enabled:
            return
        self.event(kind, trace_id, track="anomaly", args=args)
        self.flight_dump(kind, trace_id=trace_id, args=args)

    # --- export ----------------------------------------------------------
    def snapshot(self) -> list[tuple]:
        return list(self._ring)

    def export(self, trace_id: str) -> dict:
        """One request's correlated timeline as Chrome trace-event JSON
        (``{"traceEvents": [...]}`` — open in Perfetto / chrome://tracing):
        every event stamped with ``trace_id`` plus every dispatch whose
        row list carried it."""
        events = [
            _chrome_event(ev) for ev in self.snapshot()
            if _event_carries(ev, trace_id)
        ]
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace_id},
        }

    # --- flight recorder -------------------------------------------------
    def flight_dump(self, reason: str, trace_id: str | None = None,
                    args: dict | None = None) -> str | None:
        """Dump the ring to a checksummed file under ``flight_dir``
        (pre-reserved filename returned immediately; the serialize+write
        runs in a worker thread so an anomaly on the scheduler loop never
        blocks serving). Returns the dump path,
        or None when the recorder is disabled or rate-limited."""
        with self._lock:
            if not self.flight_dir:
                return None
            now = time.monotonic()
            last = self._last_dump.get(reason)
            if last is not None and now - last < _DUMP_MIN_INTERVAL_S:
                return None
            self._last_dump[reason] = now
            self._dump_seq += 1
            seq = self._dump_seq
        events = self.snapshot()  # snapshot NOW; the writer thread races nothing
        path = os.path.join(
            self.flight_dir, f"flight-{seq:04d}-{reason}.json"
        )
        t = threading.Thread(
            target=self._write_dump, args=(path, reason, trace_id, args, events),
            daemon=True, name=f"flight-dump-{seq}",
        )
        with self._lock:
            self._dump_threads = [x for x in self._dump_threads if x.is_alive()]
            self._dump_threads.append(t)
        t.start()
        return path

    def _write_dump(self, path: str, reason: str, trace_id: str | None,
                    args: dict | None, events: list[tuple]) -> None:
        try:
            payload = json.dumps({
                "reason": reason,
                "trace_id": trace_id,
                "anomaly_args": args,
                "wall_time": time.time(),
                "trace": {
                    "traceEvents": [_chrome_event(ev) for ev in events],
                    "displayTimeUnit": "ms",
                },
            }, default=str).encode()
            header = f"{_FLIGHT_MAGIC} crc32={zlib.crc32(payload):08x} bytes={len(payload)}\n"
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(header.encode())
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            METRICS.inc("finchat_flight_dumps_total", labels={"reason": reason})
            logger.warning("flight recorder: %d events dumped to %s (%s)",
                           len(events), path, reason)
        except Exception as e:  # the black box is best-effort by contract
            logger.error("flight recorder: dump to %s failed: %s", path, e)

    def flush_dumps(self, timeout: float = 10.0) -> None:
        """Join in-flight dump writers (call via ``asyncio.to_thread`` from
        async code — the graceful drain does, so the black box lands on
        disk before the process exits)."""
        with self._lock:
            threads = list(self._dump_threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            self._dump_threads = [x for x in self._dump_threads if x.is_alive()]


def load_flight_dump(path: str) -> dict:
    """Parse + verify a flight-recorder file. Raises ``ValueError`` on a
    bad magic, truncation, or checksum mismatch — the black box must be
    trustworthy or loudly not."""
    raw = Path(path).read_bytes()
    nl = raw.find(b"\n")
    if nl < 0:
        raise ValueError(f"{path}: truncated flight dump (no header)")
    header = raw[:nl].decode("latin-1")
    if not header.startswith(_FLIGHT_MAGIC):
        raise ValueError(f"{path}: bad flight-dump magic {header[:32]!r}")
    fields = dict(
        kv.split("=", 1) for kv in header[len(_FLIGHT_MAGIC):].split() if "=" in kv
    )
    payload = raw[nl + 1:]
    if len(payload) != int(fields.get("bytes", -1)):
        raise ValueError(f"{path}: truncated flight dump "
                         f"({len(payload)} != {fields.get('bytes')} bytes)")
    if zlib.crc32(payload) != int(fields.get("crc32", "-1"), 16):
        raise ValueError(f"{path}: flight dump checksum mismatch")
    return json.loads(payload.decode())


# Process-global tracer (one worker process = one ring, matching METRICS).
TRACER = Tracer()


@dataclass
class RequestSpan:
    """Lifecycle timestamps for one request through the serving stack.

    ``mark()`` names must come from :data:`SPAN_MARKS`.
    With a ``trace_id``, every mark also lands in the process trace ring,
    and ``finish()`` additionally emits the whole-request "request" span.
    ``finish()`` is IDEMPOTENT — it is invoked from many scheduler sites
    (shed, evict, drain, give-up, rebuild-failure) whose flows can
    overlap on the preempt-replay and drain-handoff paths; the first call
    wins, later calls are counted in ``finchat_span_double_finish_total``
    and change nothing.
    """

    request_id: str
    trace_id: str | None = None
    created_at: float = field(default_factory=time.perf_counter)
    marks: dict[str, float] = field(default_factory=dict)
    finished: bool = False

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.marks[name] = now - self.created_at
        if self.trace_id is not None and TRACER.enabled:
            TRACER.event(name, self.trace_id, ts=now, track="request")

    def ttft(self) -> float | None:
        """Time to first token, if the request got that far."""
        return self.marks.get("first_token")

    def finish(self, registry: MetricsRegistry = METRICS) -> None:
        if self.finished:
            # second finish (preempt-replay / drain-handoff overlap):
            # first call won — count it, change nothing
            registry.inc("finchat_span_double_finish_total")
            return
        self.finished = True
        # TTFT is observed at first-token time by the scheduler (so the
        # histogram is live mid-request); here only the total is recorded.
        self.mark("done")
        registry.observe("finchat_request_seconds", self.marks["done"],
                         trace_id=self.trace_id)
        if self.trace_id is not None and TRACER.enabled:
            TRACER.event("request", self.trace_id, ts=self.created_at,
                         dur=self.marks["done"], track="request",
                         args={"request_id": self.request_id})
        logger.debug(
            "span %s: %s",
            self.request_id,
            " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in sorted(self.marks.items(), key=lambda kv: kv[1])),
        )


_NO_SCOPE = contextlib.nullcontext()


def named_scope(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler is running, else a shared no-op context (one C call to find
    out: this runs on every layer of every step)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SCOPE


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the with-block (host ranges,
    and the card's kernels when CUDA is available) and write it to
    ``log_dir/trace.json`` as a Chrome trace (Perfetto opens it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
