"""Metrics registry (own copy of the JAX package's registry).

The scheduler and the page allocator write the same ``finchat_*`` families
as the reference: TTFT and inter-token histograms, tokens generated, queue
depth, batch occupancy, KV pages used, and the mixed-step family
(``finchat_mixed_dispatches_total``, ``finchat_coexist_iterations_total``,
``finchat_coexist_dispatches_total``) that shows how many coexist rounds
ran as one packed ragged dispatch. ``render_prometheus`` gives the text the
app's ``GET /metrics`` serves, byte for byte the reference's for the same
registry contents; ``labeled`` gives a view that stamps fixed labels onto
every series it touches.

The serving app (serve/app.py, io/kafka.py, io/journal.py), under the
reference's names: ``finchat_kafka_produced_total``,
``finchat_kafka_errors_produced_total``, ``finchat_kafka_commits_total`` and
``finchat_kafka_dedupe_skips_total`` (redelivered answered ids skipped);
``finchat_durability_journal_appends_total`` /
``_journal_append_failures_total`` / ``_journal_replayed_total``,
``finchat_durability_graceful_drains_total`` and the
``finchat_durability_shutdown_drain_seconds`` histogram.

Prefix and session KV caches (engine/scheduler.py, engine/session_cache.py),
under the reference's names: ``finchat_prefix_hits_total`` and
``finchat_prefix_tokens_saved_total`` (admissions that referenced a shared
head, and the prefill tokens that skipped);
``finchat_session_cache_hits_total`` / ``_misses_total`` (admissions of
conversation-keyed submissions), ``finchat_session_cache_resident_bytes``
and ``finchat_session_cache_entries`` (gauges: the host-RAM tier),
``finchat_session_cache_restored_tokens_total``,
``finchat_session_cache_offloaded_pages_total``,
``finchat_session_cache_evictions_total`` (LRU under the byte budget),
``finchat_session_cache_truncations_total`` (divergent histories), and the
``finchat_session_offload_seconds`` / ``finchat_session_restore_seconds``
histograms (the host copy at retirement, the copy back at admission). The
disk tier: ``finchat_durability_spills_total`` /
``finchat_durability_spilled_bytes_total`` /
``finchat_durability_spill_failures_total``,
``finchat_durability_disk_resident_bytes`` /
``finchat_durability_disk_entries`` (gauges),
``finchat_durability_disk_evictions_total``,
``finchat_durability_disk_restores_total`` with the
``finchat_durability_restore_seconds`` histogram,
``finchat_durability_quarantines_total``, and
``finchat_quant_dequant_fallbacks_total`` (snapshots of the other KV mode
refused) and ``finchat_fleet_session_import_refused_total`` (imported
entries refused: no live twin of their shared head, or a bounded-KV
entry).

Resilience (engine/scheduler.py, engine/engine.py), under the reference's
names: ``finchat_preemptions_total`` (recompute preemptions: page
pressure, breaker recovery), ``finchat_sheds_total`` (pending requests
dropped past their deadline), ``finchat_overload_rejections_total``
(submits refused at ``max_queue_depth``),
``finchat_dispatch_failures_total`` (whole rounds that failed),
``finchat_engine_rebuilds_total`` and the ``finchat_engine_rebuild_seconds``
histogram (the breaker's and ``revive_async``'s device-state rebuilds),
``finchat_breaker_state`` (gauge: 0 closed, 1 open, 2 half-open),
``finchat_breaker_recovery_seconds`` (trip to the first successful round of
the plane) and ``finchat_warmup_compiled_variants`` (gauge: the step
variants the engine's last ``warmup`` ran).

Partial holds and tracing (engine/scheduler.py, engine/generator.py,
utils/tracing.py), under the reference's names:
``finchat_partial_holds_total`` / ``_grafts_total`` / ``_fallbacks_total``
/ ``_stale_reaps_total`` (the retrieval overlap's holds, their grafts,
refused grafts and holds reaped at their TTL), the
``finchat_retrieval_graft_seconds`` histogram (``extend_prompt`` on the
host), ``finchat_request_seconds`` (a request's whole span, with a trace
exemplar), ``finchat_span_double_finish_total`` and
``finchat_flight_dumps_total`` (by reason). A histogram observed with a
``trace_id`` keeps the last trace id whose value landed above its p99
bucket (``exemplar``).

Tool streaming (agent/streamparse.py, agent/graph.py), under the
reference's names: ``finchat_tool_launches_total`` (tool executions the
launcher started, speculative and adopted),
``finchat_tool_speculative_cancels_total`` (in-flight launches cancelled
because a later commit invalidated them, or the final call did not match),
``finchat_tool_fallbacks_total`` (turns where streaming disengaged: a
parser anomaly, an incremental/serial mismatch, or a failed speculative
run retried serially) and the ``finchat_tool_overlap_saved_seconds``
histogram (per adopted launch, the tool time that ran under the rest of
the decision decode; its exemplar is the turn's trace id).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


def _labeled_key(name: str, labels: dict[str, str] | None) -> str:
    """Internal series key: ``name`` or ``name{k="v",...}`` (labels sorted)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _split_key(key: str) -> tuple[str, str]:
    """Inverse of ``_labeled_key``: (base name, label string without braces)."""
    base, _, rest = key.partition("{")
    return base, rest[:-1] if rest else ""


@dataclass
class _Histogram:
    """Fixed-bucket histogram (seconds-scale by default).

    With a ``trace_id`` passed to ``observe`` it keeps an exemplar: the
    last trace id whose value landed strictly above the p99 bucket (the
    first traced observation seeds it), so a latency spike links to that
    request's exported timeline. "Above p99" is at bucket resolution."""

    buckets: tuple[float, ...] = (
        0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0,
    )
    counts: list[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0
    # (trace_id, value, unix_ts) of the last above-p99 observation
    exemplar: tuple[str, float, float] | None = None

    def __post_init__(self) -> None:
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def _bucket_index(self, value: float) -> int:
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                return i
        return len(self.buckets)

    def _q_index(self, q: float) -> int:
        """Index of the bucket holding the q-quantile."""
        target = q * self.n
        seen = 0
        for i in range(len(self.counts)):
            seen += self.counts[i]
            if seen >= target:
                return i
        return len(self.counts) - 1

    def observe(self, value: float, trace_id: str | None = None) -> None:
        self.total += value
        self.n += 1
        idx = self._bucket_index(value)
        self.counts[idx] += 1
        if trace_id is not None:
            # strictly above the p99 bucket: when 99% of the mass sits in one
            # bucket, observations inside it must not churn the exemplar away
            # from the outlier
            if self.exemplar is None or idx > self._q_index(0.99):
                self.exemplar = (trace_id, value, time.time())

    def quantile(self, q: float) -> float:
        """Approximate quantile from the bucket edges (the bucket's upper
        bound)."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        seen = 0
        for i, edge in enumerate(self.buckets):
            seen += self.counts[i]
            if seen >= target:
                return edge
        return float("inf")


class MetricsRegistry:
    """Thread-safe counters, gauges and histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, _Histogram] = {}

    def inc(self, name: str, value: float = 1.0,
            labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._counters[_labeled_key(name, labels)] += value

    def set_gauge(self, name: str, value: float,
                  labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._gauges[_labeled_key(name, labels)] = value

    def observe(self, name: str, value: float,
                labels: dict[str, str] | None = None,
                trace_id: str | None = None) -> None:
        key = _labeled_key(name, labels)
        with self._lock:
            if key not in self._histograms:
                self._histograms[key] = _Histogram()
            self._histograms[key].observe(value, trace_id=trace_id)

    def exemplar(self, name: str,
                 labels: dict[str, str] | None = None) -> tuple[str, float, float] | None:
        """The histogram's last above-p99 ``(trace_id, value, unix_ts)``, or
        None."""
        with self._lock:
            hist = self._histograms.get(_labeled_key(name, labels))
            return hist.exemplar if hist else None

    def quantile(self, name: str, q: float,
                 labels: dict[str, str] | None = None) -> float:
        with self._lock:
            hist = self._histograms.get(_labeled_key(name, labels))
            return hist.quantile(q) if hist else 0.0

    def get(self, name: str, labels: dict[str, str] | None = None) -> float:
        key = _labeled_key(name, labels)
        with self._lock:
            if key in self._counters:
                return self._counters[key]
            return self._gauges.get(key, 0.0)

    def labeled(self, **labels: str) -> "LabeledMetrics":
        """A view of this registry that stamps ``labels`` onto every series
        it touches (a fleet replica's scheduler emits its families under a
        ``replica`` label this way)."""
        return LabeledMetrics(self, labels)

    def snapshot(self) -> dict[str, float]:
        """Every counter and gauge, and each histogram as ``{name}_count``
        and ``{name}_sum``."""
        with self._lock:
            snap = dict(self._counters)
            snap.update(self._gauges)
            for name, h in self._histograms.items():
                snap[f"{name}_count"] = h.n
                snap[f"{name}_sum"] = h.total
            return snap


    def render_prometheus(self) -> str:
        """Prometheus text format 0.0.4: counters, then gauges, then
        histograms, each family's label variants consecutive under one
        ``# TYPE`` line keyed by the base name; a histogram's bucket lines
        merge its series labels with the ``le`` edge. A histogram's exemplar
        is a ``# exemplar`` comment (plain parsers skip it) whose trace id,
        which a client controls (a Kafka ``message_id``, an ``x-trace-id``
        header), is escaped so it cannot end the comment and forge a line."""
        lines: list[str] = []
        with self._lock:
            for store, kind in ((self._counters, "counter"), (self._gauges, "gauge")):
                seen: set[str] = set()
                for key in sorted(store, key=_split_key):
                    base, _lbl = _split_key(key)
                    if base not in seen:
                        seen.add(base)
                        lines.append(f"# TYPE {base} {kind}")
                    lines.append(f"{key} {store[key]}")
            seen_types: set[str] = set()
            for key in sorted(self._histograms, key=_split_key):
                base, lbl = _split_key(key)
                h = self._histograms[key]
                if base not in seen_types:
                    seen_types.add(base)
                    lines.append(f"# TYPE {base} histogram")

                def series(extra: str = "") -> str:
                    both = ",".join(x for x in (lbl, extra) if x)
                    return "{" + both + "}" if both else ""

                cumulative = 0
                for i, edge in enumerate(h.buckets):
                    cumulative += h.counts[i]
                    le = 'le="%s"' % edge
                    lines.append(f"{base}_bucket{series(le)} {cumulative}")
                cumulative += h.counts[-1]
                le_inf = 'le="+Inf"'
                lines.append(f"{base}_bucket{series(le_inf)} {cumulative}")
                lines.append(f"{base}_sum{series()} {h.total}")
                lines.append(f"{base}_count{series()} {h.n}")
                if h.exemplar is not None:
                    tid, val, ts = h.exemplar
                    safe = (tid.replace("\\", "\\\\").replace('"', '\\"')
                            .replace("\n", "\\n").replace("\r", "\\r"))
                    lines.append(
                        f'# exemplar {key} trace_id="{safe}" value={val} ts={ts}'
                    )
        return "\n".join(lines) + "\n"


class LabeledMetrics:
    """Registry view with a fixed label set merged into every call: a drop-in
    for ``METRICS`` at the scheduler's and session cache's call sites
    (``inc`` / ``set_gauge`` / ``observe`` / ``exemplar`` / ``get`` /
    ``quantile``, and as a ``Timer`` target). Call-site labels merge over
    the fixed ones."""

    def __init__(self, registry: MetricsRegistry, labels: dict[str, str]):
        self._registry = registry
        self.labels = {k: str(v) for k, v in labels.items()}

    def _merge(self, labels: dict[str, str] | None) -> dict[str, str]:
        return {**self.labels, **labels} if labels else self.labels

    def inc(self, name: str, value: float = 1.0,
            labels: dict[str, str] | None = None) -> None:
        self._registry.inc(name, value, labels=self._merge(labels))

    def set_gauge(self, name: str, value: float,
                  labels: dict[str, str] | None = None) -> None:
        self._registry.set_gauge(name, value, labels=self._merge(labels))

    def observe(self, name: str, value: float,
                labels: dict[str, str] | None = None,
                trace_id: str | None = None) -> None:
        self._registry.observe(name, value, labels=self._merge(labels),
                               trace_id=trace_id)

    def exemplar(self, name: str,
                 labels: dict[str, str] | None = None) -> tuple[str, float, float] | None:
        return self._registry.exemplar(name, labels=self._merge(labels))

    def get(self, name: str, labels: dict[str, str] | None = None) -> float:
        return self._registry.get(name, labels=self._merge(labels))

    def quantile(self, name: str, q: float,
                 labels: dict[str, str] | None = None) -> float:
        return self._registry.quantile(name, q, labels=self._merge(labels))


# Process-global registry (one worker process = one registry).
METRICS = MetricsRegistry()


class Timer:
    """Context manager: ``with Timer(METRICS, "prefill_seconds"): ...``"""

    def __init__(self, registry: MetricsRegistry, name: str) -> None:
        self._registry = registry
        self._name = name
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self.started = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self.elapsed = time.perf_counter() - self.started
        self._registry.observe(self._name, self.elapsed)
