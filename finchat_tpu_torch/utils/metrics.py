"""Metrics registry (own copy of the JAX package's registry).

The scheduler and the page allocator write the same ``finchat_*`` families
as the reference: TTFT and inter-token histograms, tokens generated, queue
depth, batch occupancy, KV pages used, and the mixed-step family
(``finchat_mixed_dispatches_total``, ``finchat_coexist_iterations_total``,
``finchat_coexist_dispatches_total``) that shows how many coexist rounds
ran as one packed ragged dispatch. The Prometheus rendering comes with the
HTTP slice.
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


@dataclass
class _Histogram:
    """Fixed-bucket histogram (seconds-scale by default)."""

    buckets: tuple[float, ...] = (
        0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0,
    )
    counts: list[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0

    def __post_init__(self) -> None:
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def observe(self, value: float) -> None:
        self.total += value
        self.n += 1
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


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
                labels: dict[str, str] | None = None) -> None:
        key = _labeled_key(name, labels)
        with self._lock:
            if key not in self._histograms:
                self._histograms[key] = _Histogram()
            self._histograms[key].observe(value)

    def get(self, name: str, labels: dict[str, str] | None = None) -> float:
        key = _labeled_key(name, labels)
        with self._lock:
            if key in self._counters:
                return self._counters[key]
            return self._gauges.get(key, 0.0)


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
