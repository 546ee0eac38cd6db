"""Single process-wide metrics registry with Prometheus text output.

A copy of ``fasttalk_tpu/utils/metrics.py`` (the port imports nothing of
the JAX package): the scheduler and the engine observe its counters and
histograms, and the server renders ``prometheus()`` at ``GET /metrics``.

Deliberately replaces the reference's three overlapping mechanisms
(SURVEY.md §5: connection_manager counters + conversation_manager counters +
the never-wired ServiceMonitor at app/monitoring/service_monitor.py:18-61,
whose /metrics always reported zeros). One registry, one source of truth,
real tokenizer token counts.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
from collections import deque
from typing import Any, Iterable


def _default_window_s() -> float:
    """Percentile-window horizon (seconds); <= 0 disables time-based
    eviction (pure sample-count window, the pre-ISSUE-3 behaviour)."""
    raw = os.getenv("METRICS_WINDOW_S", "").strip()
    if not raw:
        return 300.0
    try:
        return float(raw)
    except ValueError:
        return 300.0


class Counter:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def clear(self) -> None:
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def clear(self) -> None:
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class LabeledGauge:
    """A gauge family keyed by ONE label (e.g. per-program busy
    seconds). The flat Gauge stays the default — labels multiply
    cardinality and most of this registry is deliberately scalar —
    but per-program / per-cause attribution is exactly the case
    labels exist for, and flattening the label into the metric name
    would break every PromQL aggregation over the family.

    ``set_all`` replaces the whole family atomically: attribution
    samples are recomputed per scrape, and stale members (a program
    that left the rolling window) must disappear rather than freeze
    at their last value."""

    def __init__(self, name: str, help_: str, label: str):
        self.name = name
        self.help = help_
        self.label = label
        self._values: dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: float) -> None:
        with self._lock:
            self._values[key] = value

    def set_all(self, values: dict[str, float]) -> None:
        with self._lock:
            self._values = dict(values)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    @property
    def value(self) -> dict[str, float]:
        with self._lock:
            return dict(self._values)

    @staticmethod
    def _escape_label(value: str) -> str:
        """Label-value escaping per the exposition format: backslash,
        double quote and newline."""
        return (value.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))


class Histogram:
    """Fixed-bucket histogram; also keeps a bounded sample window so the
    /stats endpoint can report true percentiles (p50/p95 TTFT etc.).

    The percentile window is bounded BOTH ways: at most ``window``
    samples AND nothing older than ``window_s`` seconds
    (``METRICS_WINDOW_S``, default 300). The count bound alone meant
    that under low traffic /stats p95s reflected hours-old requests —
    an incident stayed "visible" in the percentiles long after it
    ended, and a quiet regression hid behind yesterday's good samples.
    The cumulative bucket counts are untouched: Prometheus rate() math
    needs monotonic counters, and gets them.
    """

    def __init__(self, name: str, help_: str, buckets: Iterable[float],
                 window: int = 2048, window_s: float | None = None,
                 clock=time.monotonic):
        self.name = name
        self.help = help_
        self.buckets = sorted(buckets)
        self.window_s = _default_window_s() if window_s is None \
            else window_s
        self._clock = clock
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._window: deque[tuple[float, float]] = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            i = bisect.bisect_left(self.buckets, value)
            self._counts[i] += 1
            self._sum += value
            self._n += 1
            now = self._clock()
            self._window.append((now, value))
            self._prune_locked(now)

    def _prune_locked(self, now: float) -> None:
        """Drop window samples older than window_s (amortised O(1):
        entries leave at most once). Bucket counts are cumulative and
        never pruned."""
        if self.window_s <= 0:
            return
        horizon = now - self.window_s
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()

    def _window_values_locked(self) -> list[float]:
        self._prune_locked(self._clock())
        return [v for _, v in self._window]

    def clear(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._n = 0
            self._window.clear()

    @staticmethod
    def _quantile(sorted_window: list[float], q: float) -> float:
        """Nearest-rank percentile: the smallest value with at least
        q% of the window at or below it (the truncating-index form
        biased small windows high — p50 of [1..4] picked 3)."""
        if not sorted_window:
            return 0.0
        idx = min(len(sorted_window) - 1,
                  max(0, math.ceil(q / 100.0 * len(sorted_window)) - 1))
        return sorted_window[idx]

    def percentile(self, q: float) -> float:
        with self._lock:
            s = sorted(self._window_values_locked())
        return self._quantile(s, q)

    def summary(self) -> dict[str, float]:
        with self._lock:  # one consistent snapshot, one sort
            n, total = self._n, self._sum
            s = sorted(self._window_values_locked())
        return {
            "count": n,
            "sum": total,
            "mean": total / n if n else 0.0,
            "p50": self._quantile(s, 50),
            "p95": self._quantile(s, 95),
            "p99": self._quantile(s, 99),
        }


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram
                            | LabeledGauge] = {}
        self._lock = threading.Lock()
        self.started_at = time.time()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_), Gauge)

    def labeled_gauge(self, name: str, help_: str = "",
                      label: str = "key") -> LabeledGauge:
        return self._get_or_create(
            name, lambda: LabeledGauge(name, help_, label), LabeledGauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = (
                      1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
                  ) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help_, buckets), Histogram)

    def _get_or_create(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def uptime(self) -> float:
        return time.time() - self.started_at

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"uptime_seconds": self.uptime()}
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in metrics.items():
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value  # LabeledGauge: {label_value: v}
        return out

    @staticmethod
    def _escape_help(text: str) -> str:
        """HELP-line escaping per the exposition format: backslash and
        newline only (a literal newline would truncate the line and the
        scraper would reject the next one)."""
        return text.replace("\\", "\\\\").replace("\n", "\\n")

    @staticmethod
    def _fmt_le(bound: float) -> str:
        """Bucket bounds render as canonical floats ("1.0", "2.5"),
        matching prometheus_client — int-vs-float formatting made the
        same bound render two ways across histograms."""
        return repr(float(bound))

    def prometheus(self) -> str:
        """Render all metrics in Prometheus exposition text format."""
        lines: list[str] = []
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {self._escape_help(m.help)}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, LabeledGauge):
                lines.append(f"# TYPE {name} gauge")
                vals = m.value
                for key in sorted(vals):
                    esc = m._escape_label(key)
                    lines.append(
                        f'{name}{{{m.label}="{esc}"}} {vals[key]}')
            else:
                lines.append(f"# TYPE {name} histogram")
                acc = 0
                with m._lock:
                    counts, total, n = list(m._counts), m._sum, m._n
                for bound, c in zip(m.buckets, counts):
                    acc += c
                    lines.append(
                        f'{name}_bucket{{le="{self._fmt_le(bound)}"}} {acc}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {n}')
                lines.append(f"{name}_sum {total}")
                lines.append(f"{name}_count {n}")
        lines.append("")
        return "\n".join(lines)


_registry: MetricsRegistry | None = None


def get_metrics() -> MetricsRegistry:
    global _registry
    if _registry is None:
        _registry = MetricsRegistry()
    return _registry


def reset_metrics() -> None:
    """Test hook: zero every metric IN PLACE (and restart the uptime
    clock), keeping registry and metric object identity.

    Dropping the registry — the old behaviour — orphaned every metric
    object cached at module/instance construction time (engine._m_*,
    ConnectionManager counters, ...): they kept incrementing objects no
    registry would ever render, so tests (and any runtime caller of
    reset) silently lost all subsequent counts."""
    global _registry
    if _registry is None:
        return
    with _registry._lock:
        metrics = list(_registry._metrics.values())
    for m in metrics:
        m.clear()
    _registry.started_at = time.time()
