"""Metrics registry: counters/gauges/histograms with two exporters.

One registry per runner (DESIGN.md §11).  The instruments are deliberately
minimal — monotone counters, last-value gauges, fixed-bucket histograms —
because everything heavier (percentiles over full series, waterfalls) comes
out of the span trace, not the metrics.  Two export formats:

  * ``to_prometheus()`` — the textfile exposition format, ready for a
    node-exporter textfile collector (``cpml_cluster --metrics-out``);
  * ``snapshot()`` — a plain JSON-able dict (bench reports, tests).

Updating a metric is a couple of dict/float operations; the registry is
always on (like the wire byte counters it aggregates) and its cost rides
under the same bench_cluster.py overhead gate as the recorder.
"""
from __future__ import annotations

import json
import math

# Default histogram buckets: wait/latency seconds, log-ish spaced from
# 100 µs to ~2 min.  +Inf is implicit (the _count line).
DEFAULT_BUCKETS = (1e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 120.0)


class Counter:
    """Monotone float counter."""

    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        self.value += amount


class Gauge:
    """Last-written value."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Histogram:
    """Fixed cumulative buckets + sum + count (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)   # per-bucket (non-cumulative)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        if math.isnan(value):
            return                   # an unobserved wait is not a sample
        self.count += 1
        self.sum += value if math.isfinite(value) else 0.0
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.counts[i] += 1
                break


class MetricsRegistry:
    """Named instruments, get-or-create, stable iteration order."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help_: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help_, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view of every instrument."""
        out: dict = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[name] = {"kind": m.kind, "count": m.count, "sum": m.sum,
                             "buckets": {_le(le): c for le, c
                                         in zip(m.buckets, m.counts)}}
            else:
                out[name] = {"kind": m.kind, "value": m.value}
        return out

    def to_prometheus(self) -> str:
        """Prometheus textfile exposition format."""
        lines: list[str] = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for le, c in zip(m.buckets, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_le(le)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_num(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {_num(m.value)}")
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        """``.json`` -> snapshot dump; anything else -> Prometheus text."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.snapshot(), f, indent=2)
        else:
            with open(path, "w") as f:
                f.write(self.to_prometheus())


def _le(le: float) -> str:
    return f"{le:g}"


def _num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:g}"
