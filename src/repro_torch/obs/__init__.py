"""Flight recorder for the cluster runtime (DESIGN.md §11).

Zero-dependency observability substrate: ``trace`` (begin/end spans on a
pluggable clock — SimClock and WallClock runs produce the same trace
SHAPE), ``metrics`` (counters/gauges/histograms with Prometheus-textfile
and JSON exporters), ``export`` (Chrome trace-event / Perfetto JSON, the
terminal waterfall, and the straggler-attribution report).

Tracing is off by default: every instrumented call site holds a
``NullRecorder`` whose methods are no-ops, so the recorder costs nothing
unless a run opts in (gated in benchmarks/bench_cluster.py).
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_RECORDER, NullRecorder, Recorder, Span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_RECORDER", "NullRecorder", "Recorder", "Span",
]
