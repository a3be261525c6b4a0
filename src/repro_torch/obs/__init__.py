"""Serving observability: metrics registry, span tracing, exposition.

  metrics.py -- counters / gauges / mergeable log-bucketed histograms
                (O(1) memory, exact quantile bounds) with label support;
                Prometheus text + JSON snapshot exposition
  trace.py   -- per-micro-batch span trees over the query cascade
                (plan > schedule / densify / emit_tiles, delta, dispatch >
                rerank_dispatch, dispatch_wait, collect, merge; compaction),
                bounded ring buffer, deterministic sampling, Chrome
                trace-event export, optional `torch.profiler` ranges
  http.py    -- stdlib HTTP server exposing /metrics, /metrics.json,
                /traces, /healthz (launch/serve.py --metrics-port)

The metric catalog is docs/OBSERVABILITY.md's; tools/check_metrics_torch.py
holds the runtime registrations to it.
"""

from repro_torch.obs.metrics import (
    GROWTH,
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
)
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer

__all__ = [
    "GROWTH",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_REGISTRY",
    "Span",
    "Tracer",
    "NULL_SPAN",
    "NULL_TRACER",
]
