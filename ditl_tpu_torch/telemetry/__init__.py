"""Telemetry: the process-local metrics registry (``registry.py``), a copy
of the JAX package's. The rest of the reference's telemetry (serving
instruments, goodput, the event journal, tracing, SLOs, usage) is not
ported yet (ROADMAP.md). Host only: no instrument accepts a device value."""

from ditl_tpu_torch.telemetry.registry import (
    LATENCY_BUCKETS_S,
    TOKEN_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "TOKEN_LATENCY_BUCKETS_S",
]
