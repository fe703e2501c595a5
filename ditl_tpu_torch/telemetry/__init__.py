"""Telemetry: copies of the JAX package's jax-free telemetry modules, under
the same names. The process-local metrics registry (``registry.py``), the
serving instrument bundle (``serving.py``), the cross-process JSONL event
journal (``journal.py``), end-to-end request tracing (``tracing.py``),
Chrome-trace export (``trace_export.py``), SLO burn-rate monitoring
(``slo.py``) and the always-on flight-recorder rings (``flight.py``). The
rest of the reference's telemetry (goodput, HBM accounting, the anomaly and
incident plane, usage metering, the performance observatory, profiling) is
not ported yet (ROADMAP.md). Host only: no instrument accepts a device
value."""

from ditl_tpu_torch.telemetry.flight import (
    LIVENESS_RING,
    ROUTING_RING,
    STEP_RING,
    TICK_RING,
    FlightRecorder,
    FlightRing,
)
from ditl_tpu_torch.telemetry.journal import (
    EventJournal,
    controller_journal_path,
    merge_journals,
    read_journal,
    worker_journal_path,
    write_pod_timeline,
)
from ditl_tpu_torch.telemetry.registry import (
    LATENCY_BUCKETS_S,
    TOKEN_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from ditl_tpu_torch.telemetry.serving import ServingMetrics
from ditl_tpu_torch.telemetry.slo import (
    BurnRateMonitor,
    Objective,
    gateway_slo,
    serving_slo,
)
from ditl_tpu_torch.telemetry.tracing import (
    NULL_TRACER,
    Span,
    SpanContext,
    Tracer,
    format_traceparent,
    new_request_id,
    parse_traceparent,
)

__all__ = [
    "BurnRateMonitor",
    "Counter",
    "EventJournal",
    "FlightRecorder",
    "FlightRing",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "LIVENESS_RING",
    "MetricsRegistry",
    "NULL_TRACER",
    "Objective",
    "ROUTING_RING",
    "STEP_RING",
    "ServingMetrics",
    "Span",
    "SpanContext",
    "TICK_RING",
    "TOKEN_LATENCY_BUCKETS_S",
    "Tracer",
    "controller_journal_path",
    "format_traceparent",
    "gateway_slo",
    "merge_journals",
    "new_request_id",
    "parse_traceparent",
    "read_journal",
    "serving_slo",
    "worker_journal_path",
    "write_pod_timeline",
]
