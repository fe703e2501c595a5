"""End-to-end request tracing: a jax-free span layer
threaded through every hop a serving request takes — gateway relay (retries
and hedged attempts as sibling spans), ``infer/server.py`` request handling,
and the continuous engine's request lifecycle (queue-wait -> admission ->
prefill chunk(s) -> decode chunks -> harvest -> stream-write).

Span model:

- A **trace** is one client request's end-to-end story, identified by a
  32-hex ``trace_id``. Every process touching the request appends its own
  spans (tagged with that trace_id) to its OWN per-process JSONL journal
  (telemetry/journal.py) — no cross-process coordination, the same rule the
  event journal already follows. ``trace_export.py`` merges by trace_id.
- A **span** is one timed hop (16-hex ``span_id``, optional ``parent``
  span_id). Spans are written as ONE journal line at ``end()`` carrying the
  start ``ts`` and measured ``dur_s`` — a SIGKILLed process loses only its
  open spans, never corrupts closed ones.
- **Propagation** over HTTP rides the W3C ``traceparent`` header
  (``00-<trace_id>-<span_id>-01``): the gateway stamps each relay attempt's
  span context on the upstream request, the replica's server continues the
  trace, and the engine parents its lifecycle spans under the server span —
  so the merged trace nests across process boundaries.
- **Instants** (``trace.instant`` records, e.g. the engine's per-tick
  marker) are zero-duration points on a process's track.

Cost discipline: a ``Tracer`` with no journal is **unarmed** — span writes
are skipped entirely, but span/trace IDs are still generated so propagation
works through an unarmed hop (a gateway without a journal still hands the
replica a coherent trace). All clocks are wall (``time.time``) because the
merged timeline spans processes; durations measured by the caller may come
from monotonic clocks and are passed through as-is.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import Any

from ditl_tpu_torch.telemetry.journal import EventJournal

__all__ = [
    "NULL_TRACER",
    "Span",
    "SpanContext",
    "Tracer",
    "format_traceparent",
    "new_request_id",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "resolve_request_id",
    "sanitize_request_id",
]

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "X-Request-Id"

# Record keys owned by the span layer / journal; user attrs must not shadow
# them (shadowing would corrupt the export's field contract silently).
RESERVED_KEYS = frozenset(
    {"ts", "seq", "source", "pid", "event", "name", "trace", "span",
     "parent", "dur_s"}
)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)
_REQUEST_ID_SAFE = re.compile(r"[^A-Za-z0-9._:-]")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def new_request_id() -> str:
    return "req-" + os.urandom(8).hex()


def sanitize_request_id(raw: str | None) -> str | None:
    """A client-supplied X-Request-Id is echoed back verbatim into a
    response HEADER, so it must never smuggle CR/LF (header injection) or
    unbounded bytes: strip to a safe charset, cap the length, and reject
    empty results (the caller then generates one)."""
    if not raw:
        return None
    cleaned = _REQUEST_ID_SAFE.sub("", raw)[:128]
    return cleaned or None


def resolve_request_id(raw: str | None) -> str:
    """The one sanitize-or-generate rule both the gateway and the server
    apply to an incoming ``X-Request-Id`` header."""
    return sanitize_request_id(raw) or new_request_id()


@dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span (what ``traceparent`` carries)."""

    trace_id: str
    span_id: str


def format_traceparent(ctx: "SpanContext | Span") -> str:
    if isinstance(ctx, Span):
        ctx = ctx.context
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: str | None) -> SpanContext | None:
    """Parse a W3C ``traceparent`` header; None on anything malformed
    (wrong version handling per spec: version ff is invalid, other unknown
    versions are accepted on the version-00 field layout). All-zero ids are
    invalid per spec."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id)


class Span:
    """One timed hop. Mutable attrs accumulate via ``annotate`` and are
    written once at ``end()`` (idempotent — the first end wins)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "attrs",
                 "_tracer", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str, t0: float, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.attrs = attrs
        self._tracer = tracer
        self._ended = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)

    def annotate(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        """Instant child event on this span's trace."""
        self._tracer.instant(name, parent=self, **attrs)

    def end(self, t_end: float | None = None, **attrs: Any) -> None:
        """Write the span (one journal line). ``t_end`` overrides the end
        wall clock (callers that measured the hop on a monotonic clock pass
        ``t0 + measured_dur``). Safe to call twice — only the first writes."""
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self._tracer._write_span(self, t_end if t_end is not None
                                 else time.time())

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.attrs.setdefault("error", type(exc).__name__)
        self.end()


class Tracer:
    """Span factory over one process's ``EventJournal``. ``journal=None``
    leaves the tracer unarmed: spans still mint real ids (propagation keeps
    working through an unarmed hop) but nothing is written."""

    def __init__(self, journal: EventJournal | None = None):
        self.journal = journal

    @property
    def armed(self) -> bool:
        return self.journal is not None

    def start_span(
        self,
        name: str,
        parent: "Span | SpanContext | None" = None,
        *,
        trace_id: str | None = None,
        t0: float | None = None,
        **attrs: Any,
    ) -> Span:
        """Open a span. ``parent`` chains it (and inherits the trace);
        ``trace_id`` forces a trace for parentless spans; neither ->
        a fresh trace (this span is the root). ``t0`` backdates the start
        (wall clock) for spans created after the work they describe."""
        if parent is not None:
            p_trace = parent.trace_id
            p_span = parent.span_id
        else:
            p_trace = trace_id or new_trace_id()
            p_span = ""
        bad = RESERVED_KEYS.intersection(attrs)
        if bad:
            raise ValueError(f"span attrs shadow reserved keys: {sorted(bad)}")
        return Span(
            self, name, p_trace, new_span_id(), p_span,
            time.time() if t0 is None else float(t0), dict(attrs),
        )

    def instant(
        self,
        name: str,
        parent: "Span | SpanContext | None" = None,
        **attrs: Any,
    ) -> None:
        """Zero-duration point event on this process's track; with
        ``parent`` it is tagged onto that span's trace."""
        if self.journal is None:
            return
        bad = RESERVED_KEYS.intersection(attrs)
        if bad:
            raise ValueError(f"instant attrs shadow reserved keys: "
                             f"{sorted(bad)}")
        rec: dict[str, Any] = {"name": name, **attrs}
        if parent is not None:
            rec["trace"] = parent.trace_id
            rec["parent"] = parent.span_id
        self.journal.event("trace.instant", **rec)

    def _write_span(self, span: Span, t_end: float) -> None:
        if self.journal is None:
            return
        self.journal.event(
            "trace.span",
            _ts=span.t0,
            name=span.name,
            trace=span.trace_id,
            span=span.span_id,
            parent=span.parent_id,
            dur_s=round(max(0.0, t_end - span.t0), 6),
            **span.attrs,
        )


NULL_TRACER = Tracer(None)
