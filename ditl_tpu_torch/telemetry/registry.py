"""Process-local metrics registry: counters, gauges, fixed-bucket
histograms, rendered in Prometheus text exposition. A copy of the JAX
package's ``telemetry/registry.py`` (stdlib only).

Design rules:

- **No device syncs on the hot path.** Every instrument takes plain Python
  floats the caller already holds (wall-clock deltas, host counters); handing
  it a device tensor is a caller bug.
- **Lock-cheap increments.** Increments are plain int/float adds under the
  GIL, no lock on the hot path. A racing pair of increments can lose one
  update (telemetry-tolerable); values never go backwards, so the Prometheus
  monotonicity contract for counters and histogram buckets holds. ``render``
  reads a snapshot of the same fields; a scrape concurrent with an increment
  sees either the old or the new value, never a torn one.
- **Fixed buckets.** Histograms bucket at observe time into a fixed upper-
  bound ladder (no per-sample storage), so memory is O(buckets) whatever
  the request rate, and the exposition is the cumulative ``_bucket``/
  ``_sum``/``_count`` triple Prometheus expects.
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS_S",
    "TOKEN_LATENCY_BUCKETS_S",
]

# Request-scale latency ladder (seconds): sub-ms to the 60 s an overloaded
# queue can reach. Used for queue-wait / TTFT / end-to-end.
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Per-token decode ladder (seconds/token): decode steps live in the
# 100 us – 100 ms band; the tail covers CPU runs and pathology.
TOKEN_LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0,
)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integral floats print bare."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotonic counter. ``name`` is the logical name WITHOUT the
    ``_total`` suffix; render appends it to BOTH the sample and the
    ``# TYPE`` line — in the classic text format (``text/plain;
    version=0.0.4``, what /metrics serves) type metadata attaches to the
    exposed sample name, so ``# TYPE x counter`` + ``x_total`` would leave
    the series untyped (the OpenMetrics spelling, a different format)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._value += n

    @property
    def value(self) -> float:
        return self._value

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name}_total {self.help}")
        lines.append(f"# TYPE {self.name}_total counter")
        lines.append(f"{self.name}_total {_fmt(self._value)}")
        return lines


class Gauge:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} gauge")
        lines.append(f"{self.name} {_fmt(self._value)}")
        return lines


class Histogram:
    """Fixed-bucket histogram. ``buckets`` are finite upper bounds in
    increasing order; the implicit +Inf bucket is always present. Bucket
    counts are stored NON-cumulative (one int add per observe) and summed
    cumulatively only at render/quantile time — the exposition-side cost,
    not the hot path's."""

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = LATENCY_BUCKETS_S):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"buckets must be strictly increasing: {buckets}")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value`` (one bucket add — used by
        chunked harvests attributing a shared per-token latency to every
        token in the chunk)."""
        i = bisect.bisect_left(self.buckets, value)
        self._counts[i] += n
        self._sum += value * n
        self._count += n

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def count_le(self, bound: float) -> tuple[int, float | None]:
        """Cumulative observations in buckets whose upper bound is <=
        ``bound``, with the effective (snapped-down) bound — the exact
        question a fixed-bucket histogram can answer, used by the SLO
        burn-rate monitor (telemetry/slo.py) to count "requests under the
        latency threshold". ``(0, None)`` when ``bound`` sits below the
        first bucket (no bucket can answer it)."""
        i = bisect.bisect_right(self.buckets, bound)
        if i == 0:
            return 0, None
        return sum(self._counts[:i]), self.buckets[i - 1]

    def quantile(self, q: float) -> float | None:
        """Approximate quantile from the bucket ladder (linear interpolation
        within the bucket, Prometheus ``histogram_quantile`` style). None
        when empty; the top bucket's lower bound when the quantile lands in
        +Inf."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        counts = list(self._counts)
        total = sum(counts)
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                if i == len(self.buckets):  # +Inf bucket: no upper bound
                    return self.buckets[-1] if self.buckets else 0.0
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.buckets[-1] if self.buckets else 0.0

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        cum = 0
        for bound, c in zip(self.buckets, self._counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
        cum += self._counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {_fmt(self._sum)}")
        lines.append(f"{self.name}_count {cum}")
        return lines


class MetricsRegistry:
    """Name -> instrument registry. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent per name, type-checked), so independent call
    sites can share an instrument without plumbing references."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()  # registration only, never increments

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        buckets: tuple[float, ...] = LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def render(self) -> str:
        """Full Prometheus text exposition (no trailing newline; callers
        join sections and append one)."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines)

    def summary(self) -> dict:
        """Host-JSON snapshot for bench/stats embedding: counters/gauges as
        scalars; histograms as count/sum/p50/p99."""
        out: dict = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                if m.count:
                    out[name] = {
                        "count": m.count,
                        "sum_s": round(m.sum, 6),
                        "p50_s": round(m.quantile(0.5), 6),
                        "p99_s": round(m.quantile(0.99), 6),
                    }
            else:
                out[name] = m.value
        return out
