"""SLO objectives + multi-window burn-rate evaluation.
jax-free, zero hot-path cost by construction: instead of
instrumenting request paths, the monitor SAMPLES the cumulative
good/total counts the registry already holds (histogram bucket prefixes,
counters) whenever ``/slo`` or ``/metrics`` is scraped, and computes
windowed error rates from sample deltas — the scrape cadence IS the
sampling cadence, exactly how a Prometheus ``increase()`` would see it.

Definitions (the SRE-workbook shapes):

- An **objective** says "fraction ``target`` of requests must be good",
  where good is e.g. "TTFT <= threshold" or "request completed".
- **Error budget** = ``1 - target``.
- **Burn rate** over a window = (bad fraction in window) / budget. Burn 1.0
  consumes exactly the budget at steady state; 14.4 eats a 30-day budget in
  2 days.
- **Multi-window alerting**: the alert fires only when BOTH the fast and
  the slow window burn above ``burn_alert`` — the fast window gives
  responsiveness, the slow window de-flaps it.

Latency thresholds snap DOWN to the histogram's bucket ladder (the
cumulative bucket prefix is the only count the fixed-bucket histogram can
answer exactly); the effective threshold is reported so a dashboard never
silently grades against a different number than configured.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Callable

__all__ = [
    "BurnRateMonitor",
    "Objective",
    "gateway_slo",
    "serving_slo",
]


@dataclass(frozen=True)
class Objective:
    """One SLO: ``good_total()`` returns the CUMULATIVE (good, total)
    counts; ``threshold_s`` is the effective latency bound (None for
    availability-shaped objectives)."""

    name: str
    target: float
    good_total: Callable[[], tuple[float, float]]
    threshold_s: float | None = None
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r} target must be in (0, 1), got "
                f"{self.target} (a target of 1.0 has zero error budget — "
                "burn rate would be undefined)"
            )


class BurnRateMonitor:
    """Windowed burn-rate evaluation over cumulative counts.

    ``sample()`` appends one (now, {objective: (good, total)}) snapshot;
    ``report()`` samples, then for each window compares the newest snapshot
    against the newest snapshot at least one window old (falling back to
    the oldest held) — the standard counter-delta estimate. Samples older
    than the slow window (plus one guard sample) are pruned, so memory is
    O(scrapes per slow window)."""

    def __init__(
        self,
        objectives: list[Objective],
        *,
        windows: tuple[float, ...] = (300.0, 3600.0),
        burn_alert: float = 1.0,
        registry=None,
        gauge_prefix: str = "ditl_slo",
        journal=None,
        on_alert=None,
    ):
        if not objectives:
            raise ValueError("need at least one objective")
        if not windows or any(w <= 0 for w in windows):
            raise ValueError(f"windows must be positive seconds: {windows}")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.objectives = list(objectives)
        self.windows = tuple(sorted(float(w) for w in windows))
        self.burn_alert = float(burn_alert)
        self._samples: collections.deque = collections.deque()  # guarded-by: _lock
        # Concurrent scrapes (Prometheus on /metrics while a dashboard hits
        # /slo) reach the one shared monitor from different threads — the
        # handler threads of a ThreadingHTTPServer on replicas and the
        # threaded gateway, the offload-pool workers ("gw-offload") on the
        # evloop gateway, where the loop thread itself never runs handler
        # code. Either way two scrapes can overlap and would mutate the
        # deque mid-iteration in report(); sampling is scrape-path only,
        # so a plain lock costs nothing on the serving hot path.
        self._lock = threading.Lock()
        # Optional Prometheus surface: burn-rate gauges set at report()
        # time into the caller's registry, so /metrics carries the same
        # numbers /slo renders (dashboards alert off either).
        self._registry = registry
        self._gauge_prefix = gauge_prefix
        # Alert-transition hooks: burn alerts used to
        # exist only in the scrape response — a headless fleet never
        # recorded them. On the false->true transition of "every window
        # burning" the monitor journals an ``slo.alert`` event (the pod
        # timeline carries the burn even with no Prometheus anywhere) and
        # fires ``on_alert(objective_name, entry)`` — the anomaly plane's
        # trigger hook. Transitions, not levels: a sustained burn journals
        # once until it clears and re-fires.
        self._journal = journal
        self._on_alert = on_alert
        self._alerting: dict[str, bool] = {}  # guarded-by: _lock

    def sample(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        snap = {o.name: o.good_total() for o in self.objectives}
        with self._lock:
            self._sample_locked(now, snap)

    def _sample_locked(self, now: float, snap: dict) -> None:
        self._samples.append((now, snap))
        horizon = now - self.windows[-1]
        # Keep ONE sample at-or-before the horizon as the slow window's
        # baseline; prune the rest.
        while len(self._samples) >= 2 and self._samples[1][0] <= horizon:
            self._samples.popleft()

    @staticmethod
    def _baseline(samples: list, now: float, window: float):
        """Newest sample at least ``window`` old, else the oldest held
        (a short-lived process grades over its whole lifetime)."""
        cutoff = now - window
        base = samples[0]
        for ts, snap in samples:
            if ts <= cutoff:
                base = (ts, snap)
            else:
                break
        return base

    def any_alerting(self) -> bool:
        """True while ANY objective's multi-window alert is firing, as of
        the last report(). The autoscale planner reads this: a
        burning fleet must not be scaled down on a momentarily quiet
        pressure signal."""
        with self._lock:
            return any(self._alerting.values())

    def report(self, now: float | None = None) -> dict:
        """Sample, then render the full burn-rate evaluation (the ``/slo``
        endpoint's JSON body)."""
        now = time.time() if now is None else now
        snap = {o.name: o.good_total() for o in self.objectives}
        with self._lock:
            self._sample_locked(now, snap)
            samples = list(self._samples)  # snapshot: evaluate lock-free
        _, newest = samples[-1]
        out: dict = {
            "windows_s": list(self.windows),
            "burn_alert": self.burn_alert,
            "objectives": {},
        }
        for obj in self.objectives:
            good_now, total_now = newest[obj.name]
            entry: dict = {
                "target": obj.target,
                "error_budget": round(1.0 - obj.target, 6),
                "description": obj.description,
                "total": total_now,
                "windows": {},
            }
            if obj.threshold_s is not None:
                entry["threshold_s"] = obj.threshold_s
            burns: list[float | None] = []
            for window in self.windows:
                base_ts, base = self._baseline(samples, now, window)
                good_then, total_then = base[obj.name]
                d_total = total_now - total_then
                d_bad = (total_now - good_now) - (total_then - good_then)
                error_rate = (d_bad / d_total) if d_total > 0 else 0.0
                burn = (
                    error_rate / (1.0 - obj.target) if d_total > 0 else None
                )
                burns.append(burn)
                entry["windows"][f"{int(window)}s"] = {
                    "requests": d_total,
                    "errors": d_bad,
                    "error_rate": round(error_rate, 6),
                    "burn_rate": None if burn is None else round(burn, 4),
                    "span_s": round(now - base_ts, 3),
                }
                if self._registry is not None:
                    self._registry.gauge(
                        f"{self._gauge_prefix}_{obj.name}_burn_rate_w"
                        f"{int(window)}",
                        f"{obj.name} burn rate over {int(window)}s "
                        "(error rate / error budget)",
                    ).set(0.0 if burn is None else burn)
            # Multi-window rule: every window must be measurably burning.
            entry["alerting"] = bool(burns) and all(
                b is not None and b > self.burn_alert for b in burns
            )
            # Atomic check-and-set under the monitor lock: concurrent
            # report() callers (a scrape racing the anomaly monitor's
            # headless cadence) must not BOTH observe the false->true
            # transition and double-fire the journal/hook.
            with self._lock:
                was = self._alerting.get(obj.name, False)
                self._alerting[obj.name] = entry["alerting"]
            if entry["alerting"] and not was:
                if self._journal is not None:
                    self._journal.event(
                        "slo.alert", objective=obj.name,
                        target=obj.target, burn_alert=self.burn_alert,
                        burn_rates=[
                            None if b is None else round(b, 4) for b in burns
                        ],
                        windows_s=list(self.windows),
                    )
                if self._on_alert is not None:
                    try:
                        self._on_alert(obj.name, entry)
                    except Exception:  # noqa: BLE001 - a broken hook must
                        pass  # not break the scrape that evaluated it
            if self._registry is not None:
                self._registry.gauge(
                    f"{self._gauge_prefix}_{obj.name}_alerting",
                    f"1 when every window burns {obj.name}'s budget faster "
                    f"than {self.burn_alert}x",
                ).set(1.0 if entry["alerting"] else 0.0)
            out["objectives"][obj.name] = entry
        return out


def _latency_objective(name: str, hist, threshold_s: float, target: float,
                       description: str) -> Objective:
    """Latency SLO over a fixed-bucket histogram: good = observations in
    buckets whose upper bound <= threshold (snapped down to the ladder)."""
    count, effective = hist.count_le(threshold_s)
    del count
    if effective is None:
        raise ValueError(
            f"{name}: threshold {threshold_s}s is below the histogram's "
            f"first bucket ({hist.buckets[0]}s) — no bucket can answer it"
        )
    return Objective(
        name=name,
        target=target,
        good_total=lambda: (hist.count_le(threshold_s)[0], hist.count),
        threshold_s=effective,
        description=description
        + (f" (threshold snapped {threshold_s}s -> {effective}s)"
           if effective != threshold_s else ""),
    )


def serving_slo(
    metrics,
    *,
    ttft_s: float = 2.5,
    ttft_target: float = 0.95,
    tpot_s: float = 0.25,
    tpot_target: float = 0.95,
    availability_target: float = 0.999,
    windows: tuple[float, ...] = (300.0, 3600.0),
    burn_alert: float = 1.0,
    journal=None,
    on_alert=None,
) -> BurnRateMonitor:
    """The replica server's SLO set over its ``ServingMetrics`` bundle:
    TTFT and TPOT latency objectives (the engine's harvest-observed
    histograms) plus availability (completed vs queue-full 429s and
    deadline 504s — the failures the SERVER owes; client disconnects and
    cancels are the client's doing and don't burn the budget)."""

    def availability() -> tuple[float, float]:
        bad = metrics.queue_full.value + metrics.deadline_expired.value
        good = metrics.completed.value
        return good, good + bad

    return BurnRateMonitor(
        [
            _latency_objective(
                "ttft", metrics.ttft, ttft_s, ttft_target,
                "submit -> first harvested token",
            ),
            _latency_objective(
                "tpot", metrics.decode_token, tpot_s, tpot_target,
                "per-token decode latency",
            ),
            Objective(
                name="availability",
                target=availability_target,
                good_total=availability,
                description="completed vs server-owed failures "
                            "(queue-full 429s, deadline 504s)",
            ),
        ],
        windows=windows,
        burn_alert=burn_alert,
        registry=metrics.registry,
        journal=journal,
        on_alert=on_alert,
    )


def gateway_slo(
    gw_metrics,
    *,
    e2e_s: float = 10.0,
    e2e_target: float = 0.95,
    availability_target: float = 0.999,
    windows: tuple[float, ...] = (300.0, 3600.0),
    burn_alert: float = 1.0,
    journal=None,
    on_alert=None,
) -> BurnRateMonitor:
    """The gateway's fleet-level SLO set: end-to-end relay latency plus
    availability (relayed-to-completion vs fleet-owed failures: saturation
    429s, no-live-replica 503s, mid-stream aborts). Tenant throttles are
    the tenant's budget, not the fleet's, and are excluded on purpose."""

    def availability() -> tuple[float, float]:
        bad = (gw_metrics.saturated.value + gw_metrics.no_replica.value
               + gw_metrics.stream_aborts.value)
        good = gw_metrics.completed.value
        return good, good + bad

    return BurnRateMonitor(
        [
            _latency_objective(
                "e2e", gw_metrics.e2e, e2e_s, e2e_target,
                "gateway receive -> response relayed",
            ),
            Objective(
                name="availability",
                target=availability_target,
                good_total=availability,
                description="relayed-to-completion vs fleet-owed failures "
                            "(saturation 429s, no-replica 503s, stream "
                            "aborts)",
            ),
        ],
        windows=windows,
        burn_alert=burn_alert,
        registry=gw_metrics.registry,
        journal=journal,
        on_alert=on_alert,
    )
