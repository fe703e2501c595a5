"""Serving-side telemetry bundle.

One object carrying every per-request instrument the serving stack records —
latency histograms (queue-wait, TTFT, per-token decode, end-to-end) and the
operational counters (admissions, 429s, preemptions, degrade windows,
grammar-masked tokens, speculative accept/reject) — shared between
``infer/continuous.ContinuousEngine`` (which records on its scheduler ticks)
and ``infer/server.py`` (which records the lock-step path and renders
``/metrics``).

Semantics worth pinning (the vLLM-style contract, adapted to chunked ticks):

- **queue wait**: submit -> the admission that moved the request into a slot.
  A preemption-resume is NOT a second admission (the request never left the
  user's perspective of "running").
- **TTFT**: submit -> the harvest that delivered the first generated token to
  the host. Harvests happen once per decode tick, so TTFT is quantized by the
  tick (decode_chunk steps) — that IS when a streaming client can first see
  the token, so the quantization is honest, not an artifact.
- **per-token decode latency**: harvest-interval / tokens-in-chunk, observed
  once per token of the chunk. The histogram's shape answers "TPOT p50/p99".
- **grammar-masked tokens**: generated tokens whose request carried an FSM
  constraint — every one of those decode steps paid the mask gather.
- **speculative accepted/rejected**: accepted = drafted tokens the verify
  forward kept; rejected = drafted tokens it threw away. The per-round bonus
  token (emitted even at zero acceptance) is neither — it is ordinary decode
  output, counted by ``tokens_generated``.
- **prefix-cache hit/miss tokens**: at slot admission, prompt
  tokens whose KV came from the prefix cache (paged content-hash match or a
  registered contiguous prefix) count as hits; tokens the engine actually
  prefilled count as misses. Resume re-prefills after a preemption are
  NEITHER — the request already paid (and was credited) for its prompt at
  first admission; resume cost is thrash, tracked separately. The ratio
  gauge is recomputed from the counters at render time, and TTFT is
  additionally observed into a hit/miss split pair so "does a routed cache
  hit actually buy latency" is answerable from /metrics alone.

All increments are host-side floats/ints the scheduler already holds — zero
device syncs (registry.py's rule).
"""

from __future__ import annotations

import math
import time
from typing import Iterable, Sequence

from ditl_tpu_torch.telemetry.registry import (
    LATENCY_BUCKETS_S,
    Histogram,
    MetricsRegistry,
    TOKEN_LATENCY_BUCKETS_S,
)

__all__ = ["SLO_CLASS_NAMES", "ServingMetrics", "backlog_retry_after",
           "flattened_stats_lines", "merged_histogram",
           "serving_bench_summary", "snapshot_serving",
           "ttft_slo_violation_rate"]


def flattened_stats_lines(stats: dict, reserved: frozenset | set = frozenset(),
                          prefix: str = "ditl_serving") -> list[str]:
    """The /v1/stats snapshot flattened to ``<prefix>_<path>`` gauge lines
    (slot occupancy, queue depth, page pool, acceptance EMA) — point-in-
    time state, kept as gauges on purpose. ``reserved`` names registry
    metrics a flattened gauge must not shadow (e.g. the lifetime
    "preemptions" count, a real ``_total`` counter — exposing both a ``x``
    gauge and an ``x_total`` counter for the same fact invites dashboards
    built on the wrong one). Shared by ``infer/server.py``'s /metrics and
    the metrics-catalog drift guard (telemetry/catalog.py), so the
    exposition and the catalog cannot diverge silently."""
    lines: list[str] = []

    def emit(path: str, obj) -> None:
        if isinstance(obj, dict):
            for k, v in obj.items():
                emit(f"{path}_{k}" if path else str(k), v)
        elif f"{prefix}_{path}" in reserved:
            return
        elif isinstance(obj, bool):
            lines.append(f"# TYPE {prefix}_{path} gauge")
            lines.append(f"{prefix}_{path} {int(obj)}")
        elif isinstance(obj, (int, float)) and obj == obj:  # drop NaN
            lines.append(f"# TYPE {prefix}_{path} gauge")
            lines.append(f"{prefix}_{path} {obj}")
        # strings (engine/cache_mode names) have no gauge form; skip

    emit("", stats)
    return lines


def backlog_retry_after(
    samples: Iterable[tuple[float, float]],
    backlog: int,
    *,
    floor: int = 1,
    now: float | None = None,
    max_age_s: float = 60.0,
    clamp_s: int = 30,
    slo_class: str = "",
) -> int:
    """Backlog-aware ``Retry-After``: seconds until ``backlog`` requests
    clear at the recently measured service rate, clamped to
    ``[max(1, floor), clamp_s]``. ``samples`` are ``(wall_time,
    cumulative_completed)`` pairs; only the last ``max_age_s`` worth count —
    an hour-old sample would otherwise collapse the measured rate to ~zero
    and send a trivial backlog straight to the clamp. With no measurable
    rate (cold start, burst before the first completion) the estimate
    degrades to one second per backlogged request — still
    backlog-proportional, so client herds honoring Retry-After
    (client/llm.py) space out instead of synchronizing. Shared by
    ``infer/server.py`` (per-replica 429s) and ``gateway/gateway.py``
    (fleet-level 429s); jax-free like everything in telemetry/.

    ``slo_class`` is the scheduling class hint: for ``best_effort`` the
    clamp relaxes 4x and the floor's urgency is dropped. The interactive
    clamp exists so a latency-sensitive client retries soon after a
    transient spike — but a bulk submitter bounced off a deep offline
    backlog should come back when the backlog has actually moved, not
    hammer the fleet every ``clamp_s`` seconds. The estimate itself is
    unchanged: callers pass bulk-lane samples/backlog for bulk 429s."""
    now = time.time() if now is None else now
    if slo_class == "best_effort":
        clamp_s = clamp_s * 4
        floor = 1
    # Callers pass a LIVE deque that other handler threads append to
    # mid-overload (exactly when 429s fire); tuple() snapshots it in one
    # C-level pass, where iterating directly would raise "deque mutated
    # during iteration".
    recent = [(t, c) for t, c in tuple(samples) if now - t <= max_age_s]
    rate = 0.0
    if len(recent) >= 2:
        (t0, c0), (t1, c1) = recent[0], recent[-1]
        if t1 - t0 >= 0.5 and c1 > c0:
            rate = (c1 - c0) / (t1 - t0)
    estimate = backlog / rate if rate > 0 else float(1 + backlog)
    return max(1, floor, min(clamp_s, math.ceil(estimate)))

PREFIX = "ditl_serving"

# Mirror of infer/continuous.SLO_CLASSES' names — duplicated (not imported)
# so telemetry/ stays jax-free on import, like gateway/admission.py's copy;
# all three surfaces are pinned equal by test.
SLO_CLASS_NAMES = ("interactive", "batch", "best_effort")


class ServingMetrics:
    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self.queue_wait = r.histogram(
            f"{PREFIX}_request_queue_wait_seconds",
            "submit -> slot admission", LATENCY_BUCKETS_S,
        )
        self.ttft = r.histogram(
            f"{PREFIX}_request_ttft_seconds",
            "submit -> first generated token harvested", LATENCY_BUCKETS_S,
        )
        self.decode_token = r.histogram(
            f"{PREFIX}_decode_token_seconds",
            "per-token decode latency (harvest interval / chunk tokens)",
            TOKEN_LATENCY_BUCKETS_S,
        )
        self.e2e = r.histogram(
            f"{PREFIX}_request_e2e_seconds",
            "submit -> request finished", LATENCY_BUCKETS_S,
        )
        self.requests = r.counter(
            f"{PREFIX}_requests", "requests accepted by submit")
        self.admitted = r.counter(
            f"{PREFIX}_requests_admitted", "requests admitted into a slot")
        self.completed = r.counter(
            f"{PREFIX}_requests_completed", "requests finished")
        self.queue_full = r.counter(
            f"{PREFIX}_queue_full", "submissions rejected QueueFull (HTTP 429)")
        self.preemptions = r.counter(
            f"{PREFIX}_preemptions",
            "optimistic-admission preemptions (pages reclaimed mid-flight)")
        self.admission_degrades = r.counter(
            f"{PREFIX}_admission_degrade_windows",
            "tick windows that engaged the anti-thrash admission degrade")
        self.grammar_masked = r.counter(
            f"{PREFIX}_grammar_masked_tokens",
            "generated tokens decoded under an FSM grammar mask")
        self.spec_accepted = r.counter(
            f"{PREFIX}_spec_accepted_tokens",
            "speculative drafted tokens accepted by verify forwards")
        self.spec_rejected = r.counter(
            f"{PREFIX}_spec_rejected_tokens",
            "speculative drafted tokens rejected by verify forwards")
        self.tokens_generated = r.counter(
            f"{PREFIX}_tokens_generated", "tokens generated (all requests)")
        self.tpot_interference = r.histogram(
            f"{PREFIX}_tpot_interference_seconds",
            "per-tick decode delay a victim request absorbed because the "
            "tick also ran another request's prefill chunk(s) — the "
            "scheduler-interference signal behind chunked-prefill tuning "
            "(the prefill/decode mix)", TOKEN_LATENCY_BUCKETS_S,
        )
        self.deadline_expired = r.counter(
            f"{PREFIX}_deadline_expired",
            "requests evicted from the queue/slots at their deadline "
            "(expired work stops consuming engine ticks)")
        self.client_disconnects = r.counter(
            f"{PREFIX}_client_disconnects",
            "in-flight generations cancelled because the client vanished "
            "mid-stream")
        # -- prefix-cache accounting -------------------------------------
        self.prefix_cache_hit_tokens = r.counter(
            f"{PREFIX}_prefix_cache_hit_tokens",
            "prompt tokens whose KV was reused from the prefix cache at "
            "slot admission (paged content-hash match or registered prefix)")
        self.prefix_cache_miss_tokens = r.counter(
            f"{PREFIX}_prefix_cache_miss_tokens",
            "prompt tokens the engine prefilled because no cached KV "
            "covered them")
        self.prefix_cache_evictions = r.counter(
            f"{PREFIX}_prefix_cache_evictions",
            "published prefix pages reclaimed by LRU eviction under pool "
            "pressure")
        self.prefix_cache_hit_ratio = r.gauge(
            f"{PREFIX}_prefix_cache_hit_ratio",
            "measured hit tokens / (hit + miss) tokens — the number the "
            "gateway affinity router's score is validated against")
        self.ttft_cache_hit = r.histogram(
            f"{PREFIX}_request_ttft_cache_hit_seconds",
            "TTFT of requests whose prompt hit the prefix cache (>= 1 "
            "reused token)", LATENCY_BUCKETS_S,
        )
        self.ttft_cache_miss = r.histogram(
            f"{PREFIX}_request_ttft_cache_miss_seconds",
            "TTFT of requests whose prompt missed the prefix cache "
            "entirely", LATENCY_BUCKETS_S,
        )
        # -- tiered hits + host tier + KV handoff -------------------------
        # The total hit counters above stay the total aggregate; the tier
        # split says WHERE the reuse came from — an HBM match, a host-RAM
        # swap-in, or a shipped prefill-handoff page. Host hits cost a
        # device_put (the swap-in histogram), so conflating them with HBM
        # hits would hide exactly the churn the tier absorbs.
        self.prefix_cache_hit_tokens_by_tier = {
            tier: r.counter(
                f"{PREFIX}_prefix_cache_hit_tokens_{tier}",
                f"prompt tokens reused via the {tier} tier "
                f"({desc})",
            )
            for tier, desc in (
                ("hbm", "published pages resident in the device pool"),
                ("host", "pages swapped back in from the host-RAM tier"),
                ("handoff", "pages shipped by a prefill->decode handoff"),
            )
        }
        self.host_tier_swap_in = r.histogram(
            f"{PREFIX}_host_tier_swap_in_seconds",
            "host-tier swap-in latency per admission (crc verify + "
            "device_put + republish of the matched run)",
            LATENCY_BUCKETS_S,
        )
        self.host_tier_spilled_pages = r.counter(
            f"{PREFIX}_host_tier_spilled_pages",
            "LRU-evicted published pages spilled into the host-RAM tier")
        self.host_tier_swapped_pages = r.counter(
            f"{PREFIX}_host_tier_swapped_pages",
            "host-tier pages swapped back into the device pool on an "
            "admission miss")
        self.host_tier_dropped_pages = r.counter(
            f"{PREFIX}_host_tier_dropped_pages",
            "spill pages dropped (tier cap, oversized entry, or an "
            "injected kvtier.spill fault)")
        self.host_tier_corrupt_entries = r.counter(
            f"{PREFIX}_host_tier_corrupt_entries",
            "host-tier entries whose crc32 failed at swap-in — detected, "
            "dropped, and re-prefilled; never served")
        self.host_tier_evictions = r.counter(
            f"{PREFIX}_host_tier_evictions",
            "host-tier entries LRU-evicted under the size cap")
        self.kv_handoff_imports = r.counter(
            f"{PREFIX}_kv_handoff_imports",
            "prefill->decode KV blobs imported by this replica")
        self.kv_handoff_tokens = r.counter(
            f"{PREFIX}_kv_handoff_tokens",
            "prompt tokens installed from shipped prefill-handoff pages")
        self.kv_handoff_rejected = r.counter(
            f"{PREFIX}_kv_handoff_rejected",
            "KV handoff blobs rejected (torn/short read, crc mismatch, or "
            "geometry mismatch) — reject-don't-install")
        # -- per-SLO-class splits -----------------------------------------
        # The disaggregated-serving A/B is graded on INTERACTIVE latency
        # specifically (batch work is supposed to absorb the prefill
        # burden), so TTFT and scheduler interference split by the
        # request's class. The unsplit histograms above remain the
        # all-traffic aggregate.
        self.ttft_by_class = {
            cls: r.histogram(
                f"{PREFIX}_request_ttft_{cls}_seconds",
                f"TTFT of {cls}-class requests", LATENCY_BUCKETS_S,
            )
            for cls in SLO_CLASS_NAMES
        }
        self.interference_by_class = {
            cls: r.histogram(
                f"{PREFIX}_tpot_interference_{cls}_seconds",
                f"per-tick decode delay absorbed by {cls}-class victims "
                "because the tick also ran another request's prefill",
                TOKEN_LATENCY_BUCKETS_S,
            )
            for cls in SLO_CLASS_NAMES
        }

    def note_prefix_cache(self, hit_tokens: int, miss_tokens: int,
                          host_tokens: int = 0,
                          handoff_tokens: int = 0) -> None:
        """Record one admission's reused-vs-prefilled prompt token split.
        ``host_tokens`` / ``handoff_tokens`` attribute part of the hit to
        the host-RAM tier / a shipped handoff; the remainder is
        an HBM hit. The total counters keep their total semantics exactly."""
        if hit_tokens > 0:
            self.prefix_cache_hit_tokens.inc(hit_tokens)
            tiers = self.prefix_cache_hit_tokens_by_tier
            hbm = hit_tokens - host_tokens - handoff_tokens
            if hbm > 0:
                tiers["hbm"].inc(hbm)
            if host_tokens > 0:
                tiers["host"].inc(host_tokens)
            if handoff_tokens > 0:
                tiers["handoff"].inc(handoff_tokens)
        if miss_tokens > 0:
            self.prefix_cache_miss_tokens.inc(miss_tokens)

    def cache_hit_ratio(self) -> float | None:
        """hit / (hit + miss) tokens; None before any admission."""
        hit = self.prefix_cache_hit_tokens.value
        total = hit + self.prefix_cache_miss_tokens.value
        if total == 0:
            return None
        return hit / total

    def _refresh_derived(self) -> None:
        ratio = self.cache_hit_ratio()
        if ratio is not None:
            self.prefix_cache_hit_ratio.set(round(ratio, 6))

    def render(self) -> str:
        self._refresh_derived()
        return self.registry.render()

    def summary(self) -> dict:
        self._refresh_derived()
        return self.registry.summary()


def merged_histogram(hists: Sequence[Histogram]) -> Histogram:
    """One histogram holding every input's observations (identical bucket
    ladders required) — how fleet-level quantiles are computed from
    per-replica instruments without a shared registry (bench.py embeds
    the p50/p95 of the merged interference histogram, not a quantile of
    per-replica quantiles, which would not be a quantile of anything)."""
    if not hists:
        raise ValueError("need at least one histogram to merge")
    buckets = hists[0].buckets
    out = Histogram("_merged", buckets=buckets)
    for h in hists:
        if h.buckets != buckets:
            raise ValueError(
                f"bucket ladders differ: {h.buckets} vs {buckets}"
            )
        for i, c in enumerate(h._counts):
            out._counts[i] += c
        out._sum += h._sum
        out._count += h._count
    return out


def _hist_snap(hists: Sequence[Histogram]) -> list:
    return [(list(h._counts), h.sum, h.count) for h in hists]


def snapshot_serving(bundles: Sequence["ServingMetrics"]) -> dict:
    """Cumulative snapshot of the instruments ``serving_bench_summary``
    consumes — taken AFTER warm-up so the gated summary covers only the
    timed region (warm-up TTFTs are compile seconds, and their prompt
    misses deflate the hit ratio; both would corrupt the perf_compare
    gate)."""
    return {
        "interference": _hist_snap([b.tpot_interference for b in bundles]),
        "ttft": _hist_snap([b.ttft for b in bundles]),
        "ttft_by_class": {
            cls: _hist_snap([b.ttft_by_class[cls] for b in bundles])
            for cls in SLO_CLASS_NAMES
        },
        "interference_by_class": {
            cls: _hist_snap([b.interference_by_class[cls] for b in bundles])
            for cls in SLO_CLASS_NAMES
        },
        "hit": sum(b.prefix_cache_hit_tokens.value for b in bundles),
        "miss": sum(b.prefix_cache_miss_tokens.value for b in bundles),
        "evictions": sum(
            b.prefix_cache_evictions.value for b in bundles
        ),
        # Tiered-hit + swap-in accounting: timed-region scoping
        # for the host-tier block the bench rows embed.
        "tier_hit": {
            tier: sum(
                b.prefix_cache_hit_tokens_by_tier[tier].value
                for b in bundles
            )
            for tier in ("hbm", "host", "handoff")
        },
        "swap_in": _hist_snap([b.host_tier_swap_in for b in bundles]),
    }


def _subtract(hist: Histogram, snaps) -> None:
    for counts, s, c in snaps:
        for i, v in enumerate(counts):
            hist._counts[i] -= v
        hist._sum -= s
        hist._count -= c


def serving_bench_summary(bundles: Sequence["ServingMetrics"],
                          since: dict | None = None) -> dict:
    """The serving block a ``bench.py --serve-*`` row embeds:
    fleet-merged interference quantiles plus the measured
    prefix-cache hit ratio, flat numeric keys so
    ``telemetry/perf_compare.py`` can gate them like train metrics.
    ``since`` (a :func:`snapshot_serving` taken after warm-up) restricts
    every number to the timed region. Per-SLO-class TTFT/interference p95s
    ride along as ``<class>_ttft_p95_s`` /
    ``<class>_interference_p95_s`` — the interactive pair is what the
    disaggregated-fleet A/B is perf_compare-gated on."""
    interference = merged_histogram([b.tpot_interference for b in bundles])
    ttft = merged_histogram([b.ttft for b in bundles])
    by_class = {
        cls: (merged_histogram([b.ttft_by_class[cls] for b in bundles]),
              merged_histogram(
                  [b.interference_by_class[cls] for b in bundles]))
        for cls in SLO_CLASS_NAMES
    }
    hit = sum(b.prefix_cache_hit_tokens.value for b in bundles)
    miss = sum(b.prefix_cache_miss_tokens.value for b in bundles)
    evictions = sum(b.prefix_cache_evictions.value for b in bundles)
    tier_hit = {
        tier: sum(
            b.prefix_cache_hit_tokens_by_tier[tier].value for b in bundles
        )
        for tier in ("hbm", "host", "handoff")
    }
    swap_in = merged_histogram([b.host_tier_swap_in for b in bundles])
    if since is not None:
        _subtract(interference, since["interference"])
        _subtract(ttft, since["ttft"])
        for cls, (t_h, i_h) in by_class.items():
            _subtract(t_h, since["ttft_by_class"][cls])
            _subtract(i_h, since["interference_by_class"][cls])
        hit -= since["hit"]
        miss -= since["miss"]
        evictions -= since["evictions"]
        # Older snapshots (older sweep records) carry no tier keys.
        for tier, v in since.get("tier_hit", {}).items():
            tier_hit[tier] -= v
        if "swap_in" in since:
            _subtract(swap_in, since["swap_in"])
    out = {
        "interference_count": interference.count,
        "interference_total_s": round(interference.sum, 6),
        "prefix_cache_hit_tokens": int(hit),
        "prefix_cache_miss_tokens": int(miss),
        "prefix_cache_evictions": int(evictions),
    }
    tq = ttft.quantile(0.95)
    out["ttft_p95_s"] = round(tq, 6) if tq is not None else None
    for q, key in ((0.5, "interference_p50_s"), (0.95, "interference_p95_s")):
        v = interference.quantile(q)
        out[key] = round(v, 6) if v is not None else None
    for cls, (t_h, i_h) in by_class.items():
        tv, iv = t_h.quantile(0.95), i_h.quantile(0.95)
        out[f"{cls}_ttft_p95_s"] = round(tv, 6) if tv is not None else None
        out[f"{cls}_interference_p95_s"] = (
            round(iv, 6) if iv is not None else None
        )
        out[f"{cls}_interference_count"] = i_h.count
    if hit + miss > 0:
        out["prefix_cache_hit_ratio"] = round(hit / (hit + miss), 4)
        # Host-tier hit ratio: host-attributed reuse over ALL
        # prompt tokens — the fraction of the working set the tier (not
        # HBM) carried. 0.0 with the tier off, so perf_compare skips it
        # on an off-leg (a == 0 never gates) and gates it round-over-round
        # on tier-armed rows.
        out["host_tier_hit_ratio"] = round(
            tier_hit["host"] / (hit + miss), 4
        )
        out["tier_hit_tokens"] = dict(tier_hit)
    sq = swap_in.quantile(0.95)
    out["swap_in_count"] = swap_in.count
    out["swap_in_p95_s"] = round(sq, 6) if sq is not None else None
    return out


def ttft_slo_violation_rate(bundles: Sequence["ServingMetrics"],
                            threshold_s: float,
                            since: dict | None = None,
                            slo_class: str = "interactive") -> float | None:
    """Fraction of timed-region TTFT observations ABOVE ``threshold_s``
    (the threshold snaps DOWN to the histogram ladder, the /slo
    convention) — the "interactive SLO burn" number the autoscaler A/B
    row embeds and perf_compare gates: scaling down must not
    buy replica-seconds with burned TTFT budget. Computed over the
    ``slo_class`` split by default (unclassed requests schedule — and
    record — as interactive, so they are covered; batch work has no TTFT
    SLO and must not mask or trip the gate); pass ``slo_class=None`` for
    the all-class rate. ``since`` is a :func:`snapshot_serving`
    restricting to the timed region; None when nothing was observed
    (absent != 0)."""
    if slo_class is None:
        ttft = merged_histogram([b.ttft for b in bundles])
        if since is not None:
            _subtract(ttft, since["ttft"])
    else:
        ttft = merged_histogram([b.ttft_by_class[slo_class]
                                 for b in bundles])
        if since is not None:
            _subtract(ttft, since["ttft_by_class"][slo_class])
    if ttft.count <= 0:
        return None
    good, effective = ttft.count_le(threshold_s)
    if effective is None:
        return None
    return round(1.0 - good / ttft.count, 4)
