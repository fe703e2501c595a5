"""Always-on flight recorder: bounded, lock-cheap,
jax-free ring buffers holding the most recent high-resolution host state —
the black box the incident plane dumps the moment a detector fires.

Every observability layer before this one is either *aggregated* (metrics:
you know the deadline-expiry COUNT, not which ticks expired whom) or
*unbounded* (journals rotate, but span records are per-request and the
interesting 30 seconds may already be three segments gone). The flight
recorder is the third shape: per-tick / per-request / per-step rows kept in
fixed-size rings, recorded unconditionally, read only when something goes
wrong. Cost discipline:

- **Zero device syncs.** Rows are plain host dicts of values the caller
  already holds (scheduler counters, wall clocks, host floats fetched by an
  existing flush). Handing a ring a device array is a caller bug, same rule
  as the metrics registry.
- **Lock-cheap recording.** A record is one dict build plus one
  ``deque.append`` — appends on a bounded deque are atomic under the GIL,
  so the hot path takes no lock. The registry lock covers ring
  *creation* only (get-or-create, like MetricsRegistry).
- **Bounded by construction.** Each ring holds at most ``capacity`` rows
  (``deque(maxlen=...)``); a month-long serving run holds the same memory
  as a minute-long one.
- **Dumped only on trigger.** Nothing iterates a ring on the metrics
  scrape path or the scheduler path; ``dump()`` runs when an incident
  bundle is assembled (telemetry/incident.py) — the tier-1 drill pins that
  ``/metrics`` never touches a ring.

Standard ring names (shared between recorders and bundle readers so a
bundle's ``flight/engine_tick.jsonl`` means the same thing everywhere):
``TICK_RING`` (continuous-engine per-tick snapshots), ``ROUTING_RING``
(gateway per-request routing decisions), ``STEP_RING`` (trainer per-step
rows), ``LIVENESS_RING`` (elastic-controller liveness events).
"""

from __future__ import annotations

import collections
import threading
import time

from ditl_tpu_torch.annotations import hot_path

__all__ = [
    "ACTION_RING",
    "BULK_RING",
    "FLIGHT_SCHEMA",
    "LIVENESS_RING",
    "ROUTING_RING",
    "STEP_RING",
    "TICK_RING",
    "FlightRecorder",
    "FlightRing",
]

# Stamped into every incident bundle so a reader of an old artifact knows
# which row vocabulary produced it.
FLIGHT_SCHEMA = 1

TICK_RING = "engine_tick"
ROUTING_RING = "gateway_routing"
STEP_RING = "train_step"
LIVENESS_RING = "pod_liveness"
# Autoscale/remediation actions: one row when an action is
# planned and one per terminal outcome (executed/refused/failed/dry_run),
# each carrying the triggering signal snapshot — the black-box record that
# makes a bad remediation as diagnosable as the failure it chased.
ACTION_RING = "supervisor_action"
# Bulk-lane dispatch decisions: one row per work-item dispatch
# attempt (job, idx, attempt, outcome, tenant) — the ROUTING-ring
# discipline applied to the offline lane, so an incident bundle shows
# exactly which items the lane pushed and what the fleet answered.
BULK_RING = "bulk_dispatch"

DEFAULT_CAPACITY = 512


class FlightRing:
    """One bounded ring of recent rows. ``record`` is the hot path: a dict
    build plus an atomic bounded-deque append — no lock, no allocation
    growth. ``recorded`` counts lifetime rows so a dump can say how many
    rows the ring's horizon dropped."""

    __slots__ = ("name", "capacity", "recorded", "_ring")

    def __init__(self, name: str, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.recorded = 0
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    @hot_path
    def record(self, _ts: float | None = None, **row) -> None:
        """Append one row (stamped with the wall clock unless ``_ts``
        overrides it — callers batching rows from an existing host flush
        backdate them to when the work happened)."""
        row["ts"] = time.time() if _ts is None else _ts
        self._ring.append(row)
        self.recorded += 1

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self) -> list[dict]:
        """Snapshot the ring oldest-first. ``list(deque)`` is one C-level
        pass, safe against concurrent appends (the same snapshot rule
        backlog_retry_after uses on its live deque)."""
        return list(self._ring)


class FlightRecorder:
    """Name -> ring registry for one process. ``ring()`` is get-or-create
    (idempotent per name) so independent call sites — engine tick loop,
    HTTP handlers, the pod controller — share a ring without plumbing
    references, exactly like MetricsRegistry instruments."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rings: dict[str, FlightRing] = {}  # guarded-by: _lock
        self._lock = threading.Lock()  # ring creation only, never records

    def ring(self, name: str, capacity: int | None = None) -> FlightRing:
        # ditl: allow(lock-discipline) -- double-checked fast path: a racy dict read returns either the ring or None (GIL-whole), and None falls through to the locked create
        ring = self._rings.get(name)
        if ring is not None:
            return ring
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                ring = FlightRing(name, capacity or self.capacity)
                self._rings[name] = ring
            return ring

    def rings(self) -> dict[str, FlightRing]:
        with self._lock:
            return dict(self._rings)

    def dump_all(self) -> dict[str, list[dict]]:
        """{ring name: rows oldest-first} for every ring that recorded
        anything — the incident bundle's ``flight/`` payload."""
        return {
            name: ring.dump()
            for name, ring in sorted(self.rings().items())
            if len(ring)
        }
