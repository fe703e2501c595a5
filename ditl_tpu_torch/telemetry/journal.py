"""Structured JSONL event journal.

Typed events and wall-clock spans, one JSON object per line, append-only and
line-buffered so a SIGKILLed process loses at most the line it never wrote.
Each elastic-pod participant writes its OWN file (``events-controller.jsonl``,
``events-worker-N.jsonl``) — no cross-process locking, no torn lines — and
the pod controller merges them into one time-ordered pod timeline at the end
of a run, which is how "what happened, in order, when a worker died" becomes
a readable artifact instead of interleaved stderr archaeology.

Ordering: events are sorted by wall-clock ``ts`` with a per-file monotonic
``seq`` tiebreak. Wall clocks are shared here (one host per pod in this
repo's drills); cross-host skew would reorder only events closer together
than the skew, and the per-source ``seq`` keeps each process's own story
internally ordered regardless.

Size control: ``max_bytes`` arms rotation so a
long-lived serving process (span records arrive per request, tick instants
per scheduler tick) cannot grow its journal unboundedly. The journal
rotates into sibling segments named ``<stem>.rNNNN.jsonl`` — still matching
the ``events-*.jsonl`` merge glob, and carrying the SAME ``source`` and a
``seq`` that keeps counting, so ``merge_journals`` orders rotated segments
correctly with no special casing. Total footprint is bounded: each segment
caps at ``max_bytes // KEEP_SEGMENTS`` and only the newest
``KEEP_SEGMENTS - 1`` rotated segments are kept (the oldest is deleted),
so disk usage stays ~``max_bytes`` while the newest events always survive.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time

__all__ = [
    "EventJournal",
    "controller_journal_path",
    "worker_journal_path",
    "read_journal",
    "merge_journals",
    "write_pod_timeline",
]

TIMELINE_FILENAME = "pod_timeline.jsonl"

# Rotation keeps this many segments (the live file + KEEP_SEGMENTS - 1
# rotated ones), each capped at max_bytes / KEEP_SEGMENTS.
KEEP_SEGMENTS = 4


def controller_journal_path(directory: str) -> str:
    return os.path.join(directory, "events-controller.jsonl")


def worker_journal_path(directory: str, process_index: int) -> str:
    return os.path.join(directory, f"events-worker-{process_index}.jsonl")


class EventJournal:
    """Append-only JSONL event writer for ONE process. Writes are
    lock-serialized: serving hands one journal to many HTTP handler threads
    (span records), and interleaved partial writes would tear lines."""

    def __init__(self, path: str, source: str = "",
                 max_bytes: int | None = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.source = source or os.path.basename(path).rsplit(".", 1)[0]
        if max_bytes is not None and max_bytes <= 0:
            max_bytes = None
        self.max_bytes = max_bytes
        self._segment_bytes = (
            max(4096, max_bytes // KEEP_SEGMENTS) if max_bytes else None
        )
        # Resume the segment counter from what is already on disk: a
        # relaunched process (elastic worker, restarted replica) reuses the
        # same journal path, and restarting at 0 would os.replace() onto —
        # and silently destroy — the previous incarnation's rotated
        # segments while they are still inside the keep budget.
        self._rotated = 0
        if self._segment_bytes is not None:
            stem, ext = os.path.splitext(self.path)
            for p in glob.glob(f"{stem}.r[0-9][0-9][0-9][0-9]{ext}"):
                try:
                    n = int(p[len(stem) + 2: len(p) - len(ext)])
                except ValueError:
                    continue
                self._rotated = max(self._rotated, n)
        self._seq = 0
        self._lock = threading.Lock()
        # Line-buffered append: one write per event, durable up to the last
        # whole line even through SIGKILL.
        self._fh = open(path, "a", buffering=1)
        self._bytes = self._fh.tell()

    def _rotated_path(self, n: int) -> str:
        stem, ext = os.path.splitext(self.path)
        return f"{stem}.r{n:04d}{ext}"

    def _maybe_rotate(self, incoming: int) -> None:
        """Called under the lock, before a write: when the live segment
        would exceed its cap, rename it to the next rotated-segment name and
        start fresh, deleting segments that age out of the keep budget."""
        if self._segment_bytes is None or self._bytes == 0:
            return
        if self._bytes + incoming <= self._segment_bytes:
            return
        self._fh.close()
        self._rotated += 1
        os.replace(self.path, self._rotated_path(self._rotated))
        expired = self._rotated - (KEEP_SEGMENTS - 1)
        if expired >= 1:
            with contextlib.suppress(OSError):
                os.remove(self._rotated_path(expired))
        self._fh = open(self.path, "a", buffering=1)
        self._bytes = 0

    def event(self, event: str, _ts: float | None = None, **attrs) -> dict:
        """Record one instantaneous event; returns the record written.
        ``_ts`` overrides the stamped wall clock — span records
        (telemetry/tracing.py) are written at END but stamped with their
        START so the merged timeline orders them where they began."""
        base = {
            "ts": time.time() if _ts is None else _ts,
            "source": self.source,
            "pid": os.getpid(),
            "event": event,
            **attrs,
        }
        with self._lock:
            rec = {**base, "seq": self._seq}
            self._seq += 1
            if self._fh is not None:
                line = json.dumps(rec, sort_keys=True) + "\n"
                self._maybe_rotate(len(line))
                self._fh.write(line)
                self._bytes += len(line)
        return rec

    @contextlib.contextmanager
    def span(self, event: str, **attrs):
        """Wall-clock span: writes ONE line at exit with start ``ts`` and
        measured ``dur_s`` (start-stamped so the merged timeline orders the
        span where it began)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.event(event, _ts=t0,
                       dur_s=round(time.time() - t0, 6), **attrs)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_journal(path: str) -> list[dict]:
    """Parse one journal file; corrupt/truncated lines (a process died
    mid-write on a non-line boundary) are skipped, never fatal."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "ts" in rec and "event" in rec:
                    out.append(rec)
    except OSError:
        pass
    return out


def merge_journals(directory: str) -> list[dict]:
    """All ``events-*.jsonl`` files in ``directory`` merged into one list
    ordered by (ts, source, seq). Rotated segments (``events-x.rNNNN.jsonl``)
    match the same glob and carry the same source + monotonic seq, so they
    interleave back into order with no special casing."""
    records: list[dict] = []
    for path in sorted(glob.glob(os.path.join(directory, "events-*.jsonl"))):
        records.extend(read_journal(path))
    records.sort(key=lambda r: (r["ts"], str(r.get("source", "")),
                                r.get("seq", 0)))
    return records


def write_pod_timeline(directory: str) -> str:
    """Merge every per-process journal in ``directory`` into
    ``pod_timeline.jsonl`` (overwritten whole each call — the merge is
    idempotent, and a partial previous merge must not prefix the new one).
    Returns the timeline path."""
    path = os.path.join(directory, TIMELINE_FILENAME)
    records = merge_journals(directory)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return path
