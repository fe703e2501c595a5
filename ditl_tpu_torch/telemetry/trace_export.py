"""Journal -> Chrome-trace/Perfetto JSON export.

Renders the merged pod timeline plus request spans into the Chrome trace
event format (the JSON Perfetto and ``chrome://tracing`` both open): one
track (``pid``) per journal source — gateway, each replica server, each
elastic worker — with request spans as complete ``"X"`` events nested per
trace lane, and every non-span journal event (engine ticks, chaos
injections, lifecycle events) as an instant ``"i"`` mark on the process
track. This is the artifact the chunked-prefill refactor gets judged
against: "where did THIS request's 900 ms go" becomes a timeline you open,
not a histogram you squint at.

Mapping:

- ``pid``: 1-based index per journal ``source`` (with ``process_name``
  metadata records naming the track after the source); the kernel pid the
  record carries is preserved in ``args.os_pid``.
- ``tid``: spans of one trace share a lane within their source so parents
  visually contain children; untraced instants ride lane 0.
- ``ts``/``dur``: microseconds (Chrome trace unit) from the journal's
  wall-clock seconds.

CLI (stdlib-only, jax-free like everything under telemetry/):

    python -m ditl_tpu_torch.telemetry.trace_export --dir DIR [--trace ID] \
        [--out trace.json] [--list]
"""

from __future__ import annotations

import json
from typing import Iterable

from ditl_tpu_torch.telemetry.journal import merge_journals, read_journal
from ditl_tpu_torch.telemetry.tracing import RESERVED_KEYS

__all__ = [
    "load_trace_records",
    "spans_for_trace",
    "trace_ids",
    "to_chrome_trace",
    "write_chrome_trace",
]


def load_trace_records(directory: str) -> list[dict]:
    """Every journal record in ``directory`` merged into (ts, source, seq)
    order — spans, instants, and ordinary lifecycle events alike."""
    return merge_journals(directory)


def trace_ids(records: Iterable[dict]) -> dict[str, int]:
    """trace_id -> span count, insertion-ordered by first appearance."""
    out: dict[str, int] = {}
    for rec in records:
        if rec.get("event") == "trace.span" and rec.get("trace"):
            out[rec["trace"]] = out.get(rec["trace"], 0) + 1
    return out


def spans_for_trace(records: Iterable[dict], trace_id: str) -> list[dict]:
    """The span records of ONE trace, ordered by (ts, seq) — the merged
    cross-process story of a single request."""
    spans = [
        r for r in records
        if r.get("event") == "trace.span" and r.get("trace") == trace_id
    ]
    spans.sort(key=lambda r: (r["ts"], r.get("seq", 0)))
    return spans


def _args(rec: dict) -> dict:
    """Everything the span layer doesn't own, plus the trace identity —
    Perfetto shows these in the selection panel."""
    out = {k: v for k, v in rec.items() if k not in RESERVED_KEYS}
    for k in ("trace", "span", "parent"):
        if rec.get(k):
            out[k] = rec[k]
    if "pid" in rec:
        out["os_pid"] = rec["pid"]
    return out


def to_chrome_trace(records: Iterable[dict],
                    trace_id: str | None = None) -> dict:
    """Convert journal records to a Chrome trace object. ``trace_id``
    filters spans/instants to one trace while KEEPING untraced process
    events (ticks, lifecycle) — the backdrop a single request's timeline
    is read against."""
    events: list[dict] = []
    pids: dict[str, int] = {}
    lanes: dict[tuple[str, str], int] = {}
    lanes_per_source: dict[str, int] = {}

    def pid_for(source: str) -> int:
        if source not in pids:
            pids[source] = len(pids) + 1
            events.append({
                "name": "process_name", "ph": "M", "ts": 0,
                "pid": pids[source], "tid": 0,
                "args": {"name": source},
            })
        return pids[source]

    def lane_for(source: str, trace: str) -> int:
        key = (source, trace)
        if key not in lanes:
            lanes_per_source[source] = lanes_per_source.get(source, 0) + 1
            lanes[key] = lanes_per_source[source]
        return lanes[key]

    for rec in records:
        event = rec.get("event", "")
        source = str(rec.get("source", "unknown"))
        rec_trace = rec.get("trace", "")
        if trace_id is not None and rec_trace and rec_trace != trace_id:
            continue
        ts_us = float(rec["ts"]) * 1e6
        if event == "trace.span":
            if trace_id is not None and not rec_trace:
                continue
            events.append({
                "name": str(rec.get("name", "span")),
                "cat": "span",
                "ph": "X",
                "ts": ts_us,
                "dur": max(0.0, float(rec.get("dur_s", 0.0))) * 1e6,
                "pid": pid_for(source),
                "tid": lane_for(source, rec_trace or "untraced"),
                "args": _args(rec),
            })
        else:
            name = str(rec.get("name", event) or event)
            tid = (lane_for(source, rec_trace) if rec_trace else 0)
            events.append({
                "name": name,
                "cat": "instant" if event == "trace.instant" else "journal",
                "ph": "i",
                "s": "t" if rec_trace else "p",
                "ts": ts_us,
                "pid": pid_for(source),
                "tid": tid,
                "args": _args(rec),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(directory: str, out_path: str,
                       trace_id: str | None = None) -> str:
    trace = to_chrome_trace(load_trace_records(directory), trace_id)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return out_path


def main(argv: list[str] | None = None) -> int:
    import argparse
    import os

    parser = argparse.ArgumentParser(
        prog="ditl_tpu_torch.telemetry.trace_export",
        description="Render per-process JSONL journals into Chrome-trace/"
                    "Perfetto JSON (open at ui.perfetto.dev)",
    )
    parser.add_argument("--dir", default="",
                        help="journal directory (events-*.jsonl files)")
    parser.add_argument("--out", default="",
                        help="output path (default: <dir>/trace.json)")
    parser.add_argument("--trace", default="",
                        help="filter spans to one trace_id (untraced "
                        "process events are kept as backdrop)")
    parser.add_argument("--journal", default="",
                        help="convert ONE journal/timeline file instead of "
                        "merging --dir (e.g. pod_timeline.jsonl)")
    parser.add_argument("--list", action="store_true",
                        help="list trace ids (span counts) and exit")
    args = parser.parse_args(argv)

    if not args.dir and not args.journal:
        parser.error("one of --dir or --journal is required")
    records = (read_journal(args.journal) if args.journal
               else load_trace_records(args.dir))
    if args.list:
        ids = trace_ids(records)
        if not ids:
            print("no traces found")
        for tid, count in ids.items():
            print(f"{tid}  {count} span(s)")
        return 0
    out = args.out or os.path.join(
        args.dir or os.path.dirname(args.journal), "trace.json")
    trace = to_chrome_trace(records, args.trace or None)
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace['traceEvents'])} event(s) to {out} "
          f"(open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
