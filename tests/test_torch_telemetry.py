"""The port's copies of the JAX package's jax-free telemetry modules and its
``telemetry`` config section.

Each copy keeps its reference's lines one for one: a line may differ only
where the reference names its package (``ditl_tpu.`` becomes
``ditl_tpu_torch.``) or, in prose, where the reference's line (or the one
before it) carries a work-item tag, which the copy drops. The copies then
behave as their references: the span layer, the journal, the flight rings,
the SLO monitor and the serving bundle's exposition are driven side by side
here. ``TelemetryConfig`` matches the reference field for field, and
``telemetry.*`` overrides coerce as the JAX ``parse_overrides`` does; the
incident plane's directory raises until it is ported.
"""

import dataclasses
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from ditl_tpu import config as jconfig  # noqa: E402
from ditl_tpu.telemetry import flight as jflight  # noqa: E402
from ditl_tpu.telemetry import journal as jjournal  # noqa: E402
from ditl_tpu.telemetry import serving as jserving  # noqa: E402
from ditl_tpu.telemetry import slo as jslo  # noqa: E402
from ditl_tpu.telemetry import trace_export as jexport  # noqa: E402
from ditl_tpu.telemetry import tracing as jtracing  # noqa: E402
from ditl_tpu_torch import config as tconfig  # noqa: E402
from ditl_tpu_torch import telemetry as T  # noqa: E402
from ditl_tpu_torch.telemetry import flight as tflight  # noqa: E402
from ditl_tpu_torch.telemetry import journal as tjournal  # noqa: E402
from ditl_tpu_torch.telemetry import serving as tserving  # noqa: E402
from ditl_tpu_torch.telemetry import slo as tslo  # noqa: E402
from ditl_tpu_torch.telemetry import trace_export as texport  # noqa: E402
from ditl_tpu_torch.telemetry import tracing as ttracing  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["annotations.py", "telemetry/journal.py", "telemetry/tracing.py",
          "telemetry/flight.py", "telemetry/serving.py", "telemetry/slo.py",
          "telemetry/trace_export.py"]
TAG = re.compile(r"[I]SSUE|\bPR \d")  # the reference's work-item tags


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_the_reference_line_for_line(rel):
    theirs = (ROOT / "ditl_tpu" / rel).read_text().splitlines()
    ours = (ROOT / "ditl_tpu_torch" / rel).read_text().splitlines()
    assert len(ours) == len(theirs)
    for i, (ref, line) in enumerate(zip(theirs, ours)):
        if line in (ref, ref.replace("ditl_tpu.", "ditl_tpu_torch.")):
            continue
        assert any(TAG.search(x) for x in theirs[max(0, i - 1): i + 1]), (i + 1, ref, line)
        assert not TAG.search(line), (i + 1, line)
    # the copies import the port, never the reference
    assert not re.search(r"from ditl_tpu\.|import ditl_tpu\b", "\n".join(ours))


def test_package_exports_the_references_names_of_the_copied_modules():
    import importlib

    from ditl_tpu import telemetry as J

    copied = ("flight", "journal", "registry", "serving", "slo", "tracing")
    home = {}
    for mod in copied:
        ref = importlib.import_module(f"ditl_tpu.telemetry.{mod}")
        home.update({n: mod for n in J.__all__ if getattr(J, n) is getattr(ref, n, None)})
    assert set(T.__all__) == set(home)
    for name, mod in home.items():
        port = importlib.import_module(f"ditl_tpu_torch.telemetry.{mod}")
        assert getattr(T, name) is getattr(port, name), name


def test_tracing_and_journal_behave_as_the_reference(tmp_path):
    for mod in (jtracing, ttracing):
        ctx = mod.parse_traceparent("00-" + "a" * 32 + "-" + "b" * 16 + "-01")
        assert (ctx.trace_id, ctx.span_id) == ("a" * 32, "b" * 16)
        assert mod.parse_traceparent("garbage") is None
        assert mod.resolve_request_id("ok id!") == "okid"
        assert mod.resolve_request_id(None).startswith("req-")
    records = []
    for mod, jmod, tag in ((ttracing, tjournal, "port"), (jtracing, jjournal, "jax")):
        path = str(tmp_path / f"events-{tag}.jsonl")
        tracer = mod.Tracer(jmod.EventJournal(path, source=tag))
        root = tracer.start_span("server.request", request_id="r1", route="chat")
        child = tracer.start_span("engine.request", parent=root, req=0)
        tracer.instant("engine.tick", tick=1)
        child.end(tokens=3)
        root.end()
        tracer.journal.close()
        records.append([{k: v for k, v in r.items()
                         if k not in ("ts", "pid", "source", "trace", "span", "parent",
                                      "dur_s")}
                        for r in jmod.read_journal(path)])
    assert records[0] == records[1]
    assert not mod.NULL_TRACER.armed and not ttracing.NULL_TRACER.armed


def test_chrome_trace_export_of_a_port_journal(tmp_path):
    tracer = ttracing.Tracer(tjournal.EventJournal(str(tmp_path / "events-a.jsonl"),
                                                   source="a"))
    root = tracer.start_span("engine.request", req=0)
    tracer.start_span("engine.decode", parent=root, req=0, tokens=4).end()
    root.end()
    tracer.journal.close()
    ours = texport.to_chrome_trace(texport.load_trace_records(str(tmp_path)))
    theirs = jexport.to_chrome_trace(jexport.load_trace_records(str(tmp_path)))
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    assert {e["name"] for e in ours["traceEvents"] if e.get("ph") == "X"} == {
        "engine.request", "engine.decode"}


def test_flight_rings_and_slo_monitor_behave_as_the_reference():
    rings = [mod.FlightRecorder(3) for mod in (tflight, jflight)]
    for rec in rings:
        for i in range(5):
            rec.ring(tflight.TICK_RING).record(_ts=float(i), tick=i)
    assert rings[0].dump_all() == rings[1].dump_all()
    assert [r["tick"] for r in rings[0].ring(tflight.TICK_RING).dump()] == [2, 3, 4]
    reports = []
    for serving, slo in ((tserving, tslo), (jserving, jslo)):
        m = serving.ServingMetrics()
        for v in (0.1, 0.2, 3.0):
            m.ttft.observe(v)
            m.requests.inc()
            m.completed.inc()
        m.decode_token.observe(0.01, n=5)
        mon = slo.serving_slo(m, ttft_s=0.5)
        mon.report(now=100.0)
        reports.append(mon.report(now=200.0))
    assert reports[0] == reports[1]
    assert set(reports[0]["objectives"]) == {"ttft", "tpot", "availability"}


def test_serving_bundle_renders_the_reference_families():
    bodies = []
    for serving in (tserving, jserving):
        m = serving.ServingMetrics()
        m.ttft.observe(0.3)
        m.queue_full.inc()
        m.note_prefix_cache(16, 4)
        # HELP texts may differ where the reference's carries a tag
        bodies.append([x for x in m.render().splitlines() if not x.startswith("# HELP")])
    assert bodies[0] == bodies[1]
    samples = [(1000.0, 0.0), (1001.0, 10.0)]
    for backlog in (0, 5, 1000):
        assert (tserving.backlog_retry_after(samples, backlog, now=1001.5)
                == jserving.backlog_retry_after(samples, backlog, now=1001.5))


def _fields(cls) -> dict:
    return {f.name: (f.default, str(f.type)) for f in dataclasses.fields(cls)}


def test_telemetry_config_matches_the_reference_field_for_field():
    assert list(_fields(tconfig.TelemetryConfig).items()) == list(
        _fields(jconfig.TelemetryConfig).items())
    ours, ref = tconfig.TelemetryConfig(), jconfig.TelemetryConfig()
    for helper in ("journal_max_bytes", "slo_windows", "serving_slo_kwargs",
                   "gateway_slo_kwargs", "incident_kwargs", "watchdog_kwargs",
                   "serving_detector_kwargs", "training_detector_kwargs"):
        assert getattr(ours, helper)() == getattr(ref, helper)(), helper


@pytest.mark.parametrize("items", [
    ["telemetry.slo_ttft_s=0.5", "telemetry.journal_max_mb=64"],
    ["telemetry.flight_ring_size=8", "telemetry.slo_tpot_target=0.9",
     "telemetry.anomaly_window=4", "telemetry.prof_hz=0"],
    ["telemetry.slo_fast_window_s=10", "telemetry.slo_slow_window_s=20",
     "telemetry.loop_stall_threshold_s=0.5"],
])
def test_telemetry_overrides_coerce_as_the_reference(items):
    ours = tconfig.parse_overrides(tconfig.Config(), items).telemetry
    ref = jconfig.parse_overrides(jconfig.Config(), items).telemetry
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("item,exc", [
    ("telemetry.slo_ttft_target=1.0", ValueError),
    ("telemetry.journal_max_mb=-1", ValueError),
    ("telemetry.slo_fast_window_s=4000", ValueError),
    ("telemetry.flight_ring_size=0", ValueError),
])
def test_telemetry_validation_matches_the_reference(item, exc):
    for mod in (tconfig, jconfig):
        with pytest.raises(exc):
            mod.parse_overrides(mod.Config(), [item])


def test_incident_dir_and_usage_section_still_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfig.parse_overrides(tconfig.Config(), ["telemetry.incident_dir=x"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfig.parse_overrides(tconfig.Config(), ["usage.max_tenant_families=4"])
    # the reference takes both
    jconfig.parse_overrides(jconfig.Config(), ["telemetry.incident_dir=x"])
