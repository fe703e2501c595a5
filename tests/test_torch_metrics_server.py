"""The port's serving telemetry over HTTP, against the JAX package's server:
``/metrics``, ``/slo``, ``/health``'s latency fields, ``X-Request-Id``,
``traceparent`` and the backlog-aware ``Retry-After``, on the lock-step and
the continuous engine, plus the CLI's ``--trace-dir`` and
``--telemetry-override``.

Both packages serve the same requests, one at a time (so each engine's ticks
are the same on both), over the same tiny f32 weights, each server with a
journal-backed tracer of its own. ``/metrics`` must declare the JAX
server's families with the same TYPE lines (the port's own ``/v1/stats``
gauges, ``PORT_STATS``, aside; the interference split by class depends on
arrival timing and is left out on both sides), keep the Prometheus text
contract, and count what the reference counts."""

import http.client
import json
import os
import threading

import jax
import pytest

torch = pytest.importorskip("torch")

from prom_helpers import exposition_index, sample_family  # noqa: E402

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import server as jserver  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.continuous import ThreadedEngine as JaxThreadedEngine  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.telemetry.journal import EventJournal as JaxJournal  # noqa: E402
from ditl_tpu.telemetry.journal import merge_journals  # noqa: E402
from ditl_tpu.telemetry.tracing import Tracer as JaxTracer  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine, ThreadedEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402
from ditl_tpu_torch.telemetry import EventJournal, Tracer  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")
PORT_STATS = {"ticks", "decode_ticks", "decode_steps", "decode_seconds", "prefills_cold",
              "prefills_prefix_hit"}
TRACE_ID, PARENT_ID = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
TRACEPARENT = f"00-{TRACE_ID}-{PARENT_ID}-01"
# (route, payload, headers): the traffic every server gets, in order
TRAFFIC = [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 6},
     {"traceparent": TRACEPARENT}),
    ("/v1/completions", {"prompt": "the quick brown fox", "max_tokens": 9},
     {"X-Request-Id": "client-id.7"}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "abc"}],
                              "max_tokens": 5}, {}),
    ("/v1/completions", {"prompt": "streamed", "max_tokens": 7, "stream": True},
     {"X-Request-Id": "stream-1"}),
]


def _request(addr: str, method: str, route: str, payload=None, headers=None):
    """(status, lower-cased headers, body): JSON parsed, SSE as its data
    lines, text as text."""
    conn = http.client.HTTPConnection(addr, timeout=120)
    try:
        conn.request(method, route, None if payload is None else json.dumps(payload),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read().decode()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    kind = hdrs.get("content-type", "")
    if kind == "text/event-stream":
        return resp.status, hdrs, [e[len("data: "):] for e in raw.split("\n\n") if e]
    if kind == "application/json":
        return resp.status, hdrs, json.loads(raw)
    return resp.status, hdrs, raw


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _build(models, pkg: str, engine: str, trace_dir: str, **kw):
    jcfg, params, cfg, tparams = models
    port = pkg == "port"
    path = os.path.join(trace_dir, "events-server.jsonl")
    tracer = (Tracer if port else JaxTracer)((EventJournal if port else JaxJournal)(
        path, source=f"{pkg}-{engine}"))
    ekw = dict(n_slots=2, decode_chunk=4, tracer=tracer)
    if port:
        gen = Generator(tparams, cfg, ByteTokenizer(), device="cpu")
        threaded = (ThreadedEngine(ContinuousEngine(tparams, cfg, ByteTokenizer(),
                                                    device="cpu", **ekw))
                    if engine == "continuous" else None)
        return tserver.make_server(gen, port=0, threaded_engine=threaded,
                                   tracer=None if threaded else tracer, **kw)
    gen = JaxGenerator(params, jcfg, JaxByteTokenizer())
    threaded = (JaxThreadedEngine(JaxEngine(params, jcfg, JaxByteTokenizer(), **ekw))
                if engine == "continuous" else None)
    return jserver.make_server(gen, port=0, threaded_engine=threaded,
                               tracer=None if threaded else tracer, **kw)


def _stop(srv, thread) -> None:
    """Stop the serve loop, then the continuous engine's driver thread: the
    port's close() stops it, the reference's leaves it running."""
    srv.close(drain=False)
    engine = srv.RequestHandlerClass.threaded_engine
    if engine is not None:
        engine.close()
    thread.join(timeout=30)


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):
    """Each (package, engine) server after the same traffic: its address,
    the traffic's responses, the journal directory, and two /metrics
    scrapes with a request between them."""
    out = {}
    for pkg in ("port", "jax"):
        for engine in ("lockstep", "continuous"):
            trace_dir = str(tmp_path_factory.mktemp(f"{pkg}-{engine}"))
            srv = _build(models, pkg, engine, trace_dir)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            addr = f"127.0.0.1:{srv.server_address[1]}"
            try:
                answers = [_request(addr, "POST", r, p, h) for r, p, h in TRAFFIC]
                first = _request(addr, "GET", "/metrics")
                _request(addr, "POST", "/v1/completions", {"prompt": "more", "max_tokens": 3})
                second = _request(addr, "GET", "/metrics")
                slo = _request(addr, "GET", "/slo")
                health = _request(addr, "GET", "/health")
            finally:
                _stop(srv, thread)
            out[pkg, engine] = dict(answers=answers, metrics=(first, second), slo=slo,
                                    health=health, trace_dir=trace_dir)
    return out


def _families(body: str) -> dict[str, str]:
    types, _ = exposition_index(body)
    return {f: k for f, k in types.items()
            if f not in {f"ditl_serving_{k}" for k in PORT_STATS}
            and not f.startswith("ditl_serving_interference_max_by_class_")}


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_metrics_families_and_types_equal_the_reference(served, engine):
    ours = served["port", engine]["metrics"][1][2]
    ref = served["jax", engine]["metrics"][1][2]
    assert _families(ours) == _families(ref)
    _, a = exposition_index(ours)
    _, b = exposition_index(ref)
    for name in ("ditl_serving_requests_total", "ditl_serving_requests_completed_total",
                 "ditl_serving_request_e2e_seconds_count"):
        assert a[name] == b[name] == 5, name
    assert a["ditl_serving_tokens_generated_total"] == b["ditl_serving_tokens_generated_total"]
    if engine == "continuous":
        for name in ("ditl_serving_request_ttft_seconds_count",
                     "ditl_serving_request_queue_wait_seconds_count",
                     "ditl_serving_decode_token_seconds_count",
                     "ditl_serving_prefix_cache_miss_tokens_total"):
            assert a[name] == b[name], name


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_metrics_keep_the_prometheus_text_contract(served, engine):
    (s1, h1, body1), (s2, _, body2) = served["port", engine]["metrics"]
    assert s1 == s2 == 200 and h1["content-type"].startswith("text/plain")
    assert h1["x-request-id"].startswith("req-")
    types1, samples1 = exposition_index(body1)
    types2, samples2 = exposition_index(body2)
    for name in samples1:
        assert sample_family(name) in types1, name
    hists = [f for f, k in types1.items() if k == "histogram"]
    assert "ditl_serving_request_e2e_seconds" in hists
    for fam in hists:
        buckets = [(n, v) for n, v in samples1.items() if n.startswith(f"{fam}_bucket")]
        counts = [v for _, v in buckets]
        assert counts == sorted(counts), fam
        assert buckets[-1] == (f'{fam}_bucket{{le="+Inf"}}', samples1[f"{fam}_count"])
    counters = [f for f, k in types1.items() if k == "counter"]
    assert "ditl_serving_requests_total" in counters
    for fam in counters:
        assert fam.endswith("_total") and samples2[fam] >= samples1[fam], fam
    assert samples2["ditl_serving_requests_total"] == samples1["ditl_serving_requests_total"] + 1
    assert samples1["ditl_serving_up"] == 1


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_request_ids_are_echoed_or_generated(served, engine):
    answers = served["port", engine]["answers"]
    ids = [h["x-request-id"] for _, h, _ in answers]
    assert [s for s, _, _ in answers] == [200] * 4
    assert ids[1] == "client-id.7" and ids[3] == "stream-1"
    assert ids[0].startswith("req-") and ids[2].startswith("req-") and ids[0] != ids[2]
    assert answers[3][1]["content-type"] == "text/event-stream"


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_traceparent_is_continued_into_the_journal(served, engine):
    records = [r for r in merge_journals(served["port", engine]["trace_dir"])
               if r.get("event") == "trace.span"]
    roots = [r for r in records if r["name"] == "server.request"]
    assert len(roots) == 5
    assert {r["route"] for r in roots} == {"completions", "chat"}
    traced = [r for r in roots if r["trace"] == TRACE_ID]
    assert len(traced) == 1 and traced[0]["parent"] == PARENT_ID
    assert traced[0]["request_id"].startswith("req-")
    under = [r for r in records if r["trace"] == TRACE_ID and r is not traced[0]]
    if engine == "lockstep":
        assert under == []
        return
    by_id = {r["span"]: r for r in records}
    assert {r["name"] for r in under} == {"engine.request", "engine.queue", "engine.prefill",
                                          "engine.decode"}
    for r in under:  # each chains up to the server's span
        p = r
        while p["name"] != "server.request":
            p = by_id[p["parent"]]
        assert p is traced[0]
    ref = [r for r in merge_journals(served["jax", engine]["trace_dir"])
           if r.get("event") == "trace.span" and r["trace"] == TRACE_ID]
    assert sorted(r["name"] for r in ref) == sorted(r["name"] for r in under + traced)


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_slo_grades_the_references_objectives(served, engine):
    (status, _, ours), (_, _, ref) = served["port", engine]["slo"], served["jax", engine]["slo"]
    assert status == 200

    def shape(obj):
        return {k: shape(v) for k, v in obj.items()} if isinstance(obj, dict) else None

    assert shape(ours) == shape(ref)
    assert set(ours["objectives"]) == {"ttft", "tpot", "availability"}
    for name in ("ttft", "tpot", "availability"):
        assert ours["objectives"][name]["total"] == ref["objectives"][name]["total"], name
    assert ours["objectives"]["availability"]["total"] == 5


def test_health_reports_latency_p95s_after_traffic(served, models, tmp_path):
    _, _, body = served["port", "continuous"]["health"]
    assert body["ttft_p95_s"] > 0 and body["tpot_p95_s"] > 0
    _, _, lock = served["port", "lockstep"]["health"]
    assert "ttft_p95_s" not in lock  # the lock-step path has no TTFT
    srv = _build(models, "port", "continuous", str(tmp_path))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        _, _, fresh = _request(f"127.0.0.1:{srv.server_address[1]}", "GET", "/health")
    finally:
        srv.close(drain=False)
        thread.join(timeout=30)
    assert "ttft_p95_s" not in fresh and "tpot_p95_s" not in fresh


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_429_carries_a_backlog_retry_after_and_counts(models, tmp_path, pkg):
    """``max_pending=0`` refuses every completion: a 429 with the request's
    id and a Retry-After in [1, 30], counted as queue_full on /metrics."""
    srv = _build(models, pkg, "lockstep", str(tmp_path), max_pending=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        status, hdrs, body = _request(addr, "POST", "/v1/completions", {"prompt": "x"},
                                      {"X-Request-Id": "busy-1"})
        _, _, metrics = _request(addr, "GET", "/metrics")
    finally:
        _stop(srv, thread)
    assert status == 429 and body["error"]["type"] == "rate_limit_error"
    assert hdrs["x-request-id"] == "busy-1" and 1 <= int(hdrs["retry-after"]) <= 30
    assert exposition_index(metrics)[1]["ditl_serving_queue_full_total"] == 1


def test_cli_trace_dir_and_telemetry_override(tmp_path):
    trace_dir = tmp_path / "traces"
    srv = tserver.create_server([
        "--device", "cpu", "--port", "0", "--host", "127.0.0.1", "--engine", "continuous",
        "--max-cache-len", "64", "--override", "num_layers=1", "--override", "vocab_size=300",
        "--trace-dir", str(trace_dir), "--telemetry-override", "slo_ttft_s=0.5",
        "--telemetry-override", "journal_max_mb=4"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        status, _, _ = _request(addr, "POST", "/v1/completions",
                                {"prompt": "hi", "max_tokens": 4}, {"traceparent": TRACEPARENT})
        _, _, slo = _request(addr, "GET", "/v1/slo")
    finally:
        srv.close(drain=False)
        thread.join(timeout=30)
    assert status == 200
    assert slo["objectives"]["ttft"]["threshold_s"] == 0.5
    files = os.listdir(trace_dir)
    assert files == [f"events-server-{os.getpid()}.jsonl"]
    names = {r.get("name") for r in merge_journals(str(trace_dir)) if r.get("trace") == TRACE_ID}
    assert {"server.request", "engine.request", "engine.decode"} <= names


@pytest.mark.parametrize("override", ["incident_dir=x", "nope=1"])
def test_cli_refuses_unported_and_unknown_telemetry_fields(override):
    exc = NotImplementedError if override.startswith("incident") else ValueError
    with pytest.raises(exc):
        tserver.create_server(["--device", "cpu", "--port", "0",
                               "--telemetry-override", override])
    # usage metering and incidents have no flags yet
    with pytest.raises(SystemExit):
        tserver.create_server(["--device", "cpu", "--port", "0", "--usage-dir", "x"])
