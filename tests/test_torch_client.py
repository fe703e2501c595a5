"""The port's remote-LLM client (``ditl_tpu_torch/client/llm.py``) in the
cases of ``tests/test_client.py``, and against the JAX package's copy: the
same requests on the wire, the same ``APIConfig``, the same fault-plane rules
and retries, the same metrics text. Every server here is in-process on
127.0.0.1."""

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu import chaos as jchaos  # noqa: E402
from ditl_tpu import config as jconfig  # noqa: E402
from ditl_tpu.client import llm as jllm  # noqa: E402
from ditl_tpu.telemetry import registry as jregistry  # noqa: E402
from ditl_tpu_torch import chaos as tchaos  # noqa: E402
from ditl_tpu_torch import config as tconfig  # noqa: E402
from ditl_tpu_torch.client import llm as tllm  # noqa: E402
from ditl_tpu_torch.client.llm import ERROR_SENTINEL, LLMClient, client_metrics  # noqa: E402
from ditl_tpu_torch.config import APIConfig  # noqa: E402
from ditl_tpu_torch.telemetry import registry as tregistry  # noqa: E402

torch.set_num_threads(1)


def _ok_response(content="positive"):
    return {"choices": [{"message": {"role": "assistant", "content": content}}]}


def _fast_cfg(**kw):
    return APIConfig(backoff_base_s=0.001, backoff_max_s=0.002, max_retries=3, **kw)


def test_complete_success():
    calls = []

    def transport(url, headers, body, timeout):
        calls.append((url, json.loads(body)))
        return 200, {}, json.dumps(_ok_response("hello")).encode()

    client = LLMClient(_fast_cfg(), transport=transport)
    assert client.complete("hi") == "hello"
    url, payload = calls[0]
    assert url.endswith("/chat/completions")
    assert payload["messages"][-1] == {"role": "user", "content": "hi"}
    assert payload["model"] == APIConfig().model_name


def test_retry_on_429_then_success():
    attempts = []

    def transport(url, headers, body, timeout):
        attempts.append(1)
        if len(attempts) < 3:
            return 429, {"Retry-After": "0.001"}, b"rate limited"
        return 200, {}, json.dumps(_ok_response("ok")).encode()

    before = client_metrics.retries.value
    client = LLMClient(_fast_cfg(), transport=transport)
    assert client.complete("hi") == "ok"
    assert len(attempts) == 3
    assert client_metrics.retries.value == before + 2


@pytest.mark.parametrize("header,want", [("0.25", 0.25), ("7", 5.0), ("soon", None)])
def test_retry_after_sets_the_backoff(monkeypatch, header, want):
    """``Retry-After`` (either spelling of the key) is the delay, capped at
    ``backoff_max_s``; an unparsable value falls back to jittered
    exponential backoff."""
    sleeps = []
    monkeypatch.setattr(tllm.time, "sleep", sleeps.append)
    attempts = []

    def transport(url, headers, body, timeout):
        attempts.append(1)
        if len(attempts) == 1:
            return 503, {"retry-after": header}, b"busy"
        return 200, {}, json.dumps(_ok_response("ok")).encode()

    cfg = APIConfig(backoff_base_s=0.5, backoff_max_s=5.0, max_retries=2)
    assert LLMClient(cfg, transport=transport).complete("hi") == "ok"
    if want is None:
        assert len(sleeps) == 1 and 0.25 <= sleeps[0] <= 0.5
    else:
        assert sleeps == [want]


def test_total_function_on_persistent_failure():
    def transport(url, headers, body, timeout):
        raise OSError("connection refused")

    before = client_metrics.retry_exhausted.value
    client = LLMClient(_fast_cfg(), transport=transport)
    assert client.complete("hi") == ERROR_SENTINEL
    assert client_metrics.retry_exhausted.value == before + 1


def test_no_retry_on_4xx():
    attempts = []

    def transport(url, headers, body, timeout):
        attempts.append(1)
        return 400, {}, b"bad request"

    client = LLMClient(_fast_cfg(), transport=transport)
    assert client.complete("hi") == ERROR_SENTINEL
    assert len(attempts) == 1  # 400 is not retryable


def test_total_timeout_bounds_retry_wall_time():
    attempts = []

    def transport(url, headers, body, timeout):
        attempts.append(timeout)
        raise OSError("endpoint down")

    cfg = APIConfig(total_timeout_s=0.5, timeout_s=30.0, max_retries=1000,
                    backoff_base_s=0.02, backoff_max_s=0.05)
    before = client_metrics.deadline_exhausted.value
    t0 = time.monotonic()
    out = LLMClient(cfg, transport=transport).complete("hi")
    assert out == ERROR_SENTINEL  # still a total function
    assert time.monotonic() - t0 < 3.0  # not max_retries x (timeout + backoff)
    assert client_metrics.deadline_exhausted.value == before + 1
    # every attempt's timeout is clamped to what is left of the budget
    assert attempts and all(t <= 0.5 + 1e-6 for t in attempts)


def test_complete_many_order_and_concurrency():
    lock = threading.Lock()
    in_flight = [0]
    peak = [0]

    def transport(url, headers, body, timeout):
        with lock:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        prompt = json.loads(body)["messages"][-1]["content"]
        time.sleep(0.01)
        with lock:
            in_flight[0] -= 1
        return 200, {}, json.dumps(_ok_response(f"re:{prompt}")).encode()

    client = LLMClient(_fast_cfg(max_concurrency=4), transport=transport)
    prompts = [f"p{i}" for i in range(12)]
    assert client.complete_many(prompts) == [f"re:p{i}" for i in range(12)]
    assert 1 < peak[0] <= 4  # concurrent, and bounded
    assert client.complete_many([]) == []


def test_auth_header_from_env(monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "sk-secret")
    seen = {}

    def transport(url, headers, body, timeout):
        seen.update(headers)
        return 200, {}, json.dumps(_ok_response()).encode()

    LLMClient(_fast_cfg(), transport=transport).complete("hi")
    assert seen["Authorization"] == "Bearer sk-secret"
    # read at call time, from the configured variable
    monkeypatch.setenv("OTHER_KEY", "sk-other")
    LLMClient(_fast_cfg(api_key_env="OTHER_KEY"), transport=transport).complete("hi")
    assert seen["Authorization"] == "Bearer sk-other"


class _FakeOpenAIHandler(BaseHTTPRequestHandler):
    def do_POST(self):
        payload = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        if self.path.endswith("/embeddings"):
            texts = payload["input"] if isinstance(payload["input"], list) else [payload["input"]]
            out = {"object": "list", "data": [
                {"object": "embedding", "index": i, "embedding": [float(len(t)), 1.0]}
                for i, t in enumerate(texts)]}
        else:
            out = _ok_response(f"echo:{payload['messages'][-1]['content']}")
        body = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_against_real_local_http_server():
    server = HTTPServer(("127.0.0.1", 0), _FakeOpenAIHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        cfg = APIConfig(api_base=f"http://127.0.0.1:{server.server_address[1]}/v1",
                        timeout_s=5.0)
        client = LLMClient(cfg)
        assert client.complete("ping") == "echo:ping"
        assert client.complete_many(["a", "b"]) == ["echo:a", "echo:b"]
        assert client.embed(["ab", "c"]) == [[2.0, 1.0], [1.0, 1.0]]
        assert tllm.get_model_response("pong", cfg) == "echo:pong"
    finally:
        server.shutdown()
        server.server_close()


def test_embed_total_function():
    """client.embed: vectors sorted by index; None on failure."""

    def transport(url, headers, body, timeout):
        assert url.endswith("/embeddings")
        payload = json.loads(body)
        n = 1 if isinstance(payload["input"], str) else len(payload["input"])
        data = [{"object": "embedding", "index": i, "embedding": [float(i), 0.5]}
                for i in reversed(range(n))]  # out of order: the client sorts
        return 200, {}, json.dumps({"object": "list", "data": data}).encode()

    client = LLMClient(_fast_cfg(), transport=transport)
    assert client.embed(["a", "b", "c"]) == [[0.0, 0.5], [1.0, 0.5], [2.0, 0.5]]
    assert client.embed("solo") == [[0.0, 0.5]]

    def failing(url, headers, body, timeout):
        return 500, {}, b"boom"

    assert LLMClient(_fast_cfg(), transport=failing).embed("x") is None


def _recording_transport(log):
    """A seeded fake endpoint: answers from the request body alone, so both
    packages' clients get the same replies for the same requests."""
    lock = threading.Lock()

    def transport(url, headers, body, timeout):
        payload = json.loads(body)
        with lock:
            log.append((url, dict(headers), payload, timeout))
        seed = sum(body) % 2**31
        rng = np.random.default_rng(seed)
        if url.endswith("/embeddings"):
            n = 1 if isinstance(payload["input"], str) else len(payload["input"])
            out = {"data": [{"index": i, "embedding": rng.normal(size=3).tolist()}
                            for i in range(n)]}
        elif seed % 5 == 0:
            return 400, {}, b"refused"
        else:
            out = _ok_response(f"reply-{rng.integers(1000)}")
        return 200, {}, json.dumps(out).encode()

    return transport


def test_one_transport_through_both_clients(monkeypatch):
    """The same calls through the port's and the JAX package's clients send
    the same URLs, headers, bodies and timeouts, and return the same
    results (a refusal included)."""
    monkeypatch.setenv("OPENAI_API_KEY", "sk-both")
    rng = np.random.default_rng(0)
    prompts = [f"review {i}: " + " ".join(rng.choice(["good", "bad", "dull"], 6))
               for i in range(7)]
    kw = dict(api_base="http://127.0.0.1:9/v1", model_name="m", timeout_s=3.0,
              max_retries=0, max_concurrency=1)
    results, logs = [], []
    for mod, cfg in ((tllm, tconfig.APIConfig(**kw)), (jllm, jconfig.APIConfig(**kw))):
        log = []
        client = mod.LLMClient(cfg, transport=_recording_transport(log))
        results.append([client.complete(prompts[0]),
                        client.complete(prompts[1], system="be terse"),
                        client.complete_many(prompts[2:]),
                        client.embed("one"), client.embed(prompts[:3])])
        logs.append(log)
    assert results[0] == results[1]
    assert logs[0] == logs[1]
    assert ERROR_SENTINEL in results[0][2] or ERROR_SENTINEL in results[0][:2]


def test_api_config_matches_jax_field_for_field(monkeypatch):
    def fields(cls):
        return [(f.name, f.default, str(f.type)) for f in dataclasses.fields(cls)]

    assert fields(tconfig.APIConfig) == fields(jconfig.APIConfig)
    monkeypatch.setenv("OPENAI_API_KEY", "k1")
    assert tconfig.APIConfig().api_key() == jconfig.APIConfig().api_key() == "k1"


RULES = [
    "client.request:error",
    "client.request:error@max=2",
    "client.request:delay@p=0.5,delay=0.01;data.batch:corrupt@call=3",
    "ckpt.save:kill@step=4,max=1;engine.tick:hang@proc=1,hang=2.5",
    " server.request : delay @ p=0.25 ; ",
]


@pytest.mark.parametrize("spec", RULES)
def test_parse_rules_match_jax(spec):
    ours, ref = tchaos.parse_rules(spec), jchaos.parse_rules(spec)
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in ref]


@pytest.mark.parametrize("spec", ["nowhere:error", "client.request:explode",
                                  "client.request:corrupt", "client.request:error@step=2",
                                  "client.request:error@p=2", "client.request",
                                  "client.request:error@x=1"])
def test_bad_rules_raise_as_in_jax(spec):
    with pytest.raises(ValueError) as ref:
        jchaos.parse_rules(spec)
    with pytest.raises(ValueError) as ours:
        tchaos.parse_rules(spec)
    assert str(ours.value) == str(ref.value)


def test_armed_client_error_rule_retries_alike():
    """``client.request:error@max=2``: both clients ride their retry path
    twice, then succeed; the planes fire the same faults."""
    ok = json.dumps(_ok_response("recovered")).encode()

    def transport(url, headers, body, timeout):
        return 200, {}, ok

    retried = []
    for mod, chaos, cfg_mod in ((tllm, tchaos, tconfig), (jllm, jchaos, jconfig)):
        plane = chaos.arm(chaos.FaultPlane(seed=3, rules="client.request:error@max=2"))
        try:
            before = mod.client_metrics.retries.value
            cfg = cfg_mod.APIConfig(max_retries=5, backoff_base_s=0.001,
                                    backoff_max_s=0.002)
            assert mod.LLMClient(cfg, transport=transport).complete("hi") == "recovered"
            retried.append((mod.client_metrics.retries.value - before, plane.summary()))
        finally:
            chaos.disarm()
    assert retried[0] == retried[1] == (2, retried[0][1])
    assert retried[0][1]["injected"] == {"client.request:error": 2}


def test_arm_chaos_journal_dir_raises(tmp_path):
    cfg = type("Chaos", (), {"rules": "client.request:error", "seed": 0,
                             "journal_dir": str(tmp_path)})()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tchaos.arm_chaos(cfg)
    assert tchaos.get_plane() is None
    cfg.journal_dir = ""
    try:
        assert tchaos.arm_chaos(cfg) is tchaos.get_plane()
    finally:
        tchaos.disarm()


def test_metrics_registry_renders_like_jax():
    """Counters, gauges and histograms fed the same operations render the
    same exposition text and the same summary."""
    rng = np.random.default_rng(1)
    regs = [tregistry.MetricsRegistry(), jregistry.MetricsRegistry()]
    values = rng.exponential(0.05, size=200).tolist()
    for reg in regs:
        c = reg.counter("ditl_c", "a counter")
        g = reg.gauge("ditl_g")
        h = reg.histogram("ditl_h", "latency", buckets=jregistry.LATENCY_BUCKETS_S)
        t = reg.histogram("ditl_t", buckets=tregistry.TOKEN_LATENCY_BUCKETS_S)
        for i, v in enumerate(values):
            c.inc(v)
            g.set(v) if i % 3 else g.dec(v)
            h.observe(v)
            t.observe(v / 100, n=1 + i % 3)
        assert reg.counter("ditl_c") is c
        with pytest.raises(ValueError):
            reg.gauge("ditl_c")
        with pytest.raises(ValueError):
            c.inc(-1)
    assert regs[0].render() == regs[1].render()
    assert regs[0].summary() == regs[1].summary()
    h0, h1 = (r.histogram("ditl_h") for r in regs)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h0.quantile(q) == h1.quantile(q)
    assert h0.count_le(0.05) == h1.count_le(0.05)
