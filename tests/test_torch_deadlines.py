"""Port parity: request deadlines on the continuous engine and the server.

A request past its deadline is evicted at the next ``step()``, before
admission and dispatch, from the queue or its slot: its pages free, a
stream gets its terminal None, ``ThreadedEngine`` waiters raise
``DeadlineExceededError`` and the server answers 504, as the JAX engine and
server do on the same requests (tiny f32 config, page 16).
"""

import http.client
import json
import queue
import threading
import time

import jax
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import server as jserver  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.continuous import ThreadedEngine as JaxThreadedEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.continuous import (  # noqa: E402
    BadRequestError,
    ContinuousEngine,
    DeadlineExceededError,
    ThreadedEngine,
)
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256,
            dtype="float32")
PROMPT = [1] + list(range(5, 21))


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _make(pair, port: bool, **kw):
    jcfg, params, cfg, tparams = pair
    kw = dict(n_slots=1, decode_chunk=4, cache_mode="paged", page_size=16, **kw)
    if port:
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu",
                                gen=GenerateConfig(max_new_tokens=32), **kw)
    return JaxEngine(params, jcfg, JaxByteTokenizer(),
                     gen=JaxGenerateConfig(max_new_tokens=32), **kw)


def _expired_count(eng) -> int:
    counter = getattr(eng, "deadline_expired", None)
    return counter if isinstance(counter, int) else int(eng.metrics.deadline_expired.value)


@pytest.mark.parametrize("port", [False, True])
def test_queued_and_in_flight_expiry(pair, port):
    """One slot: b waits behind a with a short deadline and is evicted from
    the queue; then a, decoding, passes its deadline and is evicted from
    its slot with the tokens it has; its pages free and both streams end
    with one None. The same on the JAX engine."""
    eng = _make(pair, port)
    qa, qb = queue.Queue(), queue.Queue()
    ra = eng.submit(PROMPT, stream=qa, deadline_s=60.0)
    rb = eng.submit([1] + list(range(30, 46)), stream=qb, deadline_s=0.05)
    eng.step()  # a admitted, one tick decoded; b queued
    time.sleep(0.1)
    eng.step()  # b expires before admission; a decodes on
    b = next(r for r in eng.take_finished() if r.req_id == rb)
    assert b.expired and b.tokens == [] and b.finished
    a = next(r for r in eng._slots if r is not None)
    assert a.req_id == ra and len(a.tokens) == 8
    a.deadline = time.monotonic() - 1.0
    eng.step()
    a_done = next(r for r in eng.take_finished() if r.req_id == ra)
    assert a_done.expired and len(a_done.tokens) == 8
    assert not eng.pending and _expired_count(eng) == 2
    st = eng.stats()
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
    for q, want in ((qa, 8), (qb, 0)):
        items = [q.get_nowait() for _ in range(q.qsize())]
        assert items[-1] is None and items.count(None) == 1
        assert len(sum((x if isinstance(x, list) else [] for x in items[:-1]), [])) == want


@pytest.mark.parametrize("deadline_s", [float("nan"), "soon"])
def test_deadline_validation_matches_jax(pair, deadline_s):
    msgs = []
    for port in (False, True):
        with pytest.raises(ValueError) as e:
            _make(pair, port).submit(PROMPT, deadline_s=deadline_s)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and isinstance(e.value, BadRequestError)


def test_threaded_engine_raises_and_ends_streams(pair):
    """``generate_one(deadline_s=...)`` raises ``DeadlineExceededError`` when
    the request is evicted; a stream past its deadline ends (its terminal
    None), as does a logprob stream; a request within its deadline is
    served."""
    eng = _make(pair, True, logprobs_k=2)
    gate = threading.Event()
    step = eng.step

    def gated_step():  # the driver waits here: the deadlines pass
        gate.wait(timeout=60)
        step()

    eng.step = gated_step
    te = ThreadedEngine(eng)
    try:
        assert te.supports_deadlines and te.supports_slo_classes
        errors = []

        def waiter():
            try:
                te.generate_one(PROMPT, deadline_s=0.05)
            except DeadlineExceededError as e:
                errors.append(str(e))

        th = threading.Thread(target=waiter)
        th.start()
        plain = te.stream_one(PROMPT, deadline_s=0.05)
        with_lp = te.stream_one_with_logprobs(PROMPT, 2, deadline_s=0.05)
        _wait_for(lambda: eng._next_id == 3)  # all three submitted
        time.sleep(0.2)
        gate.set()
        th.join(timeout=60)
        assert errors and "deadline" in errors[0]
        assert list(plain) == [] and list(with_lp) == []
        assert te.generate_one(PROMPT, max_new_tokens=4, deadline_s=60.0)
        assert _expired_count(eng) == 3
    finally:
        gate.set()
        te.close()


def _wait_for(pred, timeout: float = 60.0) -> None:
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.01)


# -- the servers: a deadline that expires in the engine answers 504 ----------------


@pytest.fixture(scope="module")
def gated_servers(pair):
    """Continuous servers (one slot) of the port and the JAX package whose
    drivers wait at each tick until a test opens the gate."""
    jcfg, params, cfg, tparams = pair
    gate = threading.Event()
    gate.set()
    engines = {"port": _make(pair, True), "jax": _make(pair, False)}
    for eng in engines.values():
        step = eng.step

        def gated(step=step):
            gate.wait(timeout=60)
            step()

        eng.step = gated
    servers = {
        "port": tserver.make_server(Generator(tparams, cfg, ByteTokenizer(), device="cpu"),
                                    port=0, threaded_engine=ThreadedEngine(engines["port"])),
        "jax": jserver.make_server(JaxGenerator(params, jcfg, JaxByteTokenizer()), port=0,
                                   threaded_engine=JaxThreadedEngine(engines["jax"])),
    }
    threads = {}
    for key, srv in servers.items():
        threads[key] = threading.Thread(target=srv.serve_forever, daemon=True)
        threads[key].start()
    try:
        yield {k: f"127.0.0.1:{s.server_address[1]}" for k, s in servers.items()}, gate, engines
    finally:
        gate.set()
        for key, srv in servers.items():
            srv.close(drain=False)
            threads[key].join(timeout=30)
        servers["jax"].RequestHandlerClass.threaded_engine.close()


def _post(addr, route, payload, headers=None):
    conn = http.client.HTTPConnection(addr, timeout=120)
    try:
        conn.request("POST", route, json.dumps(payload),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read().decode()
        if resp.getheader("Content-Type") == "text/event-stream":
            return resp.status, [json.loads(e[6:]) for e in raw.split("\n\n")
                                 if e.startswith("data: {")]
        return resp.status, json.loads(raw)
    finally:
        conn.close()


@pytest.mark.parametrize("where", ["payload", "header"])
def test_engine_eviction_answers_504(gated_servers, where):
    """A request queued past its deadline: 504 ``timeout_error`` with the
    JAX server's message; a streamed one ends early with finish "stop"."""
    addrs, gate, engines = gated_servers
    payload = {"prompt": "deadline", "max_tokens": 8}
    headers = None
    if where == "payload":
        payload["deadline_s"] = 0.3
    else:
        headers = {"X-Request-Deadline-S": "0.3"}
    answers = {}
    ids = {k: eng._next_id for k, eng in engines.items()}
    gate.clear()
    try:
        threads = [threading.Thread(target=lambda k=k: answers.__setitem__(
            k, _post(addrs[k], "/v1/completions", payload, headers))) for k in addrs]
        for t in threads:
            t.start()
        # both submitted (then held at the gate), then past their deadline
        _wait_for(lambda: all(eng._next_id > ids[k] for k, eng in engines.items()))
        time.sleep(0.6)
    finally:
        gate.set()
    for t in threads:
        t.join(timeout=60)
    (ps, port), (js, ref) = answers["port"], answers["jax"]
    assert ps == js == 504
    assert port["error"] == ref["error"] and port["error"]["type"] == "timeout_error"
    port_id = engines["port"]._next_id
    gate.clear()
    try:
        th = threading.Thread(target=lambda: answers.__setitem__("sse", _post(
            addrs["port"], "/v1/completions", {**payload, "stream": True}, headers)))
        th.start()
        _wait_for(lambda: engines["port"]._next_id > port_id)
        time.sleep(0.6)
    finally:
        gate.set()
    th.join(timeout=60)
    status, events = answers["sse"]
    assert status == 200 and events[-1]["choices"][0]["finish_reason"] == "stop"
    assert "".join(e["choices"][0]["text"] for e in events) == ""
