"""Streaming on the port: engine streams (``submit(stream=...)``,
``ThreadedEngine.stream_one``) and Server-Sent Events on both routes and
both engines, against the same requests without a stream and against the
JAX package's server, at tiny f32 weights converted from the JAX package's
(so greedy argmax cannot flip on rounding). Every server is in-process on
127.0.0.1."""

import functools
import http.client
import json
import queue
import socket
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import server as jserver  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.continuous import ThreadedEngine as JaxThreadedEngine  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine, ThreadedEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256, dtype="float32")
DRAFT = dict(vocab_size=512, hidden_size=32, intermediate_size=64, num_layers=1,
             num_heads=2, num_kv_heads=1, head_dim=16, max_seq_len=256, dtype="float32")
PAGED = dict(cache_mode="paged", page_size=16)
# (prompt, max_new_tokens, temperature, seed): greedy and pinned-seed
# sampled; the first is longer than two prefill chunks of 32.
REQUESTS = [("the quick brown fox jumps over the lazy dog " * 2, 18, 0.0, None),
            ("abc abc abc abc", 20, 0.0, None),
            ("hello world", 13, 0.9, 7),
            ("streaming " * 3, 16, 1.0, 11),
            ("x", 9, 0.0, None)]
MODES = {
    "plain": {},
    "lookup": dict(speculative=True, spec_threshold=0.0, spec_k=4, spec_rounds=2),
    "draft": dict(speculative=True, spec_k=4, spec_rounds=2),
    "chunked": dict(prefill_chunk=32, token_budget=16),
}


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX cfg, JAX params, port cfg, port params) of the target and of a
    small, differently seeded drafter."""
    out = []
    for fields, seed in ((TINY, 0), (DRAFT, 99)):
        jcfg, cfg = JaxModelConfig(**fields, param_dtype="float32"), ModelConfig(**fields)
        params = jllama.init_params(jax.random.key(seed), jcfg)
        out.append((jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")))
    return tuple(out)


def _engine(mode: str = "plain", **kw):
    (_, _, cfg, tparams), (_, _, dcfg, dparams) = _models()
    kw = {"n_slots": 2, "decode_chunk": 4, **MODES[mode], **kw}
    if mode == "draft":
        kw.update(draft_params=dparams, draft_cfg=dcfg)
    return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **PAGED, **kw)


def _drain(q: queue.Queue) -> list:
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


def _submit_all(eng, streams: bool):
    tok = eng.tokenizer
    rids, qs = [], []
    for prompt, n, temp, seed in REQUESTS:
        q = queue.Queue() if streams else None
        rids.append(eng.submit([tok.bos_id] + tok.encode(prompt), max_new_tokens=n,
                               temperature=temp, seed=seed, stream=q))
        qs.append(q)
    return rids, qs


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_concatenate_to_the_unstreamed_tokens(mode):
    """Plain ticks, prompt-lookup and drafted speculative ticks, and chunked
    prefill under a token budget: each stream is non-empty token lists, one
    per harvest, then one None; concatenated they are the tokens the same
    request returns without a stream (greedy and pinned-seed sampled)."""
    eng = _engine(mode)
    rids, qs = _submit_all(eng, streams=True)
    out = eng.run()
    ref = _engine(mode)
    ref_rids, _ = _submit_all(ref, streams=False)
    want = ref.run()
    n_chunks = []
    for rid, ref_rid, q in zip(rids, ref_rids, qs):
        items = _drain(q)
        assert items[-1] is None and None not in items[:-1]
        chunks = items[:-1]
        assert all(isinstance(c, list) and c for c in chunks)
        assert sum(chunks, []) == out[rid] == want[ref_rid]
        n_chunks.append(len(chunks))
    assert max(n_chunks) >= 3, n_chunks  # incremental, not one list at the end
    if mode != "plain" and mode != "chunked":
        assert eng.spec_ticks > 0
    if mode == "chunked":
        assert eng.max_tick_prefill_tokens <= 32 + 16


def test_terminal_none_on_cancel_of_queued_and_in_flight_requests():
    eng = _engine(n_slots=1)
    tok = eng.tokenizer
    q1, q2 = queue.Queue(), queue.Queue()
    r1 = eng.submit([tok.bos_id] + tok.encode("first"), max_new_tokens=30, stream=q1)
    r2 = eng.submit([tok.bos_id] + tok.encode("second"), max_new_tokens=30, stream=q2)
    eng.step()
    assert eng.stats()["slots_busy"] == 1 and eng.stats()["queue_depth"] == 1
    assert eng.cancel(r2)  # queued
    assert _drain(q2) == [None]
    assert eng.cancel(r1)  # in flight
    items = _drain(q1)
    assert items[-1] is None and len(items) >= 2 and None not in items[:-1]
    st = eng.stats()
    assert st["slots_busy"] == st["queue_depth"] == 0
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
    assert not eng.pending


def _wait(pred, timeout=60.0):
    t = time.monotonic()
    while time.monotonic() - t < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_stream_one_yields_chunks_and_closing_frees_the_slot():
    te = ThreadedEngine(_engine(n_slots=1))
    eng = te._engine
    tok = te.tokenizer
    try:
        it = te.stream_one([tok.bos_id] + tok.encode("long one"), max_new_tokens=200)
        first, second = next(it), next(it)
        assert first and second
        it.close()
        assert _wait(lambda: eng.stats()["slots_busy"] == 0 and not eng.pending)
        steps = eng.decode_steps
        assert steps < 200
        # closed before its first chunk: cancelled all the same
        it2 = te.stream_one([tok.bos_id] + tok.encode("never read"), max_new_tokens=200)
        it2.close()
        assert _wait(lambda: eng.stats()["slots_busy"] == 0 and not eng.pending)
        assert eng.decode_steps - steps < 200
        # a stream read to its end, then a plain request: nothing parks in
        # _results for the streamed ones
        runs = [sum(te.stream_one([tok.bos_id] + tok.encode("abc"), max_new_tokens=9), [])
                for _ in range(3)]
        assert runs[0] == runs[1] == runs[2] and len(runs[0]) == 9
        assert te.generate_one([tok.bos_id] + tok.encode("abc"), max_new_tokens=9) == runs[0]
        assert te._results == {}
    finally:
        te.close()


def test_stream_one_raises_when_the_driver_dies():
    te = ThreadedEngine(_engine(n_slots=1))
    eng = te._engine
    tok = te.tokenizer
    step = eng.step
    calls = []

    def failing_step():
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("device lost")
        step()

    eng.step = failing_step
    try:
        running = te.stream_one([tok.bos_id] + tok.encode("a"), max_new_tokens=100)
        queued = te.stream_one([tok.bos_id] + tok.encode("b"), max_new_tokens=100)
        with pytest.raises(RuntimeError, match="died mid-stream"):
            list(running)
        with pytest.raises(RuntimeError, match="died mid-stream"):
            list(queued)
        with pytest.raises(RuntimeError, match="stopped"):
            te.stream_one([tok.bos_id], max_new_tokens=2)
    finally:
        te.close()


# -- the stop tracker and the detokenizer ----------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_stop_tracker_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    stops = ["".join(rng.choice(list("abc"), int(rng.integers(1, 4))))
             for _ in range(int(rng.integers(0, 4)))]
    ours, ref = tserver._StopTracker(stops), jserver._StopTracker(stops)
    for _ in range(int(rng.integers(1, 12))):
        piece = "".join(rng.choice(list("abcd"), int(rng.integers(0, 5))))
        assert ours.push(piece) == ref.push(piece)
        assert (ours.hit, ours.sent) == (ref.hit, ref.sent)
    assert ours.flush() == ref.flush()


@pytest.mark.parametrize("seed", range(4))
def test_detokenizer_concatenates_to_the_whole_decode(seed):
    """Random byte tokens (multi-byte characters and invalid bytes split at
    chunk edges): the increments concatenate to the decode of all tokens,
    where decoding each chunk alone (the reference's streaming) need not."""
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    text = "".join(rng.choice(list("aé€😀\n z"), 40))
    ids = tok.encode(text) + [int(x) for x in rng.integers(0, 260, 12)]
    cuts = sorted(set(rng.integers(1, len(ids), 9).tolist()))
    chunks = [ids[a:b] for a, b in zip([0] + cuts, cuts + [len(ids)])]
    det = tserver._Detokenizer(tok)
    out = "".join(det.push(c) for c in chunks) + det.flush()
    assert out == tok.decode(ids)
    split = tok.encode("é")
    assert tok.decode(split[:1]) + tok.decode(split[1:]) != "é"


# -- SSE on both engines ----------------------------------------------------------


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"127.0.0.1:{srv.server_address[1]}", thread


@pytest.fixture(scope="module")
def servers():
    """The port's and the JAX package's servers, lock-step and continuous
    (2 slots, page 16, decode_chunk 4, at most 2 queued), over the same
    weights."""
    (jcfg, params, cfg, tparams), _ = _models()
    jtok, ttok = JaxByteTokenizer(), ByteTokenizer()
    built = {
        ("port", "lockstep"): tserver.make_server(
            Generator(tparams, cfg, ttok, device="cpu"), port=0, default_max_tokens=8),
        ("port", "continuous"): tserver.make_server(
            Generator(tparams, cfg, ttok, device="cpu"), port=0, default_max_tokens=8,
            threaded_engine=ThreadedEngine(ContinuousEngine(
                tparams, cfg, ttok, device="cpu", n_slots=2, decode_chunk=4, max_queue=2,
                **PAGED))),
        ("jax", "lockstep"): jserver.make_server(JaxGenerator(params, jcfg, jtok), port=0),
        ("jax", "continuous"): jserver.make_server(
            JaxGenerator(params, jcfg, jtok), port=0,
            threaded_engine=JaxThreadedEngine(JaxEngine(
                params, jcfg, jtok, n_slots=2, decode_chunk=4, **PAGED))),
    }
    running = {key: (_serve(srv), srv) for key, srv in built.items()}
    try:
        yield {key: (addr, srv) for key, ((addr, _), srv) in running.items()}
    finally:
        for (_, thread), srv in running.values():
            srv.close(drain=False)
            # the reference's close() leaves its engine's driver thread running
            engine = srv.RequestHandlerClass.threaded_engine
            if engine is not None:
                engine.close()
            thread.join(timeout=30)


def _post(addr: str, route: str, payload: dict):
    """(status, headers, parsed body): SSE bodies as the list of ``data:``
    payloads, JSON-decoded except the final ``[DONE]``."""
    conn = http.client.HTTPConnection(addr, timeout=120)
    try:
        conn.request("POST", route, json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
        headers = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    if headers.get("content-type") == "text/event-stream":
        events = [e[len("data: "):] for e in raw.split("\n\n") if e]
        return resp.status, headers, [e if e == "[DONE]" else json.loads(e)
                                      for e in events]
    return resp.status, headers, json.loads(raw)


def _payload(chat: bool, prompt: str, **kw) -> dict:
    body = ({"messages": [{"role": "user", "content": prompt}]} if chat
            else {"prompt": prompt})
    return {**body, **kw}


def _streamed(events, chat: bool):
    """(content chunks, concatenated text, finish reason) of an SSE body."""
    assert events[-1] == "[DONE]"
    body = events[:-1]
    if chat:
        assert body[0]["choices"][0]["delta"] == {"role": "assistant", "content": ""}
        body = body[1:]
        texts = [e["choices"][0]["delta"].get("content", "") for e in body]
    else:
        texts = [e["choices"][0]["text"] for e in body]
    assert all(e["object"] == ("chat.completion.chunk" if chat else "text_completion")
               for e in events[:-1])
    assert all(e["choices"][0]["finish_reason"] is None for e in body[:-1])
    assert texts[-1] == ""
    return [t for t in texts[:-1] if t], "".join(texts), body[-1]["choices"][0]["finish_reason"]


def _unstreamed(addr, route, payload, chat):
    status, _, body = _post(addr, route, payload)
    assert status == 200, body
    choice = body["choices"][0]
    return (choice["message"]["content"] if chat else choice["text"]), choice["finish_reason"]


PROMPTS = ["The quick brown fox", "streams and chunks", "zz"]


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
@pytest.mark.parametrize("chat", [False, True], ids=["completions", "chat"])
def test_sse_matches_unstreamed_and_the_reference(servers, engine, chat):
    """Both routes on both engines: SSE framing, the role chunk, ``[DONE]``,
    ``Connection: close``; the concatenated deltas equal the non-streamed
    text and finish reason, and the greedy streamed text equals the JAX
    package's server's on the same weights. The continuous engine streams
    several chunks, the lock-step one a single chunk."""
    route = "/v1/chat/completions" if chat else "/v1/completions"
    addr, _ = servers[("port", engine)]
    jaddr, _ = servers[("jax", engine)]
    for prompt in PROMPTS:
        payload = _payload(chat, prompt, max_tokens=24, temperature=0)
        status, headers, events = _post(addr, route, {**payload, "stream": True})
        assert status == 200
        assert headers["content-type"] == "text/event-stream"
        assert headers["connection"] == "close"
        chunks, text, finish = _streamed(events, chat)
        assert (text, finish) == _unstreamed(addr, route, payload, chat)
        assert (text, finish) == _unstreamed(jaddr, route, payload, chat)
        _, _, jevents = _post(jaddr, route, {**payload, "stream": True})
        assert _streamed(jevents, chat)[1:] == (text, finish)
        if engine == "lockstep":
            assert len(chunks) <= 1
        elif prompt == PROMPTS[0]:
            assert len(chunks) >= 2, chunks


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_sse_stop_sequence_across_a_chunk_boundary(servers, engine):
    """A stop sequence made of the last character of one streamed chunk and
    the first of the next: the stream holds the first back, cuts there and
    finishes with "stop", as the non-streamed request does."""
    addr, _ = servers[("port", "continuous")]
    payload = _payload(False, PROMPTS[0], max_tokens=24, temperature=0)
    chunks, text, _ = _streamed(_post(addr, "/v1/completions",
                                      {**payload, "stream": True})[2], False)
    ends = np.cumsum([len(c) for c in chunks])[:-1]
    stop = next(text[e - 1:e + 1] for e in ends
                if "�" not in text[e - 1:e + 1] and text.find(text[e - 1:e + 1]) == e - 1)
    cut = text[:text.find(stop)]
    addr, _ = servers[("port", engine)]
    payload["stop"] = [stop]
    got_chunks, got, finish = _streamed(_post(addr, "/v1/completions",
                                              {**payload, "stream": True})[2], False)
    assert (got, finish) == (cut, "stop")
    assert _unstreamed(addr, "/v1/completions", payload, False) == (cut, "stop")
    assert "".join(got_chunks) == cut


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
def test_sse_refusals(servers, engine):
    """400 for streamed logprobs (both routes) and for a budget past the
    context, as JSON before any SSE header; 503 while draining; the stats
    count streamed requests."""
    addr, srv = servers[("port", engine)]
    status, headers, body = _post(addr, "/v1/completions",
                                  _payload(False, "x", stream=True, max_tokens=1000))
    assert status == 400 and headers["content-type"] == "application/json"
    assert "exceed" in body["error"]["message"]
    for chat, lp in ((False, {"logprobs": 1}), (True, {"logprobs": True})):
        route = "/v1/chat/completions" if chat else "/v1/completions"
        status, headers, body = _post(addr, route, _payload(chat, "x", stream=True, **lp))
        assert status == 400 and "logprobs" in body["error"]["message"]
    conn = http.client.HTTPConnection(addr, timeout=60)
    conn.request("GET", "/v1/stats")
    before = json.loads(conn.getresponse().read())["requests"]
    _post(addr, "/v1/completions", _payload(False, "count me", stream=True, max_tokens=3))
    conn.request("GET", "/v1/stats")
    assert json.loads(conn.getresponse().read())["requests"] == before + 1
    conn.close()
    srv.draining = True
    try:
        status, _, _ = _post(addr, "/v1/completions", _payload(False, "x", stream=True))
        assert status == 503
    finally:
        srv.draining = False


def test_sse_full_queue_answers_429_before_the_headers(servers):
    addr, srv = servers[("port", "continuous")]
    engine = srv.engine._engine
    gate = threading.Event()
    step = engine.step

    def gated_step():  # the driver waits here: submissions pile up
        gate.wait(timeout=60)
        step()

    engine.step = gated_step
    results = []
    threads = [threading.Thread(target=lambda: results.append(_post(
        addr, "/v1/completions", _payload(False, "queue", stream=True, max_tokens=2))[:2]))
        for _ in range(5)]
    try:
        for t in threads:
            t.start()
        assert _wait(lambda: any(s == 429 for s, _ in results), 30)
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=120)
        engine.step = step
    codes = sorted(s for s, _ in results)
    assert 429 in codes and 200 in codes and set(codes) <= {200, 429}
    for status, headers in results:
        want = "text/event-stream" if status == 200 else "application/json"
        assert headers["content-type"] == want
        assert status == 200 or 1 <= int(headers["retry-after"]) <= 30


def test_sse_disconnect_mid_stream_frees_the_slot(servers):
    addr, srv = servers[("port", "continuous")]
    engine = srv.engine._engine
    assert _wait(lambda: engine.stats()["slots_busy"] == 0 and not engine.pending)
    steps0 = engine.decode_steps
    body = json.dumps(_payload(False, "a long answer", stream=True, max_tokens=200))
    host, port = addr.split(":")
    sock = socket.create_connection((host, int(port)), timeout=60)
    sock.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: {addr}\r\n"
                  "Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    got = b""
    while got.count(b"data: ") < 2:
        got += sock.recv(4096)
    assert got.startswith(b"HTTP/1.0 200") or got.startswith(b"HTTP/1.1 200")
    sock.close()  # the client goes away after two chunks
    assert _wait(lambda: engine.stats()["slots_busy"] == 0 and not engine.pending)
    settled = engine.decode_steps
    time.sleep(0.3)
    assert engine.decode_steps == settled  # no more ticks for the dead stream
    assert settled - steps0 < 200
    st = engine.stats()
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
