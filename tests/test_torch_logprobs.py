"""Port parity: logprobs on the continuous engine and the server, in the
cases of ``tests/test_logprobs.py`` that touch them.

The JAX ``ContinuousEngine`` and the port's, armed with ``logprobs_k``,
serve the same greedy requests on the same weights (tiny f32 config, page
16) on plain ticks, chunked prefills, prompt-lookup speculative ticks and
drafted ones: identical tokens and top ids, chosen and top logprobs within
``LP_TOL`` (f32 log-softmax of logits that agree to f32 rounding). The
servers answer the same JSON and streamed events for the same request, and
the same refusals.
"""

import http.client
import json
import threading

import jax
import numpy as np
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
    ThreadedEngine,
)
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256,
            dtype="float32")
LP_TOL = 1e-5
K = 3
PROMPTS = [[1] + list(range(5, 21)), [1] + list(range(30, 46)), [1] + list(range(2, 60)),
           [1] + [7, 8, 9] * 10]
# tick kind -> engine settings (the drafter is the target itself)
MODES = {
    "plain": {},
    "chunked": {"prefill_chunk": 32},
    "lookup": {"speculative": True, "spec_k": 4, "spec_threshold": 0.0},
    "drafter": {"speculative": True, "spec_k": 4, "spec_threshold": 0.0, "draft": True},
}


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _make(pair, port: bool, mode: str, **kw):
    jcfg, params, cfg, tparams = pair
    kw = {**MODES[mode], **kw}
    if kw.pop("draft", False):
        kw.update(draft_params=tparams, draft_cfg=cfg) if port else kw.update(
            draft_params=params, draft_cfg=jcfg)
    kw.setdefault("logprobs_k", K)
    common = dict(n_slots=4, decode_chunk=4, cache_mode="paged", page_size=16, **kw)
    if port:
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu",
                                gen=GenerateConfig(max_new_tokens=40), **common)
    return JaxEngine(params, jcfg, JaxByteTokenizer(),
                     gen=JaxGenerateConfig(max_new_tokens=40), **common)


def _run(eng, **submit_kw):
    rids = [eng.submit(p, **submit_kw) for p in PROMPTS]
    done = {}
    while eng.pending:
        eng.step()
        done.update({r.req_id: r for r in eng.take_finished()})
    return [done[r] for r in rids]


@pytest.fixture(scope="module")
def jax_runs(pair):
    return {mode: _run(_make(pair, False, mode), logprobs=K) for mode in MODES}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_logprobs_match_jax(pair, jax_runs, mode):
    """Every path that emits a token scores it as the reference does: the
    prefill's first token (whole and chunked), plain decode steps, and the
    speculative rounds' accepted drafts and corrections (lookup and
    drafter)."""
    got = _run(_make(pair, True, mode), logprobs=K)
    for g, j in zip(got, jax_runs[mode]):
        assert g.tokens == j.tokens and len(g.lp_token) == len(g.tokens)
        assert g.lp_top_ids == j.lp_top_ids
        np.testing.assert_allclose(g.lp_token, j.lp_token, rtol=0, atol=LP_TOL)
        np.testing.assert_allclose(g.lp_top, j.lp_top, rtol=0, atol=LP_TOL)
        # greedy: the chosen token is the top-1 alternative, its logprob the
        # top logprob; every logprob <= 0, the top ones sorted
        assert [ids[0] for ids in g.lp_top_ids] == g.tokens
        np.testing.assert_allclose([t[0] for t in g.lp_top], g.lp_token, rtol=0, atol=LP_TOL)
        top = np.asarray(g.lp_top)
        assert (top <= 1e-6).all() and (np.diff(top, axis=1) <= 0).all()


@pytest.mark.parametrize("mode", ["plain", "lookup"])
def test_logprobs_never_change_tokens(pair, mode):
    """Arming and asking for logprobs leaves every token as it was, greedy
    and sampled; a request that asks nothing keeps no stats."""
    for kw in ({}, {"temperature": 0.9, "top_p": 0.9, "seed": 3}):
        off = _run(_make(pair, True, mode, logprobs_k=0), **kw)
        on = _run(_make(pair, True, mode), logprobs=2, **kw)
        silent = _run(_make(pair, True, mode), **kw)
        assert [r.tokens for r in on] == [r.tokens for r in off] == [r.tokens for r in silent]
        assert all(r.lp_token == [] for r in silent)
        assert all(len(r.lp_top_ids) == len(r.tokens) for r in on)


def test_validation_messages_match_jax(pair):
    """``test_continuous_engine_logprobs_validation``: the same messages."""
    for kw, n in (({"logprobs_k": 0}, 1), ({"logprobs_k": 2}, 3), ({"logprobs_k": 2}, -1)):
        msgs = []
        for port in (False, True):
            with pytest.raises(ValueError) as e:
                _make(pair, port, "plain", **kw).submit([1, 2, 3], logprobs=n)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert isinstance(e.value, BadRequestError)
    with pytest.raises(ValueError, match="logprobs_k"):
        _make(pair, True, "plain", logprobs_k=-1)


def test_threaded_engine_logprobs_match_the_lockstep_generator(pair):
    """``test_continuous_engine_logprobs_match_lockstep``: a request riding
    the decode ticks returns the lock-step Generator's tokens, chosen
    logprobs and top ids (the port's and the JAX package's)."""
    jcfg, params, cfg, tparams = pair
    prompt = [1] + ByteTokenizer().encode("hello world")
    ref, ref_lp = Generator(tparams, cfg, ByteTokenizer(), device="cpu") \
        .generate_tokens_with_logprobs([prompt], GenerateConfig(max_new_tokens=12, logprobs=3))
    jref, jref_lp = JaxGenerator(params, jcfg, JaxByteTokenizer()) \
        .generate_tokens_with_logprobs([prompt], JaxGenerateConfig(max_new_tokens=12, logprobs=3))
    te = ThreadedEngine(_make(pair, True, "plain"))
    try:
        toks, lp = te.generate_one_with_logprobs(prompt, 3, max_new_tokens=12,
                                                 temperature=0.0)
    finally:
        te.close()
    assert toks == ref[0] == jref[0]
    assert lp["top_ids"] == ref_lp[0]["top_ids"] == jref_lp[0]["top_ids"]
    np.testing.assert_allclose(lp["token_logprobs"], jref_lp[0]["token_logprobs"], atol=LP_TOL)


# -- the servers ------------------------------------------------------------------


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"127.0.0.1:{srv.server_address[1]}", thread


@pytest.fixture(scope="module")
def servers(pair):
    """The port's and the JAX package's continuous servers with
    ``--logprobs-k 3``; their lock-step Generators must never serve a
    logprob request of N <= 3."""
    jcfg, params, cfg, tparams = pair

    class NoLockstep(Generator):
        def generate_tokens_with_logprobs(self, *a, **k):
            raise AssertionError("logprobs took the lock-step fallback")

    built = {
        "port": tserver.make_server(
            NoLockstep(tparams, cfg, ByteTokenizer(), device="cpu"), port=0,
            default_max_tokens=10, threaded_engine=ThreadedEngine(_make(pair, True, "plain"))),
        "jax": jserver.make_server(
            JaxGenerator(params, jcfg, JaxByteTokenizer()), port=0, default_max_tokens=10,
            threaded_engine=JaxThreadedEngine(_make(pair, False, "plain"))),
    }
    running = {key: (_serve(srv), srv) for key, srv in built.items()}
    try:
        yield {key: addr for key, ((addr, _), _) in running.items()}
    finally:
        for (_, thread), srv in running.values():
            srv.close(drain=False) if hasattr(srv, "close") else srv.shutdown()
            thread.join(timeout=30)
        built["jax"].RequestHandlerClass.threaded_engine.close()


def _post(addr: str, route: str, payload: dict):
    conn = http.client.HTTPConnection(addr, timeout=120)
    try:
        conn.request("POST", route, json.dumps(payload), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
        sse = resp.getheader("Content-Type") == "text/event-stream"
    finally:
        conn.close()
    if sse:
        return resp.status, [json.loads(e[6:]) for e in raw.split("\n\n")
                             if e.startswith("data: {")]
    return resp.status, json.loads(raw)


@pytest.mark.parametrize("chat", [False, True])
def test_server_logprobs_json_match_jax(servers, chat):
    """``test_server_logprobs_json`` and ``_via_continuous_engine``: the
    same text and logprobs JSON as the JAX server, riding the engine."""
    route = "/v1/chat/completions" if chat else "/v1/completions"
    payload = ({"messages": [{"role": "user", "content": "hi there"}], "logprobs": True,
                "top_logprobs": 2} if chat else {"prompt": "abc", "logprobs": 2})
    payload["max_tokens"] = 6
    (ps, port), (js, ref) = (_post(servers[k], route, payload) for k in ("port", "jax"))
    assert ps == js == 200
    pc, jc = port["choices"][0], ref["choices"][0]
    assert pc.get("text", pc.get("message")) == jc.get("text", jc.get("message"))
    if chat:
        got, want = pc["logprobs"]["content"], jc["logprobs"]["content"]
        assert [e["token"] for e in got] == [e["token"] for e in want]
        np.testing.assert_allclose([e["logprob"] for e in got], [e["logprob"] for e in want],
                                   atol=LP_TOL)
        assert [[t["token"] for t in e["top_logprobs"]] for e in got] == \
            [[t["token"] for t in e["top_logprobs"]] for e in want]
    else:
        got, want = pc["logprobs"], jc["logprobs"]
        assert (got["tokens"], got["text_offset"]) == (want["tokens"], want["text_offset"])
        np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], atol=LP_TOL)
        assert [sorted(d) for d in got["top_logprobs"]] == \
            [sorted(d) for d in want["top_logprobs"]]
    assert port["usage"] == ref["usage"]


def test_server_logprobs_zero_returns_chosen_only(servers):
    status, body = _post(servers["port"], "/v1/completions",
                         {"prompt": "abc", "max_tokens": 4, "logprobs": 0})
    lp = body["choices"][0]["logprobs"]
    assert status == 200 and len(lp["token_logprobs"]) == len(lp["tokens"]) > 0
    assert all(d == {} for d in lp["top_logprobs"])


@pytest.mark.parametrize("chat", [False, True])
def test_streamed_logprobs_match_jax(servers, chat):
    """``test_server_streaming_logprobs_via_continuous_engine``: the chunks'
    logprobs concatenate to the unstreamed ones, in the JAX server's event
    layout."""
    route = "/v1/chat/completions" if chat else "/v1/completions"
    payload = ({"messages": [{"role": "user", "content": "abc"}], "logprobs": True,
                "top_logprobs": 2} if chat else {"prompt": "abc", "logprobs": 2})
    payload["max_tokens"] = 10

    def flat(events):
        toks, lps = [], []
        for ev in events:
            lp = ev["choices"][0].get("logprobs")
            if not lp:
                continue
            entries = lp["content"] if chat else [
                {"token": t, "logprob": v} for t, v in zip(lp["tokens"], lp["token_logprobs"])]
            toks += [e["token"] for e in entries]
            lps += [e["logprob"] for e in entries]
        return toks, lps

    streamed = {}
    for key in ("port", "jax"):
        status, events = _post(servers[key], route, {**payload, "stream": True})
        assert status == 200 and events[-1]["choices"][0]["finish_reason"] is not None
        streamed[key] = flat(events)
    assert streamed["port"][0] == streamed["jax"][0]
    np.testing.assert_allclose(streamed["port"][1], streamed["jax"][1], atol=LP_TOL)
    status, body = _post(servers["port"], route, payload)
    lp = body["choices"][0]["logprobs"]
    entries = lp["content"] if chat else [{"token": t, "logprob": v}
                                          for t, v in zip(lp["tokens"], lp["token_logprobs"])]
    assert streamed["port"][0] == [e["token"] for e in entries]
    np.testing.assert_allclose(streamed["port"][1], [e["logprob"] for e in entries],
                               atol=LP_TOL)


@pytest.mark.parametrize("payload", [
    {"prompt": "x", "stream": True, "logprobs": 1, "stop": ["q"]},
    {"prompt": "x", "stream": True, "logprobs": 5},
])
def test_streamed_logprob_refusals_match_jax(servers, payload):
    """Streamed logprobs with a stop sequence, or N beyond --logprobs-k:
    400 with the reference's message."""
    (ps, port), (js, ref) = (_post(servers[k], "/v1/completions", payload)
                             for k in ("port", "jax"))
    assert ps == js == 400 and port["error"]["message"] == ref["error"]["message"]


def test_cli_logprobs_k_arms_the_engine():
    srv = tserver.create_server([
        "--device", "cpu", "--port", "0", "--host", "127.0.0.1", "--override", "num_layers=1",
        "--override", "vocab_size=300", "--override", "max_seq_len=128", "--engine",
        "continuous", "--cache-mode", "paged", "--page-size", "16", "--logprobs-k", "4"])
    try:
        assert srv.RequestHandlerClass.threaded_engine.logprobs_k == 4
    finally:
        srv.server_close()
        srv.engine.close()
