"""The port's OpenAI-compatible server on ``device="cpu"`` at tiny size:
every route answers, and its greedy completion text equals the JAX package's
``Generator`` output for the same weights (f32 compute, so greedy argmax
cannot flip on rounding)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.infer import grammar as JG  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.engine import Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
            dtype="float32")


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    gen = Generator(params_from_jax(jax.device_get(params), cfg, "cpu"), cfg,
                    ByteTokenizer(), device="cpu")
    srv = tserver.make_server(gen, port=0, model_name="tiny", default_max_tokens=8,
                              max_pending=4)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        yield url, JaxGenerator(params, jcfg, JaxByteTokenizer()), srv
    finally:
        srv.close(drain=False)
        thread.join(timeout=10)
        assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jax_text(jgen, prompt, max_tokens):
    tok = JaxByteTokenizer()
    out = jgen.generate_tokens([[tok.bos_id] + tok.encode(prompt)],
                               JaxGenerateConfig(max_new_tokens=max_tokens))[0]
    return tok.decode(out), len(out)


def test_get_routes(served):
    url, _, _ = served
    status, health = _get(url + "/health")
    assert status == 200 and health["status"] == "ok" and health["model"] == "tiny"
    status, models = _get(url + "/v1/models")
    assert status == 200 and models["data"][0]["id"] == "tiny"
    status, stats = _get(url + "/v1/stats")
    assert status == 200 and stats["engine"] == "lockstep" and stats["device"] == "cpu"
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(url + "/nope")
    assert err.value.code == 404


def test_completion_text_matches_jax_generator(served):
    url, jgen, _ = served
    prompt = "The quick brown fox"
    status, body = _post(url + "/v1/completions",
                         {"prompt": prompt, "max_tokens": 10, "temperature": 0})
    assert status == 200
    text, n = _jax_text(jgen, prompt, 10)
    choice = body["choices"][0]
    assert choice["text"] == text
    assert body["usage"]["completion_tokens"] == n
    assert choice["finish_reason"] == ("length" if n == 10 else "stop")


def test_chat_completion_matches_jax_generator(served):
    url, jgen, _ = served
    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hello there"}]
    status, body = _post(url + "/v1/chat/completions",
                         {"messages": messages, "max_tokens": 6})
    assert status == 200
    text, _ = _jax_text(jgen, tserver._chat_prompt(messages), 6)
    assert body["object"] == "chat.completion"
    assert body["choices"][0]["message"]["content"] == text


@pytest.mark.parametrize("chat", [False, True])
def test_logprobs_match_jax_generator(served, chat):
    """OpenAI logprobs on both routes: the chosen tokens' logprobs equal the
    JAX Generator's (f32 log-softmax of the same logits: 1e-4)."""
    url, jgen, _ = served
    tok = JaxByteTokenizer()
    if chat:
        messages = [{"role": "user", "content": "logprob probe"}]
        payload = {"messages": messages, "max_tokens": 5, "logprobs": True,
                   "top_logprobs": 2}
        prompt = tserver._chat_prompt(messages)
    else:
        prompt = "logprob probe"
        payload = {"prompt": prompt, "max_tokens": 5, "logprobs": 2}
    status, body = _post(url + ("/v1/chat/completions" if chat else "/v1/completions"),
                         payload)
    assert status == 200
    ids, lps = jgen.generate_tokens_with_logprobs(
        [[tok.bos_id] + tok.encode(prompt)], JaxGenerateConfig(max_new_tokens=5, logprobs=2))
    lp = body["choices"][0]["logprobs"]
    if chat:
        tokens = [e["token"] for e in lp["content"]]
        chosen = [e["logprob"] for e in lp["content"]]
        assert all(len(e["top_logprobs"]) == 2 for e in lp["content"])
    else:
        tokens, chosen = lp["tokens"], lp["token_logprobs"]
        assert lp["text_offset"][0] == len(prompt)
    assert tokens == [tok.decode([t]) for t in ids[0]]
    np.testing.assert_allclose(chosen, lps[0]["token_logprobs"], atol=1e-4, rtol=1e-4)


def test_stop_sequence_and_seeded_sampling(served):
    url, jgen, _ = served
    full, _ = _jax_text(jgen, "abc", 12)
    stop = full[3:5] if len(full) >= 5 else None
    if stop:
        status, body = _post(url + "/v1/completions",
                             {"prompt": "abc", "max_tokens": 12, "stop": stop})
        assert status == 200
        assert body["choices"][0]["text"] == full[:full.find(stop)]
        assert body["choices"][0]["finish_reason"] == "stop"
    req = {"prompt": "abc", "max_tokens": 8, "temperature": 1.0, "top_p": 0.9, "seed": 5}
    a = _post(url + "/v1/completions", req)[1]["choices"][0]["text"]
    b = _post(url + "/v1/completions", req)[1]["choices"][0]["text"]
    assert a == b


def test_bad_requests_and_overload(served):
    url, _, srv = served
    assert _post(url + "/v1/completions", {"prompt": "x", "stop": [3]})[0] == 400
    assert _post(url + "/v1/completions",
                 {"prompt": "x", "stream": True, "logprobs": 1})[0] == 400
    assert _post(url + "/v1/completions", {"prompt": "x", "max_tokens": 1000})[0] == 400
    assert _post(url + "/v1/nope", {})[0] == 404
    # Hold the device lock so requests pile up: beyond max_pending (4) in
    # flight the server answers 429.
    handler = srv.RequestHandlerClass
    results = []
    with handler.device_lock:
        threads = [threading.Thread(target=lambda: results.append(
            _post(url + "/v1/completions", {"prompt": "y", "max_tokens": 2})[0]))
            for _ in range(6)]
        for t in threads:
            t.start()
        for _ in range(200):
            if results.count(429) >= 2:
                break
            threading.Event().wait(0.05)
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(results) == [200] * 4 + [429] * 2


def test_drain_answers_503(served):
    url, _, srv = served
    srv.draining = True
    try:
        assert _post(url + "/v1/completions", {"prompt": "x"})[0] == 503
        assert _get(url + "/health")[1]["status"] == "draining"
    finally:
        srv.draining = False


def test_cli_builds_a_cpu_server():
    srv = tserver.create_server([
        "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
        "--override", "num_layers=1", "--override", "vocab_size=300",
        "--override", "attention_impl=flash"])
    try:
        gen = srv.RequestHandlerClass.generator
        assert gen.cfg.attention_impl == "flash" and gen.cfg.num_layers == 1
        assert gen.generate_tokens([[1, 5, 6]])
    finally:
        srv.server_close()
    with pytest.raises(ValueError, match="bad override"):
        tserver.create_server(["--device", "cpu", "--override", "nope=1"])


def test_cli_serves_a_trained_checkpoint(tmp_path):
    """``--checkpoint-dir``: the port's trainer saves two steps' masters, the
    server restores them as its serving tree (not the seed's weights), and
    its greedy completion equals the JAX Generator's over the trained tree;
    a preset that does not match the checkpoint fails loudly."""
    import jax.numpy as jnp

    from ditl_tpu_torch.config import Config, DataConfig, TrainConfig
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.models.convert import params_to_numpy
    from ditl_tpu_torch.train.trainer import train

    cfg = ModelConfig(**TINY)
    out = train(Config(model=cfg, data=DataConfig(synthetic=True, batch_size=2, seq_len=64),
                       train=TrainConfig(total_steps=2, warmup_steps=1, learning_rate=1e-2,
                                         checkpoint_dir=str(tmp_path))), device="cpu")
    assert out["steps"] == 2
    masters = torch.load(tmp_path / "2" / "params.pt", weights_only=True)
    overrides = [x for k, v in TINY.items() for x in ("--override", f"{k}={v}")]
    srv = tserver.create_server(["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                                 "--checkpoint-dir", str(tmp_path), *overrides])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        served = srv.RequestHandlerClass.generator.params
        want = llama.serving_params(masters, cfg)
        seed = llama.init_params(cfg, seed=0, device="cpu")
        for group in ("attn", "mlp"):
            for key, w in want["layers"][group].items():
                assert torch.equal(served["layers"][group][key], w), key
                assert not torch.equal(served["layers"][group][key],
                                       seed["layers"][group][key]), key
        assert torch.equal(served["lm_head"]["kernel"], want["lm_head"]["kernel"])
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        prompt = "The quick brown fox"
        status, body = _post(url + "/v1/completions",
                             {"prompt": prompt, "max_tokens": 10, "temperature": 0})
        assert status == 200
        jparams = jax.tree.map(jnp.asarray, params_to_numpy(masters))
        text, n = _jax_text(JaxGenerator(jparams, JaxModelConfig(**TINY),
                                         JaxByteTokenizer()), prompt, 10)
        assert body["choices"][0]["text"] == text
        assert body["usage"]["completion_tokens"] == n
    finally:
        srv.close(drain=False)
        thread.join(timeout=10)
    assert not thread.is_alive()
    wrong = [x for k, v in dict(TINY, hidden_size=128).items()
             for x in ("--override", f"{k}={v}")]
    with pytest.raises(ValueError, match="does not match the model config"):
        tserver.create_server(["--device", "cpu", "--port", "0",
                               "--checkpoint-dir", str(tmp_path), *wrong])


# -- the continuous engine -------------------------------------------------------


@pytest.fixture(scope="module")
def served_continuous():
    """``--engine continuous --cache-mode paged`` on the CPU: 2 slots, page
    16, at most 4 queued requests; the lock-step Generator over the same
    weights serves logprob requests."""
    from ditl_tpu_torch.infer.continuous import ContinuousEngine, ThreadedEngine

    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    gen = Generator(tparams, cfg, ByteTokenizer(), device="cpu")
    engine = ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged",
                              n_slots=2, page_size=16, decode_chunk=4, max_queue=4,
                              device="cpu")
    srv = tserver.make_server(gen, threaded_engine=ThreadedEngine(engine), port=0,
                              model_name="tiny", default_max_tokens=8)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        yield url, JaxGenerator(params, jcfg, JaxByteTokenizer()), srv, engine
    finally:
        srv.close(drain=True)
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert not srv.engine._thread.is_alive(), "close() stops the driver thread"


def test_continuous_serves_concurrent_requests(served_continuous):
    """Four concurrent greedy completions (two slots, the rest queued) share
    decode ticks; each text is the JAX Generator's greedy text for its
    prompt."""
    url, jgen, _, engine = served_continuous
    prompts = [f"request {i} " * (i + 1) for i in range(4)]
    results = {}

    def one(i):
        results[i] = _post(url + "/v1/completions",
                           {"prompt": prompts[i], "max_tokens": 7})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    ticks0 = engine.decode_ticks
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, p in enumerate(prompts):
        status, body = results[i]
        assert status == 200
        text, n = _jax_text(jgen, p, 7)
        assert body["choices"][0]["text"] == text
        assert body["usage"]["completion_tokens"] == n
    assert engine.decode_ticks > ticks0


def test_continuous_full_queue_429_and_oversize_400(served_continuous):
    url, _, _, engine = served_continuous
    gate = threading.Event()
    step = engine.step

    def gated_step():  # the driver waits here: submissions pile up
        gate.wait(timeout=60)
        step()

    engine.step = gated_step
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        _post(url + "/v1/completions", {"prompt": "queue", "max_tokens": 2})[0]))
        for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for _ in range(400):
            if results.count(429) >= 1:
                break
            threading.Event().wait(0.05)
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=120)
        engine.step = step
    assert 429 in results and 200 in results and set(results) <= {200, 429}
    status, body = _post(url + "/v1/completions", {"prompt": "x" * 200, "max_tokens": 64})
    assert status == 400 and "exceeds" in body["error"]["message"]


def test_continuous_stats_and_health_carry_pages(served_continuous):
    url, _, _, _ = served_continuous
    _post(url + "/v1/completions", {"prompt": "x" * 40, "max_tokens": 3})
    status, stats = _get(url + "/v1/stats")
    assert status == 200 and stats["engine"] == "continuous"
    assert stats["cache_mode"] == "paged" and stats["page_size"] == 16
    assert stats["pages_total"] == 2 * 8
    assert stats["pages_free"] + stats["pages_cached_evictable"] == stats["pages_total"]
    assert stats["prefix_cache"]["miss_tokens"] > 0 and stats["decode_steps"] > 0
    status, health = _get(url + "/health")
    assert status == 200 and health["status"] == "ok"
    assert (health["n_slots"], health["pages_total"]) == (2, 16)
    assert health["queue_depth"] == 0 and "pages_free" in health


def test_continuous_logprobs_served_by_lockstep_fallback(served_continuous):
    """A logprob request runs on the lock-step Generator (no decode tick of
    the continuous engine), with the JAX Generator's logprobs."""
    url, jgen, _, engine = served_continuous
    tok = JaxByteTokenizer()
    ticks0 = engine.decode_ticks
    status, body = _post(url + "/v1/completions",
                         {"prompt": "logprob probe", "max_tokens": 5, "logprobs": 2})
    assert status == 200 and engine.decode_ticks == ticks0
    ids, lps = jgen.generate_tokens_with_logprobs(
        [[tok.bos_id] + tok.encode("logprob probe")],
        JaxGenerateConfig(max_new_tokens=5, logprobs=2))
    lp = body["choices"][0]["logprobs"]
    assert lp["tokens"] == [tok.decode([t]) for t in ids[0]]
    np.testing.assert_allclose(lp["token_logprobs"], lps[0]["token_logprobs"],
                               atol=1e-4, rtol=1e-4)


def test_cli_continuous_server_and_contiguous_raises():
    """Both cache modes build from the CLI: ``--cache-mode paged`` with its
    pool, and the default (no ``--cache-mode``), the contiguous cache, which
    also serves a completion (the name predates the contiguous port)."""
    base = ["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
            "--override", "num_layers=1", "--override", "vocab_size=300",
            "--override", "max_seq_len=128", "--engine", "continuous"]
    srv = tserver.create_server(base + ["--cache-mode", "paged", "--page-size", "16",
                                        "--slots", "2", "--max-queue", "3"])
    try:
        st = srv.RequestHandlerClass.threaded_engine.stats()
        assert (st["n_slots"], st["page_size"], st["max_queue"]) == (2, 16, 3)
        assert st["pages_total"] == 2 * 8
    finally:
        srv.server_close()  # never served: no serve loop to shut down
        srv.engine.close()
    assert not srv.engine._thread.is_alive()
    srv = tserver.create_server(base + ["--slots", "2"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        st = srv.RequestHandlerClass.threaded_engine.stats()
        assert (st["cache_mode"], st["n_slots"]) == ("contiguous", 2)
        assert "pages_total" not in st
        status, body = _post(url + "/v1/completions", {"prompt": "hi", "max_tokens": 3})
        assert status == 200 and body["usage"]["completion_tokens"] == 3
    finally:
        srv.close(drain=True)
        thread.join(timeout=30)
    assert not srv.engine._thread.is_alive()


# -- int8 serving ------------------------------------------------------------------


def _int8_reference(params_np: dict, prompt: str, max_tokens: int, quantize: bool):
    """The JAX Generator's greedy text over ``params_np`` with an int8 KV
    cache (the weights quantized by the JAX package first if ``quantize``)."""
    import jax.numpy as jnp

    from ditl_tpu.ops.quant import quantize_weights

    jparams = jax.tree.map(jnp.asarray, params_np)
    if quantize:
        jparams = quantize_weights(jparams)
    return _jax_text(JaxGenerator(jparams, JaxModelConfig(**TINY, kv_cache_dtype="int8"),
                                  JaxByteTokenizer()), prompt, max_tokens)


def _serve_int8_and_check(srv, want_text: str, want_n: int, prompt: str) -> None:
    """One greedy completion through the continuous engine and one logprob
    request through the lock-step Generator: both give ``want_text``."""
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        for extra in ({}, {"logprobs": 1}):
            status, body = _post(url + "/v1/completions",
                                 {"prompt": prompt, "max_tokens": 10, "temperature": 0,
                                  **extra})
            assert status == 200, body
            assert body["choices"][0]["text"] == want_text, extra
            assert body["usage"]["completion_tokens"] == want_n
    finally:
        srv.close(drain=True)
        thread.join(timeout=10)
    assert not thread.is_alive()


INT8_FLAGS = ["--quantize", "int8", "--kv-quant", "int8", "--engine", "continuous",
              "--cache-mode", "paged", "--page-size", "16", "--slots", "2"]


@pytest.fixture(scope="module")
def contiguous_servers():
    """The port's and the JAX package's continuous servers with their
    default cache mode, the contiguous cache (2 slots, decode_chunk 4), over
    the same weights."""
    from ditl_tpu.infer import server as jserver
    from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine
    from ditl_tpu.infer.continuous import ThreadedEngine as JaxThreadedEngine
    from ditl_tpu_torch.infer.continuous import ContinuousEngine, ThreadedEngine

    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    kw = dict(n_slots=2, decode_chunk=4)
    jte = JaxThreadedEngine(JaxEngine(params, jcfg, JaxByteTokenizer(), **kw))
    built = {
        "port": tserver.make_server(
            Generator(tparams, cfg, ByteTokenizer(), device="cpu"), port=0,
            default_max_tokens=8, threaded_engine=ThreadedEngine(
                ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **kw))),
        "jax": jserver.make_server(
            JaxGenerator(params, jcfg, JaxByteTokenizer()), port=0, default_max_tokens=8,
            threaded_engine=jte),
    }
    threads = {k: threading.Thread(target=srv.serve_forever, daemon=True)
               for k, srv in built.items()}
    for th in threads.values():
        th.start()
    try:
        yield {k: f"http://127.0.0.1:{srv.server_address[1]}" for k, srv in built.items()}
    finally:
        for k, srv in built.items():
            srv.close(drain=False)
            threads[k].join(timeout=30)
        jte.close()


def _completions(url: str, payloads: list) -> list:
    """POST ``payloads`` to /v1/completions concurrently; the bodies."""
    out = [None] * len(payloads)

    def one(i):
        out[i] = _post(url + "/v1/completions", payloads[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert all(o is not None and o[0] == 200 for o in out), out
    return [o[1] for o in out]


def test_contiguous_greedy_completions_match_the_jax_server(contiguous_servers):
    """Four concurrent greedy completions over two contiguous slots: the
    JAX server's text and token counts."""
    payloads = [{"prompt": p, "max_tokens": m} for p, m in
                [("hello world", 8), ("the quick brown fox", 6), ("abc", 8), ("x", 5)]]
    got = {k: _completions(url, payloads) for k, url in contiguous_servers.items()}
    for t, j in zip(got["port"], got["jax"]):
        assert t["choices"][0]["text"] == j["choices"][0]["text"]
        assert t["usage"] == j["usage"]


def test_contiguous_health_and_stats_match_the_jax_server(contiguous_servers):
    """``/health``'s load snapshot (queue, slots, prefix-cache tokens) and
    ``/v1/stats``' scheduler fields are the reference's on a contiguous
    engine, with no page field and no ``KeyError`` (the per-tick prefill
    peak depends on when the HTTP threads arrive, so it is left out)."""
    _completions(contiguous_servers["port"], [{"prompt": "stats probe", "max_tokens": 3}])
    _completions(contiguous_servers["jax"], [{"prompt": "stats probe", "max_tokens": 3}])
    health = {k: _get(url + "/health") for k, url in contiguous_servers.items()}
    stats = {k: _get(url + "/v1/stats") for k, url in contiguous_servers.items()}
    assert health["port"][0] == health["jax"][0] == 200
    load = ("queue_depth", "active_slots", "n_slots", "cache_hit_tokens", "cache_miss_tokens")
    for key in load:
        assert health["port"][1][key] == health["jax"][1][key], key
    for body in (health["port"][1], stats["port"][1]):
        assert not any(k.startswith("page") for k in body)
    tst, jst = stats["port"][1], stats["jax"][1]
    for key in ("engine", "cache_mode", "n_slots", "decode_chunk", "max_context",
                "prefix_cache", "queue_depth", "slots_busy"):
        assert tst[key] == jst[key], key
    assert tst["cache_mode"] == "contiguous"


def test_cli_int8_serves_on_both_engines():
    """``--quantize int8 --kv-quant int8``: int8 weights (the lm head too,
    the embedding float), int8 pools and an int8 lock-step cache; the
    continuous engine and the lock-step Generator each give the JAX
    Generator's greedy text over the same int8 weights and an int8 cache."""
    from ditl_tpu_torch.models.convert import params_to_numpy
    from ditl_tpu_torch.ops.quant import is_quantized_leaf

    overrides = [x for k, v in TINY.items() for x in ("--override", f"{k}={v}")]
    srv = tserver.create_server(["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                                 *overrides, *INT8_FLAGS])
    gen = srv.RequestHandlerClass.generator
    engine = srv.engine._engine
    assert gen.cfg.kv_cache_dtype == "int8" and engine.cfg.kv_cache_dtype == "int8"
    assert is_quantized_leaf(gen.params["layers"]["attn"]["wq"])
    assert is_quantized_leaf(gen.params["lm_head"]["kernel"])
    assert gen.params["embed"]["embedding"].dtype == torch.float32
    assert engine.cache["kp"].dtype == torch.int8 and "vs" in engine.cache
    prompt = "The quick brown fox"
    text, n = _int8_reference(params_to_numpy(gen.params), prompt, 10, quantize=False)
    _serve_int8_and_check(srv, text, n, prompt)


def test_cli_int8_serves_a_trained_checkpoint(tmp_path):
    """``--checkpoint-dir`` with ``--quantize int8 --kv-quant int8``: the
    restored f32 masters are quantized before the serving cast, so the
    served ``q`` and ``scale`` equal, bit for bit, the JAX package's
    ``quantize_weights`` of the same masters, in f32 serving and in bf16
    serving (the JAX server quantizes its f32 masters too); in f32 both
    engines give the JAX Generator's greedy text over that int8 tree."""
    import jax.numpy as jnp

    from ditl_tpu.ops.quant import quantize_weights as jax_quantize
    from ditl_tpu_torch.config import Config, DataConfig, TrainConfig
    from ditl_tpu_torch.models.convert import params_to_numpy
    from ditl_tpu_torch.train.trainer import train

    cfg = ModelConfig(**TINY)
    train(Config(model=cfg, data=DataConfig(synthetic=True, batch_size=2, seq_len=64),
                 train=TrainConfig(total_steps=2, warmup_steps=1, learning_rate=1e-2,
                                   checkpoint_dir=str(tmp_path))), device="cpu")
    masters = torch.load(tmp_path / "2" / "params.pt", weights_only=True)
    assert masters["layers"]["attn"]["wq"].dtype == torch.float32
    want = jax_quantize(jax.tree.map(jnp.asarray, params_to_numpy(masters)))
    for dtype in ("float32", "bfloat16"):
        overrides = [x for k, v in {**TINY, "dtype": dtype}.items()
                     for x in ("--override", f"{k}={v}")]
        srv = tserver.create_server(["--device", "cpu", "--port", "0", "--host",
                                     "127.0.0.1", "--checkpoint-dir", str(tmp_path),
                                     *overrides, *INT8_FLAGS])
        served = srv.RequestHandlerClass.generator.params
        for group in ("attn", "mlp"):
            for key, w in want["layers"][group].items():
                got = served["layers"][group][key]
                assert np.array_equal(got["q"].numpy(), np.asarray(w["q"])), (dtype, key)
                assert np.array_equal(got["scale"].numpy(), np.asarray(w["scale"])), (dtype, key)
        head = served["lm_head"]["kernel"]
        assert np.array_equal(head["q"].numpy(), np.asarray(want["lm_head"]["kernel"]["q"]))
        assert served["embed"]["embedding"].dtype == getattr(torch, dtype)
        if dtype == "float32":
            prompt = "hello int8 checkpoint"
            text, n = _int8_reference(params_to_numpy(masters), prompt, 10, quantize=True)
            _serve_int8_and_check(srv, text, n, prompt)
        else:  # never served: close the socket and stop the engine's thread
            srv.server_close()
            srv.engine.close()


# -- chunked prefill, the token budget and draft models ---------------------------

_CONT = ["--device", "cpu", "--port", "0", "--host", "127.0.0.1", "--engine", "continuous",
         "--cache-mode", "paged", "--page-size", "16", "--slots", "2"]


def _serve_one(srv, prompt: str, max_tokens: int):
    """Start ``srv``, POST one greedy completion and read /v1/stats; the
    server is closed (and its engine stopped) on the way out."""
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        status, body = _post(url + "/v1/completions",
                             {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0})
        assert status == 200, body
        status, stats = _get(url + "/v1/stats")
        assert status == 200
    finally:
        srv.close(drain=True)
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert not srv.engine._thread.is_alive()
    return body, stats


def _plain_text(gen, prompt: str, max_tokens: int) -> str:
    """The plain continuous engine's greedy text over the server's weights."""
    from ditl_tpu_torch.infer.continuous import ContinuousEngine

    return ContinuousEngine(gen.params, gen.cfg, ByteTokenizer(), device="cpu", n_slots=2,
                            cache_mode="paged", page_size=16).generate(
        [prompt], max_new_tokens=max_tokens, temperature=0.0)[0]


def test_cli_prefill_chunk_and_token_budget():
    """``--prefill-chunk 32 --token-budget 64``: a 100-character prompt
    prefills in four chunks and answers the plain engine's greedy text;
    /v1/stats carries the budget keys."""
    overrides = [x for k, v in TINY.items() for x in ("--override", f"{k}={v}")]
    srv = tserver.create_server(_CONT + overrides + ["--prefill-chunk", "32",
                                                     "--token-budget", "64"])
    engine = srv.engine._engine
    assert (engine.prefill_chunk, engine.token_budget) == (32, 64)
    prompt = "a long prompt, chunk by chunk: " + "m" * 70
    want = _plain_text(srv.RequestHandlerClass.generator, prompt, 8)
    body, stats = _serve_one(srv, prompt, 8)
    assert body["choices"][0]["text"] == want
    assert stats["token_budget"] == 64
    assert stats["slots_prefilling"] == 0
    assert 0 < stats["max_tick_prefill_tokens"] <= 64
    with pytest.raises(ValueError, match="multiple of page_size"):
        tserver.create_server(_CONT + overrides + ["--prefill-chunk", "24"])
    with pytest.raises(ValueError, match="full decode tick"):
        tserver.create_server(_CONT + overrides + ["--token-budget", "16"])


# a target of tiny widths over tiny-llama's vocabulary, so the preset drafts for it
_DRAFT_TARGET = [x for k, v in dict(TINY, vocab_size=32000).items()
                 for x in ("--override", f"{k}={v}")]


def test_cli_draft_preset_serves_and_reports_the_drafter():
    """``--speculative on --draft-preset tiny-llama``: the preset's model in
    its own dtype, seed-initialised, drafts every tick; the completion is
    the plain engine's greedy text and /v1/stats says ``drafter: model``."""
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.models.presets import get_preset

    srv = tserver.create_server(_CONT + _DRAFT_TARGET + [
        "--speculative", "on", "--draft-preset", "tiny-llama", "--prefill-chunk", "32",
        "--token-budget", "64"])
    engine = srv.engine._engine
    draft_cfg = get_preset("tiny-llama")
    assert engine.spec_draft == "model" and engine.draft_cfg == draft_cfg
    assert engine.draft_params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    seeded = llama.init_params(draft_cfg, seed=1, device="cpu")
    assert torch.equal(engine.draft_params["layers"]["attn"]["wq"],
                       seeded["layers"]["attn"]["wq"])
    prompt = "drafted by a model: " + "ab" * 30
    want = _plain_text(srv.RequestHandlerClass.generator, prompt, 10)
    body, stats = _serve_one(srv, prompt, 10)
    assert body["choices"][0]["text"] == want
    spec = stats["speculative"]
    assert spec["drafter"] == "model"
    assert spec["spec_ticks"] == spec["ticks"] > 0
    assert spec["draft_steps"] == (spec["k"] + 1) * spec["verify_rounds"]
    assert stats["token_budget"] == 64 and "max_tick_prefill_tokens" in stats


def test_cli_draft_checkpoint_restores_trained_weights(tmp_path):
    """``--draft-checkpoint``: a training run of the draft preset saves its
    masters through the port's ``CheckpointManager``; the server drafts with
    them (not the seed's weights) and still answers the plain greedy text."""
    from ditl_tpu_torch.config import Config, DataConfig, TrainConfig
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.models.presets import get_preset
    from ditl_tpu_torch.train.trainer import train

    draft_cfg = get_preset("tiny-llama")
    out = train(Config(model=draft_cfg, data=DataConfig(synthetic=True, batch_size=1,
                                                        seq_len=32),
                       train=TrainConfig(total_steps=1, warmup_steps=1, learning_rate=1e-2,
                                         checkpoint_dir=str(tmp_path))), device="cpu")
    assert out["steps"] == 1
    masters = torch.load(tmp_path / "1" / "params.pt", weights_only=True)
    srv = tserver.create_server(_CONT + _DRAFT_TARGET + [
        "--speculative", "on", "--draft-preset", "tiny-llama",
        "--draft-checkpoint", str(tmp_path)])
    engine = srv.engine._engine
    want = llama.serving_params(masters, draft_cfg)
    seeded = llama.init_params(draft_cfg, seed=1, device="cpu")
    for key, w in want["layers"]["mlp"].items():
        assert torch.equal(engine.draft_params["layers"]["mlp"][key], w), key
        assert not torch.equal(engine.draft_params["layers"]["mlp"][key],
                               seeded["layers"]["mlp"][key]), key
    prompt = "a trained drafter"
    text = _plain_text(srv.RequestHandlerClass.generator, prompt, 6)
    body, stats = _serve_one(srv, prompt, 6)
    assert body["choices"][0]["text"] == text
    assert stats["speculative"]["drafter"] == "model"


@pytest.mark.parametrize("args,what", [
    (["--engine", "lockstep", "--speculative", "on", "--draft-preset", "tiny-llama"],
     "requires --engine continuous"),
    (["--engine", "continuous", "--draft-preset", "tiny-llama"],
     "requires --engine continuous"),
    (["--engine", "continuous", "--speculative", "on", "--draft-checkpoint", "x"],
     "needs --draft-preset"),
    (["--engine", "continuous", "--cache-mode", "paged", "--speculative", "on",
      "--draft-preset", "llama3-8b"], "must match the target"),
    (["--engine", "continuous", "--cache-mode", "paged", "--speculative", "on",
      "--draft-preset", "tiny-llama", "--draft-checkpoint", "EMPTY"], "no checkpoint"),
])
def test_cli_draft_flag_errors(args, what, tmp_path, capsys):
    """The reference's parser errors for the draft flags, and its vocab and
    empty-checkpoint checks: each exits 2 with its message."""
    args = [str(tmp_path) if a == "EMPTY" else a for a in args]
    with pytest.raises(SystemExit) as exc:
        tserver.create_server(["--device", "cpu", "--port", "0", *_DRAFT_TARGET, *args])
    assert exc.value.code == 2
    assert what in capsys.readouterr().err


# -- n/best_of, deadline_s and slo_class, against the JAX server -------------------


@pytest.fixture(scope="module")
def four_servers():
    """The port's and the JAX package's lock-step and continuous servers
    (2 slots, page 16, ``--logprobs-k 2``) over the same weights; the port's
    continuous engine records the fields each submit passes on."""
    from ditl_tpu.infer import server as jserver
    from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine
    from ditl_tpu.infer.continuous import ThreadedEngine as JaxThreadedEngine
    from ditl_tpu_torch.infer.continuous import ContinuousEngine, ThreadedEngine

    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    paged = dict(cache_mode="paged", n_slots=2, page_size=16, decode_chunk=4, logprobs_k=2)
    engine = ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **paged)
    submitted = []
    submit = engine.submit

    def recording_submit(prompt, **kw):
        submitted.append(kw)
        return submit(prompt, **kw)

    engine.submit = recording_submit
    jte = JaxThreadedEngine(JaxEngine(params, jcfg, JaxByteTokenizer(), **paged))
    built = {
        ("port", "lockstep"): tserver.make_server(
            Generator(tparams, cfg, ByteTokenizer(), device="cpu"), port=0,
            default_max_tokens=6),
        ("port", "continuous"): tserver.make_server(
            Generator(tparams, cfg, ByteTokenizer(), device="cpu"), port=0,
            default_max_tokens=6, threaded_engine=ThreadedEngine(engine)),
        ("jax", "lockstep"): jserver.make_server(
            JaxGenerator(params, jcfg, JaxByteTokenizer()), port=0, default_max_tokens=6),
        ("jax", "continuous"): jserver.make_server(
            JaxGenerator(params, jcfg, JaxByteTokenizer()), port=0, default_max_tokens=6,
            threaded_engine=jte),
    }
    threads = {}
    for key, srv in built.items():
        threads[key] = threading.Thread(target=srv.serve_forever, daemon=True)
        threads[key].start()
    try:
        yield ({key: f"http://127.0.0.1:{srv.server_address[1]}" for key, srv in built.items()},
               submitted)
    finally:
        for key, srv in built.items():
            srv.close(drain=False)
            threads[key].join(timeout=30)
        jte.close()


def _post_h(url, payload, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _both(urls, engine, payload, headers=None, route="/v1/completions"):
    """(port's, JAX's) (status, body) for the same request."""
    return tuple(_post_h(urls[(side, engine)] + route, payload, headers)
                 for side in ("port", "jax"))


# (engine, payload, headers): refused by both servers with one status and
# message. ``bogus`` classes, deadlines at or below 0 (504), non-numbers,
# n/best_of out of range or with stream/logprobs, payload deadlines and
# classes the lock-step engine cannot honour, a payload deadline on n > 1.
REFUSALS = [
    ("lockstep", {"slo_class": "urgent"}, None),
    ("continuous", {"slo_class": "urgent"}, None),
    ("continuous", {}, {"X-SLO-Class": "urgent"}),
    ("lockstep", {"slo_class": "batch"}, None),
    ("lockstep", {"deadline_s": 0}, None),
    ("continuous", {"deadline_s": -1.5}, None),
    ("continuous", {}, {"X-Request-Deadline-S": "0"}),
    ("lockstep", {}, {"X-Request-Deadline-S": "0"}),
    ("continuous", {"deadline_s": "soon"}, None),
    ("continuous", {}, {"X-Request-Deadline-S": "nan"}),
    ("lockstep", {"deadline_s": 5}, None),
    ("continuous", {"deadline_s": 5, "n": 2}, None),
    ("continuous", {"n": 3, "best_of": 2}, None),
    ("continuous", {"n": 9}, None),
    ("lockstep", {"n": 3, "best_of": 9}, None),
    ("continuous", {"n": "two"}, None),
    ("continuous", {"n": 2, "stream": True}, None),
    ("continuous", {"n": 2, "logprobs": 1}, None),
    ("lockstep", {"best_of": 2, "stream": True}, None),
    ("continuous", {"logprobs": 5, "slo_class": "batch"}, None),
    ("continuous", {"guided_regex": "[ab]+"}, None),
    ("lockstep", {"response_format": {"type": "json_object"}}, None),
]


@pytest.mark.parametrize("engine,payload,headers", REFUSALS)
def test_refusals_match_the_jax_server(four_servers, engine, payload, headers):
    urls, _ = four_servers
    (ps, port), (js, ref) = _both(urls, engine, {"prompt": "hi", **payload}, headers)
    assert ps == js and ps in (400, 504), (port, ref)
    assert port["error"]["message"] == ref["error"]["message"]
    assert port["error"].get("type") == ref["error"].get("type")


# Served by both: a header's class or deadline the path cannot honour is
# dropped; the header's class wins over the payload's.
SERVED = [
    ("lockstep", {"slo_class": "interactive"}, None),
    ("lockstep", {}, {"X-SLO-Class": "batch"}),
    ("lockstep", {}, {"X-Request-Deadline-S": "5"}),
    ("continuous", {"slo_class": "urgent"}, {"X-SLO-Class": "batch"}),
    ("continuous", {"n": 2}, {"X-Request-Deadline-S": "5"}),
    ("continuous", {"logprobs": 5}, {"X-SLO-Class": "best_effort"}),
]


@pytest.mark.parametrize("engine,payload,headers", SERVED)
def test_dropped_and_overridden_fields_match_the_jax_server(four_servers, engine, payload,
                                                            headers):
    urls, _ = four_servers
    (ps, port), (js, ref) = _both(urls, engine, {"prompt": "hi", **payload}, headers)
    assert ps == js == 200
    assert [c["text"] for c in port["choices"]] == [c["text"] for c in ref["choices"]]
    assert port["usage"] == ref["usage"]


def test_slo_class_and_deadline_reach_the_engine(four_servers):
    """The continuous engine gets the header's class over the payload's,
    the payload's deadline over the header's; a logprob request beyond
    ``--logprobs-k`` goes to the lock-step Generator without either."""
    urls, submitted = four_servers
    url = urls[("port", "continuous")] + "/v1/completions"
    cases = [({"prompt": "a", "slo_class": "batch", "deadline_s": 30}, None,
              {"slo_class": "batch", "deadline_s": 30.0}),
             ({"prompt": "a", "slo_class": "batch"}, {"X-SLO-Class": "best_effort",
                                                      "X-Request-Deadline-S": "20"},
              {"slo_class": "best_effort", "deadline_s": 20.0}),
             ({"prompt": "a", "logprobs": 1}, {"X-SLO-Class": "interactive"},
              {"slo_class": "interactive", "deadline_s": None, "logprobs": 1})]
    for payload, headers, want in cases:
        del submitted[:]
        status, _ = _post_h(url, payload, headers)
        assert status == 200 and len(submitted) == 1
        assert {k: submitted[0].get(k) for k in want} == want
    del submitted[:]
    assert _post_h(url, {"prompt": "a", "logprobs": 5}, {"X-SLO-Class": "batch"})[0] == 200
    assert submitted == []  # the lock-step fallback


@pytest.mark.parametrize("engine", ["lockstep", "continuous"])
@pytest.mark.parametrize("chat", [False, True])
def test_n_best_of_greedy_matches_the_jax_server(four_servers, engine, chat):
    """Greedy ``n``/``best_of``: every candidate is the greedy completion,
    so the choices' texts, indices and the usage counting all ``best_of``
    candidates equal the JAX server's."""
    urls, _ = four_servers
    route = "/v1/chat/completions" if chat else "/v1/completions"
    body = ({"messages": [{"role": "user", "content": "hi"}]} if chat
            else {"prompt": "the quick"})
    (ps, port), (js, ref) = _both(urls, engine, {**body, "n": 2, "best_of": 3}, route=route)
    assert ps == js == 200
    assert port["choices"] == ref["choices"] and len(port["choices"]) == 2
    assert port["usage"] == ref["usage"]
    assert port["usage"]["completion_tokens"] == 3 * 6


def test_n_best_of_sampled_on_the_continuous_engine(four_servers):
    """Sampled ``n: 2, best_of: 3``: two choices ranked by mean token
    logprob, the copies seeded by ``derive_copy_seed``, so the ``n: 1``
    completion with the same seed is copy 0; usage counts three."""
    urls, submitted = four_servers
    url = urls[("port", "continuous")] + "/v1/completions"
    req = {"prompt": "the quick", "temperature": 1.0, "seed": 11, "max_tokens": 8}
    del submitted[:]
    status, body = _post_h(url, {**req, "n": 2, "best_of": 3})
    assert status == 200 and [c["index"] for c in body["choices"]] == [0, 1]
    assert [kw["seed"] for kw in submitted] == [11, 11 + 7919, 11 + 2 * 7919]
    assert all(kw["logprobs"] == 0 for kw in submitted)
    assert body["usage"]["completion_tokens"] <= 3 * 8
    _, one = _post_h(url, req)
    status, n3 = _post_h(url, {**req, "n": 3})
    assert status == 200 and n3["choices"][0]["text"] == one["choices"][0]["text"]
    assert body["choices"][0]["text"] in [c["text"] for c in n3["choices"]]


def test_derive_copy_seed_matches_the_reference():
    from ditl_tpu.infer.continuous import derive_copy_seed as jax_seed
    from ditl_tpu_torch.infer.continuous import derive_copy_seed

    for base in (0, 7, 2**31 - 1, 123456789):
        for i in range(8):
            assert derive_copy_seed(base, i) == jax_seed(base, i)


def test_cli_admission_and_logprobs_k(capsys):
    base = ["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
            "--override", "num_layers=1", "--override", "vocab_size=300",
            "--override", "max_seq_len=128"]
    srv = tserver.create_server(base + ["--engine", "continuous", "--cache-mode", "paged",
                                        "--page-size", "16", "--admission", "optimistic",
                                        "--logprobs-k", "3"])
    try:
        st = srv.RequestHandlerClass.threaded_engine.stats()
        assert st["admission"] == "optimistic" and st["admission_degrades"] == 0
        assert srv.RequestHandlerClass.threaded_engine.logprobs_k == 3
    finally:
        srv.server_close()
        srv.engine.close()
    with pytest.raises(SystemExit) as exc:
        tserver.create_server(base + ["--admission", "optimistic"])
    assert exc.value.code == 2 and "--admission optimistic requires" in capsys.readouterr().err


# -- guided decoding (--fsm-capacity), against the JAX server ----------------------


@pytest.fixture(scope="module")
def guided_servers():
    """The port's and the JAX package's continuous servers armed for guided
    decoding over the same weights: ``armed`` (a 4096-row table, ``--logprobs-k
    2``) and ``small`` (16 rows, no logprobs: a JSON grammar does not fit)."""
    from ditl_tpu.infer import server as jserver
    from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine
    from ditl_tpu.infer.continuous import ThreadedEngine as JaxThreadedEngine
    from ditl_tpu_torch.infer.continuous import ContinuousEngine, ThreadedEngine

    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    base = dict(cache_mode="paged", n_slots=2, page_size=16, decode_chunk=4)
    kinds = {"armed": dict(fsm_capacity=4096, logprobs_k=2), "small": dict(fsm_capacity=16)}
    built, engines = {}, []
    for kind, kw in kinds.items():
        te = ThreadedEngine(ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu",
                                             **base, **kw))
        jte = JaxThreadedEngine(JaxEngine(params, jcfg, JaxByteTokenizer(), **base, **kw))
        engines += [te, jte]
        built[("port", kind)] = tserver.make_server(
            Generator(tparams, cfg, ByteTokenizer(), device="cpu"), port=0,
            default_max_tokens=12, threaded_engine=te)
        built[("jax", kind)] = jserver.make_server(
            JaxGenerator(params, jcfg, JaxByteTokenizer()), port=0, default_max_tokens=12,
            threaded_engine=jte)
    threads = {}
    for key, srv in built.items():
        threads[key] = threading.Thread(target=srv.serve_forever, daemon=True)
        threads[key].start()
    try:
        yield {key: f"http://127.0.0.1:{srv.server_address[1]}" for key, srv in built.items()}
    finally:
        for key, srv in built.items():
            srv.close(drain=False)
            threads[key].join(timeout=30)
        for eng in engines:
            eng.close()


RECORD = {"type": "object", "properties": {
    "n": {"type": "integer", "minimum": 0, "maximum": 99},
    "u": {"anyOf": [{"const": "a"}, {"const": "b"}]}},
    "required": ["n", "u"], "additionalProperties": False}

# (server, payload): refused by both servers with one status and message, in
# the reference's order of checks.
GUIDED_REFUSALS = [
    ("armed", {"guided_regex": "a+", "response_format": {"type": "json_object"}}),
    ("armed", {"guided_regex": "a+", "guided_json": {"enum": ["x"]}}),
    ("armed", {"guided_regex": "([unclosed"}),
    ("armed", {"guided_regex": 5}),
    ("armed", {"guided_json": 5}),
    ("armed", {"guided_json": "{not json"}),
    ("armed", {"guided_json": {"type": "integer", "minimum": 0}}),
    ("armed", {"response_format": {"type": "json_schema", "json_schema": {"name": "x"}}}),
    ("armed", {"guided_regex": "[0-9]+", "logprobs": 5}),
    ("armed", {"guided_regex": "[0-9]+", "logprobs": 5, "stream": True}),
    ("armed", {"guided_regex": "[0-9]+", "n": 2, "stream": True}),
    ("small", {"guided_regex": "[0-9]+", "n": 1, "best_of": 2}),
    ("small", {"response_format": {"type": "json_object"}}),
]


@pytest.mark.parametrize("kind,payload", GUIDED_REFUSALS)
def test_guided_refusals_match_the_jax_server(guided_servers, kind, payload):
    """Every guided refusal: two specs, a bad regex or schema, logprobs
    beyond ``--logprobs-k`` (plain and streamed), ``best_of`` ranking
    without logprobs, and the 503 of a table out of rows (with the restart
    hint)."""
    (ps, port), (js, ref) = (
        _post_h(guided_servers[(side, kind)] + "/v1/completions", {"prompt": "hi", **payload})
        for side in ("port", "jax"))
    assert ps == js and ps in (400, 503), (port, ref)
    assert port["error"]["message"] == ref["error"]["message"]
    if kind == "small" and "json_object" in json.dumps(payload):
        assert ps == 503 and "fsm_capacity exhausted" in port["error"]["message"]


def test_guided_stream_answers_503_when_the_table_is_full(guided_servers):
    """The eager stream submit's 503 (no restart hint): the status and text
    the reference's streaming path sets (``status = 503 if "fsm_capacity" in
    str(e)``), the message being the JAX engine's own refusal. The JAX server
    itself answers 500 here: its handler binds ``QueueFullError`` by an
    import later in the same function, so the ``except QueueFullError``
    before the 503 raises ``UnboundLocalError``."""
    from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine

    jcfg = JaxModelConfig(**TINY)
    jeng = JaxEngine(jllama.init_params(jax.random.key(0), jcfg), jcfg, JaxByteTokenizer(),
                     cache_mode="paged", page_size=16, fsm_capacity=16)
    with pytest.raises(ValueError) as ref:
        jeng.register_grammar(JG.compile_json(JaxByteTokenizer()))
    payload = {"prompt": "hi", "response_format": {"type": "json_object"}, "stream": True}
    status, body = _post_h(guided_servers[("port", "small")] + "/v1/completions", payload)
    assert status == 503 and body["error"]["message"] == str(ref.value)
    status, body = _post_h(guided_servers[("jax", "small")] + "/v1/completions", payload)
    assert status == 500 and "QueueFullError" in body["error"]["message"]


# (route, payload): guided completions whose greedy text the JAX server gives
GUIDED_SERVED = [
    ("/v1/completions", {"prompt": "pin:", "guided_regex": "[0-9]{4}"}),
    ("/v1/completions", {"prompt": "color:", "guided_json": {"enum": ["on", "off"]}}),
    ("/v1/completions", {"prompt": "rec:", "guided_json": json.dumps(RECORD)}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "emit json"}],
                              "response_format": {"type": "json_object"}}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "extract"}],
                              "response_format": {"type": "json_schema", "json_schema": {
                                  "name": "rec", "schema": RECORD}}}),
    ("/v1/completions", {"prompt": "year:", "guided_regex": "[0-9]{4}", "logprobs": 2}),
    ("/v1/completions", {"prompt": "pick", "guided_regex": "(yes|no)", "n": 2, "best_of": 3}),
    ("/v1/completions", {"prompt": "id:", "guided_regex": "[a-f]{6}", "slo_class": "batch",
                         "deadline_s": 60}),
]


@pytest.mark.parametrize("route,payload", GUIDED_SERVED)
def test_guided_completions_match_the_jax_server(guided_servers, route, payload):
    (ps, port), (js, ref) = (_post_h(guided_servers[(side, "armed")] + route, payload)
                             for side in ("port", "jax"))
    assert ps == js == 200, (port, ref)
    key = "message" if "chat" in route else "text"
    got = [(c.get(key), c["finish_reason"]) for c in port["choices"]]
    assert got == [(c.get(key), c["finish_reason"]) for c in ref["choices"]]
    assert port["usage"] == ref["usage"]
    if payload.get("logprobs"):
        a, b = port["choices"][0]["logprobs"], ref["choices"][0]["logprobs"]
        assert a["tokens"] == b["tokens"] and a["text_offset"] == b["text_offset"]
        assert a["token_logprobs"] == pytest.approx(b["token_logprobs"], abs=1e-5)
    if "guided_regex" in payload:
        import re

        for c in port["choices"]:
            assert re.fullmatch(payload["guided_regex"], c["text"]), c


def _sse_concat(url, payload):
    import http.client

    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", "/v1/completions", json.dumps({**payload, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        text = ""
        for line in resp.read().decode().splitlines():
            if line.startswith("data: ") and line != "data: [DONE]":
                text += json.loads(line[6:])["choices"][0]["text"]
        return text
    finally:
        conn.close()


def test_guided_stream_concatenates_to_the_unstreamed_text(guided_servers):
    """A guided SSE stream's chunks concatenate to the unstreamed completion,
    the JAX server's stream to the same text."""
    import re

    payload = {"prompt": "id:", "guided_regex": "[a-f]{6}", "max_tokens": 10}
    status, whole = _post_h(guided_servers[("port", "armed")] + "/v1/completions", payload)
    assert status == 200
    text = _sse_concat(guided_servers[("port", "armed")], payload)
    assert text == whole["choices"][0]["text"] == _sse_concat(
        guided_servers[("jax", "armed")], payload)
    assert re.fullmatch(r"[a-f]{6}", text)


def test_guided_stats_block_matches_the_jax_server(guided_servers):
    """``/v1/stats`` carries the engine's ``guided`` block: after the same
    grammars, the same rows used and grammars registered as the JAX
    server's (the small table untouched by the 503s)."""
    for kind in ("armed", "small"):
        payload = {"prompt": "q", "guided_regex": "[ab]+", "max_tokens": 4}
        for side in ("port", "jax"):
            assert _post_h(guided_servers[(side, kind)] + "/v1/completions", payload)[0] == 200
        port, ref = (_get(guided_servers[(side, kind)] + "/v1/stats")[1]["guided"]
                     for side in ("port", "jax"))
        assert port == ref and port["fsm_capacity"] == (4096 if kind == "armed" else 16)


def test_cli_fsm_capacity(capsys):
    """``--fsm-capacity`` arms the continuous engine; on the lock-step engine
    it is the reference's parser error."""
    base = ["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
            "--override", "num_layers=1", "--override", "vocab_size=300",
            "--override", "max_seq_len=128"]
    srv = tserver.create_server(base + ["--engine", "continuous", "--cache-mode", "paged",
                                        "--page-size", "16", "--fsm-capacity", "64"])
    try:
        te = srv.RequestHandlerClass.threaded_engine
        assert te.guided and te.stats()["guided"] == {
            "fsm_capacity": 64, "fsm_rows_used": 2, "grammars_registered": 0}
    finally:
        srv.server_close()
        srv.engine.close()
    with pytest.raises(SystemExit) as exc:
        tserver.create_server(base + ["--fsm-capacity", "64"])
    assert exc.value.code == 2 and ("--fsm-capacity (guided decoding) requires --engine "
                                    "continuous") in capsys.readouterr().err
