"""Port parity: prompt-lookup speculative decoding (``infer/speculative.py``)
against the JAX package's, mirroring ``tests/test_speculative.py``.

The contract is the reference's: greedy speculative output is the lock-step
greedy output, so the port's ``SpeculativeGenerator`` must give the JAX
``SpeculativeGenerator``'s tokens and the port's lock-step ``Generator``'s, in
float32 (the reference's tiny config, its weights converted). Drafting is
held to the reference's host and device lookups on the same histories.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import speculative as jspec  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.infer.speculative import (  # noqa: E402
    AutoSpeculativeGenerator,
    SpeculativeGenerator,
    device_lookup_draft,
    lookup_draft,
)
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _spec(pair, **kw):
    _, _, cfg, tparams = pair
    return SpeculativeGenerator(tparams, cfg, ByteTokenizer(), device="cpu", **kw)


def _plain(pair, prompts, max_new):
    _, _, cfg, tparams = pair
    return Generator(tparams, cfg, ByteTokenizer(), device="cpu").generate_tokens(
        prompts, GenerateConfig(max_new_tokens=max_new))


# -- drafting -------------------------------------------------------------------


@pytest.mark.parametrize("context,k,ngram,min_ngram,want", [
    ([5, 6, 7, 8, 9, 5, 6], 3, 2, None, [7, 8, 9]),  # trailing bigram at 0
    ([1, 2, 3, 1, 2, 4, 1, 2], 1, 2, None, [4]),  # the most recent match
    ([1, 2, 3], 4, 2, None, [0, 0, 0, 0]),  # no match: padding
    ([7], 2, 2, None, [0, 0]),
    ([1, 2, 9, 1, 2], 3, 2, None, [9, 1, 2]),  # a truncated follow
    ([5, 9, 1, 2, 3, 4, 5], 2, 3, 1, [9, 1]),  # backoff to the 1-gram
    ([5, 9, 1, 2, 3, 4, 5], 2, 3, None, [0, 0]),  # without backoff: nothing
    ([1, 2, 7, 8, 1, 2], 1, 2, 1, [7]),  # the longer match wins
])
def test_lookup_draft_matches_the_reference(context, k, ngram, min_ngram, want):
    assert lookup_draft(context, k, ngram, min_ngram) == want
    assert jspec.lookup_draft(context, k, ngram, min_ngram) == want


@pytest.mark.parametrize("vocab,k,ngram,min_ngram", [
    (7, 5, 2, None),  # random histories over a small vocabulary: many matches
    (6, 4, 3, 1),  # repetitive, with backoff
    (3, 8, 3, 2),
])
def test_device_lookup_draft_matches_host_and_jax(vocab, k, ngram, min_ngram):
    rng = np.random.default_rng(vocab * 10 + k)
    b, t = 8, 64
    tokens = rng.integers(1, vocab, size=(b, t)).astype(np.int64)
    tokens[0, :40] = np.tile([1, 2, 3, 4, 5], 8)  # a repeated span
    ctx_len = rng.integers(1, t, size=(b,)).astype(np.int64)
    ctx_len[0] = 40
    dev = device_lookup_draft(torch.from_numpy(tokens), torch.from_numpy(ctx_len), k=k,
                              ngram=ngram, min_ngram=min_ngram).numpy()
    ref = np.asarray(jspec.device_lookup_draft(
        jnp.asarray(tokens.astype(np.int32)), jnp.asarray(ctx_len.astype(np.int32)), k=k,
        ngram=ngram, min_ngram=min_ngram))
    np.testing.assert_array_equal(dev, ref)
    for i in range(b):
        host = lookup_draft(tokens[i, : ctx_len[i]].tolist(), k, ngram, min_ngram)
        assert dev[i].tolist() == host, f"row {i} (ctx_len {ctx_len[i]})"


# -- exactness against the JAX package and the lock-step Generator -------------


@pytest.mark.parametrize("k", [1, 4, 8])
def test_matches_jax_and_lockstep_greedy(pair, k):
    jcfg, params, _, _ = pair
    tok = ByteTokenizer()
    prompts = [[tok.bos_id] + tok.encode("abcabcabcabc"),
               [tok.bos_id] + tok.encode("the quick brown fox"),
               [tok.bos_id] + tok.encode("xy")]
    ref = jspec.SpeculativeGenerator(params, jcfg, JaxByteTokenizer(), k=k).generate_tokens(
        prompts, max_new_tokens=24)
    spec = _spec(pair, k=k)
    assert spec.generate_tokens(prompts, max_new_tokens=24) == ref
    assert _plain(pair, prompts, 24) == ref
    assert spec.last_rounds > 0 and spec.last_acceptance >= 1.0


def test_matches_jax_on_repetitive_prompt(pair):
    """Repetitive context is where lookup accepts drafts; the tokens stay the
    reference's and the lock-step Generator's."""
    jcfg, params, _, _ = pair
    tok = ByteTokenizer()
    prompts = [[tok.bos_id] + tok.encode("jax tpu ") * 12]
    ref = jspec.SpeculativeGenerator(params, jcfg, JaxByteTokenizer(), k=6).generate_tokens(
        prompts, max_new_tokens=32)
    spec = _spec(pair, k=6)
    assert spec.generate_tokens(prompts, max_new_tokens=32) == ref
    assert _plain(pair, prompts, 32) == ref


def test_single_and_empty_prompts(pair):
    gen = _spec(pair, k=4)
    assert gen.generate_tokens([], 8) == []
    assert gen.generate_tokens([[]], 8) == _plain(pair, [[]], 8)


def test_max_new_tokens_respected(pair):
    tok = ByteTokenizer()
    out = _spec(pair, k=8).generate_tokens(
        [[tok.bos_id] + tok.encode("hello world hello world")], max_new_tokens=5)
    assert len(out[0]) <= 5


def test_seq_len_overflow_raises(pair):
    with pytest.raises(ValueError, match="max_seq_len"):
        _spec(pair, k=4).generate_tokens([list(range(10, 200))], max_new_tokens=200)


def test_invalid_arguments_raise(pair):
    for kw, what in (({"k": 0}, "k must"), ({"ngram": 0}, "ngram"),
                     ({"min_ngram": 4}, "min_ngram")):
        with pytest.raises(ValueError, match=what):
            _spec(pair, **kw)


def test_int8_kv_cache_composes(pair):
    """An int8 cache: the JAX SpeculativeGenerator's tokens, and the same
    tokens on a second call."""
    jcfg, params, cfg, tparams = pair
    tok = ByteTokenizer()
    prompt = [[tok.bos_id] + tok.encode("abc abc abc")]
    gen = SpeculativeGenerator(tparams, dataclasses.replace(cfg, kv_cache_dtype="int8"), tok,
                               k=4, device="cpu")
    out = gen.generate_tokens(prompt, 12)
    assert gen.generate_tokens(prompt, 12) == out
    ref = jspec.SpeculativeGenerator(
        params, dataclasses.replace(jcfg, kv_cache_dtype="int8"), JaxByteTokenizer(),
        k=4).generate_tokens(prompt, 12)
    assert out == ref


def test_acceptance_accounting_is_honest(pair):
    """Rounds count only rounds with a live row; a pad row (3 prompts ->
    batch 4) adds neither tokens nor rounds; the acceptance is tokens over
    rounds over real rows, as the reference reports it."""
    jcfg, params, _, _ = pair
    tok = ByteTokenizer()
    prompt = [tok.bos_id] + tok.encode("hello there")
    spec = _spec(pair, k=8)
    out = spec.generate_tokens([prompt], max_new_tokens=2)
    assert out == _plain(pair, [prompt], 2)
    assert spec.last_rounds <= 1  # the prefill gives the first token
    prompts = [prompt, prompt, [tok.bos_id] + tok.encode("xy")]
    out3 = spec.generate_tokens(prompts, max_new_tokens=16)
    assert out3 == _plain(pair, prompts, 16)
    ref = jspec.SpeculativeGenerator(params, jcfg, JaxByteTokenizer(), k=8)
    assert ref.generate_tokens(prompts, max_new_tokens=16) == out3
    assert spec.last_rounds == ref.last_rounds
    assert spec.last_acceptance == pytest.approx(ref.last_acceptance)
    total = sum(len(o) for o in out3)
    assert spec.last_acceptance == pytest.approx(total / spec.last_rounds / 3)


def test_auto_speculative_switches_on_measured_acceptance(pair):
    _, _, cfg, tparams = pair
    tok = ByteTokenizer()
    auto = AutoSpeculativeGenerator(tparams, cfg, tok, threshold=2.0, probe_every=4,
                                    ema=0.0, k=4, device="cpu")
    calls = {"spec": 0, "plain": 0}
    real_spec, real_plain = auto.spec.generate_tokens, auto.plain.generate_tokens

    def spy_spec(*a, **kw):
        calls["spec"] += 1
        return real_spec(*a, **kw)

    def spy_plain(*a, **kw):
        calls["plain"] += 1
        return real_plain(*a, **kw)

    auto.spec.generate_tokens, auto.plain.generate_tokens = spy_spec, spy_plain
    prompt = [tok.bos_id] + tok.encode("hello world")
    out1 = auto.generate_tokens([prompt], max_new_tokens=8)
    assert calls["spec"] == 1 and auto.acceptance_ema is not None
    auto.acceptance_ema = 0.5  # low: the plain path, until the probe
    for _ in range(3):
        assert auto.generate_tokens([prompt], max_new_tokens=8) == out1
    assert calls["plain"] == 3
    auto.generate_tokens([prompt], max_new_tokens=8)  # request 4 probes
    assert calls["spec"] == 2
    assert out1 == _plain(pair, [prompt], 8)
    auto.acceptance_ema = 10.0  # high: speculation stays on
    auto.generate_tokens([prompt], max_new_tokens=8)
    assert calls["spec"] == 3
    with pytest.raises(ValueError, match="probe_every"):
        AutoSpeculativeGenerator(tparams, cfg, tok, probe_every=0, device="cpu")


# -- the server's lock-step --speculative ------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(url + "/v1/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_server_lockstep_speculative_matches_plain(mode):
    """``--speculative on|auto`` on the lock-step engine: greedy requests
    ride the speculative generator and return the plain Generator's text;
    a sampled request takes the plain path; a request whose prompt and
    budget fit the plain path but not the k + 1 slack falls back; /stats
    reports the acceptance."""
    cfg = ModelConfig(**TINY)
    overrides = [x for k, v in TINY.items() for x in ("--override", f"{k}={v}")]
    srv = tserver.create_server(["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                                 "--max-tokens", "8", *overrides, "--speculative", mode])
    spec = srv.RequestHandlerClass.spec_generator
    assert isinstance(spec, AutoSpeculativeGenerator if mode == "auto" else
                      SpeculativeGenerator)
    plain = srv.RequestHandlerClass.generator
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    tok = plain.tokenizer
    inner = spec.spec if mode == "auto" else spec
    try:
        out = _post(url, {"prompt": "hello world hello", "max_tokens": 8})
        want = plain.generate_tokens([[tok.bos_id] + tok.encode("hello world hello")],
                                     GenerateConfig(max_new_tokens=8))[0]
        assert out["choices"][0]["text"] == tok.decode(want)
        assert inner.last_rounds > 0  # the speculative path ran
        rounds = inner.last_rounds
        sampled = _post(url, {"prompt": "hello world", "max_tokens": 8, "temperature": 0.8,
                              "seed": 7})
        assert sampled["usage"]["completion_tokens"] >= 1
        # prompt + budget fill the context: the spec program's slack does not fit
        prompt = tok.decode(list(range(10, 10 + 120)))
        n_prompt = len(tok.encode(prompt)) + 1
        max_tok = cfg.max_seq_len - -(-n_prompt // 128) * 128
        long = _post(url, {"prompt": prompt, "max_tokens": max_tok})
        assert long["usage"]["completion_tokens"] >= 1
        assert inner.last_rounds == rounds  # served by the plain Generator
        stats = _get(url + "/v1/stats")
        assert stats["speculative"] is True and stats["speculative_acceptance"] > 0
    finally:
        srv.close(drain=True)
        thread.join(timeout=10)
    assert not thread.is_alive()
