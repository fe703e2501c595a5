"""Port parity: speculative ticks in the continuous engine over the paged KV
cache, mirroring ``tests/test_spec_continuous.py``.

The port's engine with ``speculative=True`` must give the JAX engine's greedy
tokens (``speculative=True, cache_mode="paged"``) and the port's plain
engine's, in float32, over float and int8 pools; the verify attention is
K3's multi-query form (on the CPU its plain version). Sampled ticks cannot
match the JAX package draw for draw (PyTorch's generators are not JAX's
threefry): they are held by per-seed reproducibility inside the port and by a
distribution test of ``spec_sample_tokens``.
"""

import dataclasses
import functools
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.speculative import spec_sample_tokens  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")
PROMPTS = ["abcabcabcabcabcabc", "the cat sat on the mat the cat sat", "x",
           "hello hello hello hello"]
PAGED = dict(cache_mode="paged", page_size=16)


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _cfgs(kv8: bool):
    jcfg, _, cfg, _ = _pair()
    if kv8:
        return (dataclasses.replace(jcfg, kv_cache_dtype="int8"),
                dataclasses.replace(cfg, kv_cache_dtype="int8"))
    return jcfg, cfg


def _spec_engine(kv8: bool = False, **kw):
    """The port's engine with every tick speculative (threshold 0), as the
    reference's exactness tests build it."""
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("speculative", True)
    kw.setdefault("spec_threshold", 0.0)
    kw.setdefault("spec_rounds", 2)
    _, cfg = _cfgs(kv8)
    return ContinuousEngine(_pair()[3], cfg, ByteTokenizer(), device="cpu", **PAGED, **kw)


def _plain_engine(kv8: bool = False, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_chunk", 4)
    _, cfg = _cfgs(kv8)
    return ContinuousEngine(_pair()[3], cfg, ByteTokenizer(), device="cpu", **PAGED, **kw)


@functools.lru_cache(maxsize=None)
def _jax_spec(kv8: bool, max_new: int, n_slots: int = 4, extra: tuple = ()) -> tuple:
    """The JAX engine's greedy texts, ``speculative=True``, paged, every tick
    speculative."""
    jcfg, _ = _cfgs(kv8)
    eng = JaxEngine(_pair()[1], jcfg, JaxByteTokenizer(), n_slots=n_slots, decode_chunk=4,
                    speculative=True, spec_threshold=0.0, spec_rounds=2, **PAGED)
    return tuple(eng.generate(PROMPTS + list(extra), max_new_tokens=max_new,
                              temperature=0.0))


@pytest.mark.parametrize("kv8", [False, True], ids=["float", "int8"])
def test_spec_paged_matches_jax_and_plain_greedy(kv8):
    """f32: the port's speculative engine gives the JAX speculative engine's
    greedy text, over float and over int8 pools, and the port's plain
    engine's (int8: quantized at each tick's flush, which the speculative
    and plain schedules place differently, so only float holds them
    equal)."""
    eng = _spec_engine(kv8)
    out = eng.generate(PROMPTS, max_new_tokens=25 if kv8 else 37, temperature=0.0)
    st = eng.stats()["speculative"]
    assert st["spec_ticks"] == st["ticks"] > 0  # every tick speculated
    assert st["verify_rounds"] == 2 * st["spec_ticks"]
    assert tuple(out) == _jax_spec(kv8, 25 if kv8 else 37)
    if not kv8:
        plain = _plain_engine().generate(PROMPTS, max_new_tokens=37, temperature=0.0)
        assert out == plain
    assert all(len(o) > 0 for o in out)


def test_spec_paged_int8_deterministic():
    out1 = _spec_engine(True).generate(PROMPTS, max_new_tokens=25, temperature=0.0)
    out2 = _spec_engine(True).generate(PROMPTS, max_new_tokens=25, temperature=0.0)
    assert out1 == out2


def test_spec_verify_runs_through_the_wrapper_with_4d_q(monkeypatch):
    """Every verify round of every layer calls ``paged_attention`` once with
    a (B, k+1, H, D) q and the tail; plain ticks call it with 3-D q."""
    from ditl_tpu_torch.ops import paged_attention as tpa

    shapes = []
    wrapper = tpa.paged_attention

    def counting(q, *args, **kw):
        shapes.append(tuple(q.shape))
        assert kw.get("tail_k") is not None
        return wrapper(q, *args, **kw)

    monkeypatch.setattr(tpa, "paged_attention", counting)
    eng = _spec_engine(spec_k=5, spec_rounds=3)
    eng.generate(PROMPTS[:2], max_new_tokens=12, temperature=0.0)
    st = eng.stats()["speculative"]
    assert len(shapes) == TINY["num_layers"] * st["verify_rounds"] > 0
    assert set(shapes) == {(4, 6, TINY["num_heads"], TINY["head_dim"])}


def test_spec_slot_reuse_more_requests_than_slots():
    extra = ("abab", "qrsqrsqrs")
    out = _spec_engine(n_slots=2).generate(PROMPTS + list(extra), max_new_tokens=19,
                                           temperature=0.0)
    plain = _plain_engine(n_slots=2).generate(PROMPTS + list(extra), max_new_tokens=19,
                                              temperature=0.0)
    assert out == plain
    assert tuple(out) == _jax_spec(False, 19, 2, extra)


def test_spec_auto_disables_on_low_acceptance():
    """Random weights give about one token per forward: with a 2.5
    threshold the engine probes, measures, and falls back to plain ticks;
    the tokens stay the plain engine's."""
    eng = _spec_engine(spec_threshold=2.5, spec_probe_every=1000, spec_rounds=None)
    out = eng.generate(PROMPTS, max_new_tokens=24, temperature=0.0)
    st = eng.stats()["speculative"]
    assert st["spec_ticks"] >= 1  # the probe
    assert st["spec_ticks"] < st["ticks"]  # ...then plain ticks
    assert st["acceptance_ema"] is not None and st["acceptance_ema"] < 2.5
    assert out == _plain_engine().generate(PROMPTS, max_new_tokens=24, temperature=0.0)


def test_spec_plain_ticks_keep_the_history_fresh():
    """Plain ticks extend each slot's token history while speculation is
    armed: after a plain tick, ``hist[pos]`` is the pending token and the
    columns before it the prompt and the tokens emitted so far."""
    eng = _spec_engine(spec_threshold=1e9, spec_probe_every=1000)
    tok = eng.tokenizer
    prompt = [tok.bos_id] + tok.encode(PROMPTS[1])
    eng.submit(prompt, max_new_tokens=30, temperature=0.0)
    eng.step()  # admission, then the probe (nothing measured yet): speculative
    eng.step()  # measured acceptance < threshold: a plain tick
    st = eng.stats()["speculative"]
    assert (st["spec_ticks"], st["ticks"]) == (1, 2)
    req = eng._slots[0]
    pos = int(eng.pos[0])
    assert pos == len(prompt) + len(req.tokens)
    hist = eng.hist[0].tolist()
    assert hist[:pos] == prompt + req.tokens
    assert hist[pos] == int(eng.cur[0])


def test_spec_acceptance_accounted_per_request():
    eng = _spec_engine()
    tok = eng.tokenizer
    rids = [eng.submit([tok.bos_id] + tok.encode(p), max_new_tokens=16, temperature=0.0)
            for p in PROMPTS]
    eng.step()
    live = [r for r in eng._slots if r is not None]
    assert live and all(r.spec_forwards == 2 and 2 <= r.spec_tokens <= 18 for r in live)
    eng.run()
    st = eng.stats()["speculative"]
    assert st["acceptance_ema"] is not None and st["acceptance_ema"] >= 1.0
    assert len(rids) == 4


def test_spec_threshold_self_calibrates():
    """No configured threshold: 'prior' (2.5) until both tick kinds are timed
    twice (each kind's first timed tick left out), then the measured ratio
    of a verify round's cost to a plain step's; a configured value wins."""
    eng = _spec_engine(n_slots=2, spec_threshold=None, spec_probe_every=1000,
                       spec_rounds=None)
    assert eng.stats()["speculative"]["threshold_source"] == "prior"
    assert eng.spec_threshold == 2.5
    for _ in range(3):
        eng.generate(PROMPTS, max_new_tokens=24, temperature=0.0)
    st = eng.stats()["speculative"]
    assert st["plain_step_ms"] is not None
    if st["spec_round_ms"] is not None:  # two or more spec ticks ran
        assert st["threshold_source"] == "measured"
        assert eng.spec_threshold == pytest.approx(st["spec_round_ms"] / st["plain_step_ms"])
        assert eng.spec_threshold > 0
    fixed = _spec_engine(n_slots=2, spec_threshold=3.3)
    assert fixed.spec_threshold == 3.3
    assert fixed.stats()["speculative"]["threshold_source"] == "configured"


@pytest.mark.parametrize("kw,what", [
    ({"spec_k": 0}, "spec_k"), ({"spec_min_ngram": 5}, "spec_min_ngram"),
    ({"spec_rounds": -1}, "spec_rounds"),
])
def test_spec_arguments_are_validated(kw, what):
    with pytest.raises(ValueError, match=what):
        _spec_engine(**kw)


def test_spec_sample_tokens_matches_target_distribution():
    """Rejection sampling with point-mass drafts: the token emitted at each
    position is distributed as ancestral sampling from the shaped target
    (chi-square over 20000 rows, each with its own generator), and a greedy
    row takes the exact-match rule."""
    from scipy import stats

    v, k, n = 8, 2, 20000
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.normal(size=(1, k + 1, v)) * 1.5).astype(np.float32))
    draft = torch.tensor([[3, 5]])
    gens = [torch.Generator().manual_seed(i) for i in range(n)]
    n_acc, nxt = spec_sample_tokens(logits.expand(n, -1, -1), draft.expand(n, -1), gens,
                                    torch.full((n,), 0.9), torch.ones(n))
    n_acc, nxt = n_acc.numpy(), nxt.numpy()
    probs = torch.softmax(logits[0] / 0.9, -1).numpy().astype(np.float64)
    tok1 = np.where(n_acc >= 1, 3, nxt)
    counts1 = np.bincount(tok1, minlength=v)
    assert stats.chisquare(counts1, probs[0] / probs[0].sum() * n).pvalue > 1e-3
    m = n_acc >= 1
    tok2 = np.where(n_acc[m] == 2, 5, nxt[m])
    counts2 = np.bincount(tok2, minlength=v)
    assert stats.chisquare(counts2, probs[1] / probs[1].sum() * m.sum()).pvalue > 1e-3
    # the greedy limit: the exact-match rule
    n0, nx0 = spec_sample_tokens(logits, draft, [None], torch.zeros(1), torch.ones(1))
    cand = logits[0].argmax(-1).tolist()
    want = 0 if cand[0] != 3 else 1 + int(cand[1] == 5)
    assert int(n0[0]) == want and int(nx0[0]) == cand[want]


def test_spec_sampled_ticks_reproducible_and_mixed_greedy_exact():
    """Sampled requests ride speculative ticks: the same seeds give the same
    outputs, and a greedy request sharing ticks with a sampled one decodes
    the plain greedy engine's tokens."""
    o1 = _spec_engine(n_slots=2).generate(PROMPTS[:2], max_new_tokens=20, temperature=0.8,
                                          seed=7)
    eng = _spec_engine(n_slots=2)
    o2 = eng.generate(PROMPTS[:2], max_new_tokens=20, temperature=0.8, seed=7)
    assert eng.stats()["speculative"]["spec_ticks"] > 0
    assert o1 == o2
    ref = _plain_engine(n_slots=2).generate([PROMPTS[0]], max_new_tokens=22,
                                            temperature=0.0)[0]
    eng = _spec_engine(n_slots=2)
    tok = eng.tokenizer
    r_g = eng.submit([tok.bos_id] + tok.encode(PROMPTS[0]), max_new_tokens=22,
                     temperature=0.0)
    eng.submit([tok.bos_id] + tok.encode(PROMPTS[1]), max_new_tokens=22, temperature=0.9,
               seed=3)
    out = eng.run()
    assert eng.stats()["speculative"]["spec_ticks"] > 0
    assert tok.decode(out[r_g]) == ref


def test_spec_smoke_fast():
    eng = _spec_engine(n_slots=2, spec_rounds=1)
    out = eng.generate([PROMPTS[0]], max_new_tokens=10, temperature=0.0)
    st = eng.stats()["speculative"]
    assert st["spec_ticks"] == st["ticks"] > 0
    assert st["acceptance_ema"] is not None and st["acceptance_ema"] >= 1.0
    assert len(out[0]) > 0
    assert _spec_engine(n_slots=2, spec_rounds=1).generate(
        [PROMPTS[0]], max_new_tokens=10, temperature=0.0) == out


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_server_continuous_speculative(mode):
    """``--engine continuous --speculative on|auto``: the engine is armed
    (threshold 0 for ``on``, measured for ``auto``), serves the plain
    engine's greedy text, and /v1/stats carries the speculative block."""
    overrides = [x for k, v in TINY.items() for x in ("--override", f"{k}={v}")]
    srv = tserver.create_server(["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                                 *overrides, "--engine", "continuous", "--cache-mode",
                                 "paged", "--page-size", "16", "--slots", "2",
                                 "--speculative", mode])
    engine = srv.engine._engine
    assert engine.speculative
    assert engine.stats()["speculative"]["threshold_source"] == (
        "configured" if mode == "on" else "prior")
    gen = srv.RequestHandlerClass.generator  # the server's own weights
    want = ContinuousEngine(gen.params, gen.cfg, ByteTokenizer(), device="cpu", n_slots=2,
                            **PAGED).generate([PROMPTS[3]], max_new_tokens=12,
                                              temperature=0.0)[0]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        req = urllib.request.Request(
            url + "/v1/completions", method="POST",
            data=json.dumps({"prompt": PROMPTS[3], "max_tokens": 12,
                             "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["choices"][0]["text"] == want
        with urllib.request.urlopen(url + "/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["speculative"]["spec_ticks"] >= 1
        assert stats["speculative"]["k"] == 8
    finally:
        srv.close(drain=True)
        thread.join(timeout=10)
    assert not thread.is_alive()
