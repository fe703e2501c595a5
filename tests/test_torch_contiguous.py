"""Port parity: the port's continuous engine over the contiguous KV cache
(``cache_mode="contiguous"``, the default) against the JAX package's
``ContinuousEngine`` with its default cache mode, on the same weights.

The tiny f32 config is ``tests/test_continuous.py``'s (context 128), so
argmax ties cannot flip on rounding: greedy tokens must be identical on
plain ticks with more requests than slots, mid-flight admission, a
greedy/sampled mix (the greedy rows), chunked prefill (chunks of 36 tokens,
no power of two, the last one near the cache end) under a token budget, a
guided request beside unconstrained ones, and the successor of a cancelled
and of an expired request. Logprobs agree within ``LP_TOL``; the
scheduler's accounting (``cache_mode``, ``prefix_cache``,
``max_tick_prefill_tokens``) and the constructor's and ``validate_request``'s
error messages are the reference's. The JAX engines run once, by a module
fixture; ``tests/test_torch_contiguous_spec.py`` holds the speculative and
int8 ticks, ``tests/test_torch_prefix.py`` the registered prefixes.
"""

import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import grammar as JG  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import grammar as G  # noqa: E402
from ditl_tpu_torch.infer.continuous import BadRequestError, ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")
LP_TOL = 1e-5  # logprobs against the JAX engine's (f32 on both sides)
MAX_NEW = 12
# Engine kinds, the same settings on both packages (contiguous by default).
ENGINES = {
    "plain": dict(n_slots=2, decode_chunk=4),
    # 36-token chunks: 115-token prompts take chunks at 0, 36, 72 and a tail
    # at 108, where 108 + 36 passes the 128-slot row and the bucket shrinks
    "chunked": dict(n_slots=2, decode_chunk=4, prefill_chunk=36, token_budget=48),
    "extras": dict(n_slots=2, decode_chunk=4, logprobs_k=3, fsm_capacity=256),
}
PROMPTS = ["hello world", "abc", "the quick brown fox", "x", "count 1 2 3 4"]
LONG = ["the quick brown fox jumps over the lazy dog, " * 2 + "and then some more text",
        "short", "q" * 114, "r" * 60]


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _make(models, kind: str, port: bool):
    jcfg, jparams, cfg, tparams = models
    if port:
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu",
                                gen=GenerateConfig(max_new_tokens=MAX_NEW), **ENGINES[kind])
    return JaxEngine(jparams, jcfg, JaxByteTokenizer(),
                     gen=JaxGenerateConfig(max_new_tokens=MAX_NEW), **ENGINES[kind])


def _ids(eng, text: str) -> list[int]:
    tok = eng.tokenizer
    return [tok.bos_id] + tok.encode(text)


def _drain(eng, done: dict) -> dict:
    steps = 0
    while eng.pending:
        eng.step()
        steps += 1
        assert steps < 2000
        done.update({r.req_id: r for r in eng.take_finished()})
    return done


def _batch(eng, prompts, **kw) -> list:
    rids = [eng.submit(_ids(eng, p), **kw) for p in prompts]
    done = _drain(eng, {})
    return [done[r] for r in rids]


def _mid_flight(eng) -> list:
    """A request submitted while another decodes."""
    first = eng.submit(_ids(eng, "first request"))
    eng.step()
    second = eng.submit(_ids(eng, "second"))
    done = _drain(eng, {})
    return [done[first], done[second]]


def _mix(eng) -> list:
    """Greedy and sampled rows sharing ticks; the sampled ones seeded."""
    rids = [eng.submit(_ids(eng, p), temperature=t, top_p=tp, seed=s)
            for p, t, tp, s in [("greedy one", 0.0, 1.0, 0), ("sampled", 0.9, 0.9, 5),
                                ("greedy two", 0.0, 1.0, 0), ("sampled b", 1.2, 1.0, 9)]]
    done = _drain(eng, {})
    return [done[r] for r in rids]


def _cancel_and_expire(eng) -> list:
    """Two slots: a is cancelled mid-decode and b passes its deadline in its
    slot; c and d take the freed slots. Returns c, d and b (expired)."""
    a = eng.submit(_ids(eng, "to be cancelled"))
    b = eng.submit(_ids(eng, "to expire"), deadline_s=60.0)
    eng.step()
    assert eng.cancel(a)
    c = eng.submit(_ids(eng, "after the cancel"))
    next(r for r in eng._slots if r is not None and r.req_id == b).deadline = (
        time.monotonic() - 1.0)
    d = eng.submit(_ids(eng, "after the expiry"))
    done = _drain(eng, {})
    return [done[c], done[d], done[b]]


def _guided(eng) -> list:
    tok = eng.tokenizer
    mod = G if isinstance(eng, ContinuousEngine) else JG
    phone = mod.compile_regex(r"[0-9]{3}-[0-9]{4}", tok)
    rids = [eng.submit(_ids(eng, "call me at"), grammar=phone),
            eng.submit(_ids(eng, "tell me"))]
    done = _drain(eng, {})
    return [done[r] for r in rids]


SCENARIOS = {
    "plain": ("plain", lambda e: _batch(e, PROMPTS)),
    "mid_flight": ("plain", _mid_flight),
    "mix": ("plain", _mix),
    "chunked": ("chunked", lambda e: _batch(e, LONG, max_new_tokens=10)),
    "logprobs": ("extras", lambda e: _batch(e, PROMPTS[:3], logprobs=3)),
    "guided": ("extras", _guided),
    "cancel_expire": ("extras", _cancel_and_expire),
}


@pytest.fixture(scope="module")
def runs(models):
    """Every scenario on both packages, each engine kind built once per
    package: {scenario: (JAX requests, port requests)}, and the stats of
    the "chunked" engines after their scenario."""
    out, engines = {}, {}
    for name, (kind, scenario) in SCENARIOS.items():
        pair = []
        for port in (False, True):
            if (kind, port) not in engines:
                engines[kind, port] = _make(models, kind, port)
            pair.append(scenario(engines[kind, port]))
        out[name] = tuple(pair)
        if kind == "chunked":
            out["chunked_stats"] = tuple(engines[kind, p].stats() for p in (False, True))
    return out


@pytest.mark.parametrize("scenario", ["plain", "mid_flight", "chunked", "guided",
                                      "cancel_expire"])
def test_greedy_tokens_match_jax(runs, scenario):
    """Identical greedy tokens on every tick kind of this file; a cancelled
    or expired request's successors are unchanged."""
    jreqs, treqs = runs[scenario]
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(r.tokens for r in treqs[:2])


def test_greedy_rows_of_a_mix_match_jax_and_sampled_rows_repeat(runs, models):
    """The greedy rows of a greedy/sampled mix equal the reference's; the
    sampled rows repeat per seed in the port (PyTorch's draws are not
    JAX's)."""
    jreqs, treqs = runs["mix"]
    for i in (0, 2):
        assert treqs[i].tokens == jreqs[i].tokens
    again = _mix(_make(models, "plain", True))
    assert [r.tokens for r in again] == [r.tokens for r in treqs]


def test_logprobs_match_jax(runs):
    jreqs, treqs = runs["logprobs"]
    for t, j in zip(treqs, jreqs):
        assert t.tokens == j.tokens and len(t.lp_token) == len(t.tokens)
        assert t.lp_top_ids == j.lp_top_ids
        np.testing.assert_allclose(t.lp_token, j.lp_token, rtol=0, atol=LP_TOL)
        np.testing.assert_allclose(t.lp_top, j.lp_top, rtol=0, atol=LP_TOL)


def test_guided_and_expired_requests(runs):
    """The guided row fullmatches its grammar; the expired request ends
    with the tokens it had, as the reference's."""
    text = ByteTokenizer().decode(runs["guided"][1][0].tokens)
    assert len(text) == 8 and text[3] == "-" and text.replace("-", "").isdigit()
    jexp, texp = runs["cancel_expire"][0][2], runs["cancel_expire"][1][2]
    assert texp.expired and jexp.expired and texp.tokens == jexp.tokens


def test_chunked_scheduler_accounting_matches_jax(runs):
    """The same trace gives the reference's ``cache_mode``, prefix-cache
    accounting and largest per-tick prefill spend; no pool fields."""
    jst, tst = runs["chunked_stats"]
    for key in ("cache_mode", "prefix_cache", "max_tick_prefill_tokens", "token_budget",
                "slots_busy", "queue_depth", "max_context"):
        assert tst[key] == jst[key], key
    assert tst["cache_mode"] == "contiguous" and tst["prefix_cache"]["evictions"] == 0
    assert "pages_total" not in tst and "page_size" not in tst
    # chunks and decode steps only: no cold prefill on a chunked admission
    assert tst["prefills_cold"] == 1 and tst["prefills_prefix_hit"] == 4 + 4 + 2


def test_chunk_near_the_cache_end_takes_the_smaller_bucket(models):
    """A 115-token prompt chunked by 36: the tail chunk at 108 takes a
    16-slot window (108 + 36 would pass the 128-slot row), never a shifted
    one."""
    eng = _make(models, "chunked", True)
    calls = []
    orig = eng._suffix_prefill

    def spy(prompt, slot, d, s, s_bucket):
        calls.append((d, s, s_bucket))
        return orig(prompt, slot, d, s, s_bucket)

    eng._suffix_prefill = spy
    eng.submit(_ids(eng, "q" * 114), max_new_tokens=10)
    _drain(eng, {})
    assert calls == [(0, 36, 36), (36, 36, 36), (72, 36, 36), (108, 7, 16)]


@pytest.mark.parametrize("kw", [{"admission": "optimistic"}, {"host_tier_mb": 64}])
def test_page_only_options_refused_with_the_references_messages(models, kw):
    jcfg, jparams, cfg, tparams = models
    msgs = []
    for make in (lambda: JaxEngine(jparams, jcfg, JaxByteTokenizer(), **kw),
                 lambda: ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **kw)):
        with pytest.raises(ValueError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "cache_mode='paged'" in msgs[1]


def test_validation_messages_match_jax(models):
    """``validate_request`` checks only the context cap on the contiguous
    cache (no pool), with the reference's message; an unknown cache mode
    is refused alike."""
    jcfg, jparams, cfg, tparams = models
    engines = [JaxEngine(jparams, jcfg, JaxByteTokenizer()),
               ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu")]
    msgs = []
    for eng in engines:
        eng.validate_request([1] * 100, 28)  # exactly the cap
        with pytest.raises(ValueError) as e:
            eng.validate_request([1] * 100, 29)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and isinstance(e.value, BadRequestError)
    msgs = []
    for make in (lambda: JaxEngine(jparams, jcfg, JaxByteTokenizer(), cache_mode="ring"),
                 lambda: ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu",
                                          cache_mode="ring")):
        with pytest.raises(ValueError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("int8", [False, True])
def test_one_token_row_write_equals_the_gather_form(int8):
    """The decode step's per-row write (one token a row, an indexed write)
    gives the bits of the reference's gather-and-select form, slots past
    either end of the row dropped, float and int8 caches (values and
    scales) alike."""
    from ditl_tpu_torch.infer.cache import _quantize, _scatter_rows, write_kv

    rng = np.random.default_rng(3)
    b, s, k, d = 4, 10, 2, 8
    if int8:
        cache = {"k": rng.integers(-5, 5, (b, s, k, d)).astype(np.int8),
                 "v": rng.integers(-5, 5, (b, s, k, d)).astype(np.int8),
                 "k_scale": rng.random((b, s, k)).astype(np.float32),
                 "v_scale": rng.random((b, s, k)).astype(np.float32)}
    else:
        cache = {n: rng.standard_normal((b, s, k, d)).astype(np.float32) for n in ("k", "v")}
    got = {n: torch.from_numpy(x.copy()) for n, x in cache.items()}
    want = {n: torch.from_numpy(x.copy()) for n, x in cache.items()}
    kv = {n: torch.from_numpy(rng.standard_normal((b, 1, k, d)).astype(np.float32))
          for n in ("k", "v")}
    idx = torch.tensor([0, 9, 10, -1], dtype=torch.int32)
    write_kv(got, kv["k"], kv["v"], idx)
    chunks = dict(kv)
    if int8:
        (chunks["k"], chunks["k_scale"]), (chunks["v"], chunks["v_scale"]) = (
            _quantize(kv["k"]), _quantize(kv["v"]))
    for name, c in want.items():
        c.copy_(_scatter_rows(c, chunks[name], idx))
        assert torch.equal(got[name], c), name
