"""Port parity: chunked prefill and the per-tick token budget in the
continuous engine over the paged KV cache, mirroring the chunked cases of
``tests/test_continuous.py``, ``tests/test_paged.py`` and
``tests/test_spec_continuous.py`` and the budget's of
``tests/test_slo_sched.py``.

A prompt longer than ``prefill_chunk`` prefills one page-aligned chunk a
tick (the first causal over no context, the later ones over the gathered
pages of the earlier ones) while the other slots keep decoding; the tick's
prefill spend is capped by ``token_budget`` less its decode work. The
port's greedy tokens must equal the JAX engine's on the same weights, in
float32, over float and int8 pools, with prefix hits and with speculation,
and its ``max_tick_prefill_tokens`` the JAX engine's on the same trace.
Sampled tokens are held per seed inside the port, chunked and unchunked.
"""

import dataclasses
import functools

import jax
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256, dtype="float32")
PAGED = dict(cache_mode="paged", page_size=16)
PROMPTS = ["q" * 100, "r" * 37, "the quick brown fox jumps over the lazy dog " * 2, "x"]
SYSTEM = "sys: " + "p" * 60


@functools.lru_cache(maxsize=None)
def _pair(kv8: bool = False):
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    if kv8:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return jcfg, params, cfg, tparams


def _engine(kv8: bool = False, **kw):
    _, _, cfg, tparams = _pair(kv8)
    kw.setdefault("n_slots", 2)
    kw.setdefault("decode_chunk", 4)
    return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **PAGED, **kw)


def _jax_engine(kv8: bool = False, **kw):
    jcfg, params, _, _ = _pair(kv8)
    kw.setdefault("n_slots", 2)
    kw.setdefault("decode_chunk", 4)
    return JaxEngine(params, jcfg, JaxByteTokenizer(), **PAGED, **kw)


def _ids(tok, text: str) -> list[int]:
    return [tok.bos_id] + tok.encode(text)


@functools.lru_cache(maxsize=None)
def _jax_greedy(kv8: bool, prompts: tuple, max_new: int, kw: tuple = ()) -> tuple:
    eng = _jax_engine(kv8, **dict(kw))
    return tuple(eng.generate(list(prompts), max_new_tokens=max_new, temperature=0.0))


@pytest.mark.parametrize("kv8", [False, True], ids=["float", "int8"])
def test_chunked_prefill_matches_jax_and_unchunked(kv8):
    """``test_paged_chunked_prefill_matches_unchunked``: chunks of 32 over
    page 16; the JAX engine's chunked tokens, and (float pools) the
    unchunked engine's. int8 pools quantize each chunk's pages before the
    next chunk reads them, as the reference does, so there the chunked
    tokens are held to the JAX engine's chunked ones."""
    kw = (("prefill_chunk", 32),)
    eng = _engine(kv8, prefill_chunk=32)
    out = eng.generate(PROMPTS, max_new_tokens=12, temperature=0.0)
    assert tuple(out) == _jax_greedy(kv8, tuple(PROMPTS), 12, kw)
    if not kv8:
        assert out == _engine().generate(PROMPTS, max_new_tokens=12, temperature=0.0)
    assert eng.stats()["slots_prefilling"] == 0
    assert eng.allocator.n_free + eng.allocator.n_evictable == eng.n_pages - 1


def test_chunked_prefill_with_a_prefix_hit():
    """``test_chunked_prefill_with_prefix_cache``: a second prompt sharing a
    page-covering prefix matches its pages and chunks only the suffix; the
    JAX engine's tokens and the unchunked engine's."""
    prompts = [SYSTEM + " first " + "a" * 20, SYSTEM + " tail " + "q" * 70]
    eng = _engine(prefill_chunk=32, n_slots=1)
    calls = []
    orig = eng._paged_prefill_chunk

    def spy(req, slot, d, s, generator, **kw):
        calls.append((d, s))
        return orig(req, slot, d, s, generator, **kw)

    eng._paged_prefill_chunk = spy
    out = eng.generate(prompts, max_new_tokens=10, temperature=0.0)
    assert tuple(out) == _jax_greedy(False, tuple(prompts), 10,
                                     (("prefill_chunk", 32), ("n_slots", 1)))
    assert out == _engine(n_slots=1).generate(prompts, max_new_tokens=10, temperature=0.0)
    assert eng.stats()["prefix_cache"]["hit_tokens"] >= 64
    # the second prompt: its suffix from the first unmatched page on
    second = [c for c in calls if c[0] > 0]
    assert second and all(d % 16 == 0 for d, _ in calls)


def test_chunked_prefill_with_speculation():
    """``test_spec_with_chunked_prefill``: the lookup history is seeded when
    the last chunk lands, so a parked slot joins speculative ticks with the
    right history; the JAX engine's tokens and the plain chunked engine's."""
    prompts = ["0123456789" * 6, "abcabc"]
    spec = dict(speculative=True, spec_threshold=0.0, spec_rounds=2, prefill_chunk=16)
    out = _engine(**spec).generate(prompts, max_new_tokens=21, temperature=0.0)
    assert tuple(out) == _jax_greedy(False, tuple(prompts), 21, tuple(spec.items()))
    assert out == _engine(prefill_chunk=16).generate(prompts, max_new_tokens=21,
                                                     temperature=0.0)


def test_short_request_finishes_while_a_long_one_prefills():
    """``test_chunked_prefill_interleaves_with_decode``: a long admission
    does not stall an in-flight short request, which finishes while the long
    prompt is still prefilling."""
    eng = _engine(decode_chunk=2, prefill_chunk=16)
    tok = eng.tokenizer
    short = eng.submit(_ids(tok, "hi"), max_new_tokens=4, temperature=0.0)
    eng.step()  # short admitted, first decode chunk
    long_id = eng.submit(_ids(tok, "x" * 200), max_new_tokens=6, temperature=0.0)
    seen_prefilling = 0
    while short not in eng._completed:
        eng.step()
        long_req = next(r for r in eng._slots if r is not None and r.req_id == long_id)
        assert long_req.prefilling or short in eng._completed
        seen_prefilling = max(seen_prefilling, eng.stats()["slots_prefilling"])
    long_req = next(r for r in eng._slots if r is not None and r.req_id == long_id)
    assert long_req.prefilling and long_req.tokens == []
    assert seen_prefilling == 1
    results = eng.run()
    assert sorted(results) == sorted([short, long_id])
    ref = _engine()
    rid = ref.submit(_ids(tok, "x" * 200), max_new_tokens=6, temperature=0.0)
    assert results[long_id] == ref.run()[rid]


def test_same_seed_same_sampled_tokens_chunked_and_unchunked():
    """Only the last chunk samples, from a generator seeded there from the
    request's seed: a sampled request's tokens are the unchunked engine's."""
    tok = ByteTokenizer()
    prompt = _ids(tok, "z" * 70)
    outs = []
    for chunk in (0, 16, 32):
        eng = _engine(prefill_chunk=chunk)
        rid = eng.submit(prompt, max_new_tokens=8, temperature=0.9, seed=123)
        outs.append(eng.run()[rid])
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) > 0


def test_chunked_sampled_seed_reproducible_while_parked():
    """``test_chunked_prefill_sampled_seed_reproducible``: a variable number
    of parked ticks does not move the sampled tokens."""
    tok = ByteTokenizer()
    long_prompt = _ids(tok, "z" * 70)
    eng1 = _engine(prefill_chunk=16)
    r1 = eng1.submit(long_prompt, max_new_tokens=6, temperature=0.9, seed=123)
    out1 = eng1.run()[r1]
    eng2 = _engine(prefill_chunk=16)
    eng2.submit(_ids(tok, "hello"), max_new_tokens=6, temperature=0.9, seed=5)
    eng2.step()
    eng2.step()
    r2 = eng2.submit(long_prompt, max_new_tokens=6, temperature=0.9, seed=123)
    assert eng2.run()[r2] == out1


def test_budget_trace_matches_jax():
    """One trace under ``prefill_chunk=32, token_budget=64``: the tokens and
    ``max_tick_prefill_tokens`` equal the JAX engine's, and the spend stays
    within ``max(one chunk, budget - decode_ready x decode_chunk)``."""
    kw = dict(prefill_chunk=32, token_budget=64, n_slots=4)
    eng = _engine(**kw)
    out = eng.generate(PROMPTS, max_new_tokens=12, temperature=0.0)
    jeng = _jax_engine(**kw)
    assert out == jeng.generate(PROMPTS, max_new_tokens=12, temperature=0.0)
    st = eng.stats()
    assert st["token_budget"] == 64 and eng.prefill_chunk == 32
    assert st["max_tick_prefill_tokens"] == jeng.max_tick_prefill_tokens > 0
    assert st["max_tick_prefill_tokens"] <= 64


def test_budget_defers_admission_and_chunks_per_tick():
    """A tight budget (one decode tick of four slots) with long prompts: the
    tick's first prefill always passes, and nothing else passes once decode
    takes the whole budget, so no tick spends more than one chunk; the
    tokens are the unbudgeted engine's."""
    prompts = ["ab", "cd", "y" * 90, "w" * 70]
    eng = _engine(prefill_chunk=32, token_budget=16, n_slots=4, decode_chunk=4)
    tok = eng.tokenizer
    rids = [eng.submit(_ids(tok, p), max_new_tokens=8, temperature=0.0) for p in prompts]
    spends = []
    while eng.pending:
        waiting = bool(eng._queue) or any(r is not None and r.prefilling for r in eng._slots)
        eng.step()
        spends.append(eng._tick_prefill_spent)
        assert eng._tick_prefill_spent > 0 or not waiting  # the first prefill passes
    done = eng.run()  # the finished requests' tokens
    assert max(spends) == eng.max_tick_prefill_tokens == 32
    assert [tok.decode(done[r]) for r in rids] == _engine(n_slots=4).generate(
        prompts, max_new_tokens=8, temperature=0.0)


@pytest.mark.parametrize("kw,match", [
    ({"prefill_chunk": -16}, "prefill_chunk"),
    ({"prefill_chunk": 24}, "multiple of page_size"),
    ({"token_budget": -1}, "token_budget"),
    ({"token_budget": 7}, "full decode tick"),
])
def test_budget_and_chunk_checks(kw, match):
    """The reference's constructor checks: a chunk must be page-aligned and
    the budget must cover ``n_slots x decode_chunk``; both packages refuse."""
    jcfg, params, cfg, tparams = _pair()
    with pytest.raises(ValueError, match=match):
        ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", n_slots=2,
                         decode_chunk=4, **PAGED, **kw)
    with pytest.raises(ValueError, match=match):
        JaxEngine(params, jcfg, JaxByteTokenizer(), n_slots=2, decode_chunk=4, **PAGED, **kw)


def test_cancel_a_prefilling_request_frees_its_slot_and_pages():
    """``cancel()`` of a parked request frees its slot and every page it
    held (no prompt page was published yet)."""
    eng = _engine(prefill_chunk=16)
    tok = eng.tokenizer
    free0 = eng.allocator.n_free
    rid = eng.submit(_ids(tok, "k" * 120), max_new_tokens=8, temperature=0.0)
    eng.step()
    req = next(r for r in eng._slots if r is not None)
    assert req.prefilling and 0 < req.prefill_pos < len(req.prompt)
    assert eng.stats()["slots_prefilling"] == 1
    assert eng.allocator.n_free < free0
    assert eng.cancel(rid)
    assert eng.allocator.n_free + eng.allocator.n_evictable == free0
    assert eng.allocator.n_evictable == 0
    assert eng.pending == 0 and eng.stats()["slots_prefilling"] == 0
    # the freed slot serves the next request as usual
    assert eng.generate(["again"], max_new_tokens=6, temperature=0.0) == _engine().generate(
        ["again"], max_new_tokens=6, temperature=0.0)
