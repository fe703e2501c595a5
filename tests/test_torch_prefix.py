"""Port parity: ``register_prefix`` and ``clear_prefixes`` on both cache
modes of the port's continuous engine, against the JAX package's
``ContinuousEngine`` on the same weights (``tests/test_continuous.py``'s
prefix scenarios and ``tests/test_paged.py``'s page warming).

Contiguous cache: a registered prefix's KV row is copied into the admitted
slot and only the rest of the prompt is prefilled, so a prefix hit must give
the cold engine's greedy tokens and the JAX engine's (f32, context 128):
hits mixed with uncached requests, the longest match, a prompt equal to the
prefix (its first token from the stored logits, no prefill forward), a
chunked prompt after a prefix, an int8 cache (values and scales seeded). The
prefix-cache accounting, the validation messages and idempotence are the
reference's. Paged cache: the warm is a hint that later admissions start
after the warmed pages, with the reference's hit tokens; on a full pool it
is a no-op that leaks no page.
"""

import dataclasses

import jax
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")
SYSTEM = "system: you are a helpful assistant\n"
QUESTIONS = ["hello", "what is jax?", "abc abc"]
TOK = ByteTokenizer()
PREFIX = [TOK.bos_id] + TOK.encode(SYSTEM)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _make(models, port: bool, max_new: int = 10, kv8: bool = False, **kw):
    jcfg, jparams, cfg, tparams = models
    if kv8:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if port:
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu",
                                gen=GenerateConfig(max_new_tokens=max_new), **kw)
    return JaxEngine(jparams, jcfg, JaxByteTokenizer(),
                     gen=JaxGenerateConfig(max_new_tokens=max_new), **kw)


def _both(models, **kw):
    return _make(models, False, **kw), _make(models, True, **kw)


def _gen(eng, prompts: list[str]) -> list[list[int]]:
    """Greedy token ids of ``prompts`` (BOS + bytes), sharing ticks."""
    rids = [eng.submit([TOK.bos_id] + TOK.encode(p)) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def cold(models):
    """The cold port engine's greedy tokens of every prompt used below."""
    eng = _make(models, True, n_slots=4)
    prompts = ([SYSTEM + q for q in QUESTIONS] + [SYSTEM[:-1], "no prefix here",
               "sys: be terse\nhi", SYSTEM + " tail " + "q" * 40])
    return dict(zip(prompts, _gen(eng, prompts)))


def test_prefix_hit_gives_the_cold_and_the_jax_tokens(models, cold):
    """Seed copy plus suffix prefill: the cold tokens, the reference's, and
    the reference's prefix-cache accounting."""
    prompts = [SYSTEM + q for q in QUESTIONS]
    outs, stats = [], []
    for eng in _both(models, n_slots=4):
        eng.register_prefix(PREFIX)
        outs.append(_gen(eng, prompts))
        stats.append(eng.stats())
    assert outs[1] == outs[0] == [cold[p] for p in prompts]
    assert stats[1]["prefix_cache"] == stats[0]["prefix_cache"]
    assert stats[1]["prefix_cache"]["hit_tokens"] == 3 * len(PREFIX)
    assert stats[1]["prefills_cold"] == 0 and stats[1]["prefills_prefix_hit"] == 3


def test_prompt_equal_to_the_prefix_samples_the_stored_logits(models, cold):
    """No prefill forward at admission: the first token comes from the
    logits stored at registration."""
    outs = []
    for eng in _both(models):
        eng.register_prefix(PREFIX[:-1])
        rid = eng.submit(PREFIX[:-1])
        if isinstance(eng, ContinuousEngine):
            eng._admit()
            assert eng.prefills_cold == eng.prefills_prefix_hit == 0
        outs.append(eng.run()[rid])
    assert outs[1] == outs[0] == cold[SYSTEM[:-1]]


def test_longest_match_wins(models, cold):
    short = [TOK.bos_id] + TOK.encode("sys: ")
    long = [TOK.bos_id] + TOK.encode("sys: be terse\n")
    prompt = long + TOK.encode("hi")
    outs = []
    for eng in _both(models, max_new=6):
        eng.register_prefix(short)
        eng.register_prefix(long)
        assert eng._match_prefix(prompt)[2] == len(long)
        assert eng._match_prefix(short + TOK.encode("zz"))[2] == len(short)
        assert eng._match_prefix(TOK.encode("unrelated")) is None
        rid = eng.submit(prompt)
        outs.append(eng.run()[rid])
    assert outs[1] == outs[0] == cold["sys: be terse\nhi"][:6]


def test_prefix_hits_mixed_with_uncached_requests(models, cold):
    prompts = [SYSTEM + "hello", "no prefix here", SYSTEM + "abc abc"]
    outs = []
    for eng in _both(models, n_slots=2):
        eng.register_prefix(PREFIX)
        outs.append(_gen(eng, prompts))
    assert outs[1] == outs[0] == [cold[p] for p in prompts]


def test_chunked_prompt_after_a_prefix(models, cold):
    """Prefix seeding composes with chunking: only the suffix is chunked
    (16-token chunks), and the prefix row is seeded at admission."""
    prompt = SYSTEM + " tail " + "q" * 40
    outs = []
    for eng in _both(models, prefill_chunk=16):
        eng.register_prefix(PREFIX)
        outs.append(_gen(eng, [prompt]))
    assert outs[1] == outs[0] == [cold[prompt]]


def test_int8_prefix_rows_seed_values_and_scales(models):
    """On an int8 cache the prefix row is int8 with its scales, and a hit
    gives the int8 cold engine's tokens and the reference's."""
    prompts = [SYSTEM + q for q in QUESTIONS[:2]]
    ref = _gen(_make(models, True, kv8=True, n_slots=2), prompts)
    outs = []
    for eng in _both(models, kv8=True, n_slots=2):
        eng.register_prefix(PREFIX)
        outs.append(_gen(eng, prompts))
    row = _make(models, True, kv8=True)
    row.register_prefix(PREFIX)
    kv = next(iter(row._prefixes.values()))[0]
    assert kv["k"].dtype == torch.int8 and set(kv) == set(row.cache)
    assert outs[1] == outs[0] == ref


def test_register_validation_idempotence_and_clear(models):
    msgs = []
    for eng in _both(models):
        for bad in ([], list(range(3, 3 + 128))):
            with pytest.raises(ValueError) as e:
                eng.register_prefix(bad)
            msgs.append(str(e.value))
        eng.register_prefix([5, 6, 7])
        eng.register_prefix([5, 6, 7])  # idempotent
        assert len(eng._prefixes) == 1
        eng.clear_prefixes()
        assert eng._prefixes == {}
    assert msgs[:2] == msgs[2:] and "non-empty" in msgs[0] and "no room" in msgs[1]


# -- paged: register_prefix warms the page cache --------------------------------

WARM = [TOK.bos_id] + TOK.encode("w" * 100)  # 101 tokens: 6 full pages of 16


def _paged(models, port: bool, **kw):
    return _make(models, port, max_new=8, cache_mode="paged", page_size=16, **kw)


def test_paged_warm_is_a_hint_later_admissions_start_after_it(models):
    """After the warm, an admission of the prefix plus a suffix prefills
    only past the warmed pages, with the cold tokens and the reference's
    hit tokens; the warm's measured rate appears in ``stats()``."""
    prompt = WARM + TOK.encode(" suffix")
    cold = _paged(models, True)
    rid = cold.submit(prompt)
    want = cold.run()[rid]
    outs, hits = [], []
    for eng in (_paged(models, False), _paged(models, True)):
        eng.register_prefix(WARM)
        eng.register_prefix(WARM)  # all pages matched: nothing to prefill
        if isinstance(eng, ContinuousEngine):
            assert eng.prefills_cold == 1 and eng.prefill_tokens_total == 96
            calls = []
            orig = eng._paged_prefill_chunk

            def spy(req, slot, d, s, generator):
                calls.append((d, s))
                return orig(req, slot, d, s, generator)

            eng._paged_prefill_chunk = spy
        rid = eng.submit(prompt)
        outs.append(eng.run()[rid])
        hits.append(eng.stats()["prefix_cache"])
    assert calls == [(96, len(prompt) - 96)]
    assert outs[1] == outs[0] == want
    assert hits[1] == hits[0] and hits[1]["hit_tokens"] == 96
    st = eng.stats()
    assert st["prefill_tok_per_s"] > 0
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]


def test_paged_warm_on_a_full_pool_is_a_no_op(models):
    """Three usable pages cannot hold the six a 101-token prefix fills: the
    warm logs and returns, every page free, no rate reported, as the
    reference."""
    free = []
    for eng in (_paged(models, False, n_pages=4), _paged(models, True, n_pages=4)):
        free0 = eng.allocator.n_free + eng.allocator.n_evictable
        eng.register_prefix([1] + list(range(5, 105)))
        free.append((free0, eng.allocator.n_free + eng.allocator.n_evictable))
    assert free[1] == free[0] == (3, 3)
    assert "prefill_tok_per_s" not in eng.stats()
