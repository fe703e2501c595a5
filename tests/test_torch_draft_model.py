"""Port parity: draft-model speculation in the continuous engine, mirroring
``tests/test_draft_model.py``.

A small draft model drafts k tokens a round over its own contiguous
per-slot cache and the target verifies them through K3's multi-query form
(on the CPU its plain version), so greedy tokens never depend on the
drafter. The port's engine must give the JAX engine's greedy tokens and its
speculation counters (tokens emitted and verify forwards per request) on the
same weights, in float32, whatever the drafter; the target as its own
drafter accepts about k a round.
"""

import dataclasses
import functools

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
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, dtype="float32")
# a genuinely different (smaller, differently seeded) draft model
DRAFT = dict(vocab_size=512, hidden_size=32, intermediate_size=64, num_layers=1,
             num_heads=2, num_kv_heads=1, head_dim=16, max_seq_len=128, dtype="float32")
PAGED = dict(cache_mode="paged", page_size=16)
PROMPTS = ["hello world", "abc abc abc", "the quick brown fox", "zzz"]


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX cfg, JAX params, port cfg, port params) of the target and of the
    drafter, the port's weights converted from the JAX package's."""
    out = []
    for fields, seed in ((TINY, 0), (DRAFT, 99)):
        jcfg, cfg = JaxModelConfig(**fields, param_dtype="float32"), ModelConfig(**fields)
        params = jllama.init_params(jax.random.key(seed), jcfg)
        out.append((jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")))
    return tuple(out)


def _kv(kv8: bool, jcfg, cfg):
    if not kv8:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, kv_cache_dtype="int8"),
            dataclasses.replace(cfg, kv_cache_dtype="int8"))


def _engine(drafter: str = "distinct", kv8: bool = False, **kw):
    """The port's engine; ``drafter``: "distinct" (the small model), "self"
    (the target as its own drafter) or "none" (plain ticks)."""
    (_, _, cfg, tparams), (_, _, dcfg, dparams) = _models()
    _, cfg = _kv(kv8, cfg, cfg)
    kw.setdefault("n_slots", 2)
    kw.setdefault("decode_chunk", 4)
    if drafter != "none":
        kw.setdefault("spec_k", 4)
        kw.setdefault("spec_rounds", 2)
        draft = (dparams, dcfg) if drafter == "distinct" else (tparams, cfg)
        kw.update(speculative=True, draft_params=draft[0], draft_cfg=draft[1])
    return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **PAGED, **kw)


def _jax_engine(drafter: str = "distinct", kv8: bool = False, **kw):
    (jcfg, jparams, _, _), (jdcfg, jdparams, _, _) = _models()
    jcfg, _ = _kv(kv8, jcfg, jcfg)
    kw.setdefault("n_slots", 2)
    kw.setdefault("decode_chunk", 4)
    if drafter != "none":
        kw.setdefault("spec_k", 4)
        kw.setdefault("spec_rounds", 2)
        draft = (jdparams, jdcfg) if drafter == "distinct" else (jparams, jcfg)
        kw.update(speculative=True, draft_params=draft[0], draft_cfg=draft[1])
    return JaxEngine(jparams, jcfg, JaxByteTokenizer(), **PAGED, **kw)


def _run(eng, prompts, max_new: int, **submit_kw):
    """Greedy (by default) token lists in prompt order, and each request's
    (spec_tokens, spec_forwards)."""
    tok = eng.tokenizer
    submit_kw.setdefault("temperature", 0.0)
    rids = [eng.submit([tok.bos_id] + tok.encode(p), max_new_tokens=max_new, **submit_kw)
            for p in prompts]
    reqs = list(eng._queue)
    out = eng.run()
    return [out[r] for r in rids], [(r.spec_tokens, r.spec_forwards) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_run(drafter: str, kv8: bool, prompts: tuple, max_new: int, extra: tuple = ()):
    eng = _jax_engine(drafter, kv8, **dict(extra))
    toks, counts = _run(eng, list(prompts), max_new)
    return toks, counts, (eng.spec_ticks if drafter != "none" else 0)


@pytest.mark.parametrize("kv8", [False, True], ids=["float", "int8"])
def test_distinct_drafter_matches_jax_tokens_and_counters(kv8):
    """A small, unrelated drafter: the port's greedy tokens, each request's
    tokens emitted and verify forwards, and the speculative tick count equal
    the JAX engine's; the tokens equal the plain engine's (float pools)."""
    eng = _engine("distinct", kv8)
    toks, counts = _run(eng, PROMPTS, 12)
    jtoks, jcounts, jticks = _jax_run("distinct", kv8, tuple(PROMPTS), 12)
    assert toks == jtoks
    assert counts == jcounts
    st = eng.stats()["speculative"]
    assert st["drafter"] == "model"
    assert st["spec_ticks"] == st["ticks"] == jticks > 0  # every tick speculates
    assert st["draft_steps"] == (st["k"] + 1) * st["verify_rounds"]
    if not kv8:
        assert toks == _run(_engine("none"), PROMPTS, 12)[0]


def test_bad_drafter_still_exact():
    """A random, unrelated drafter accepts about nothing; the target's
    verify still decides every token (the non-speculative engine's)."""
    prompts = ["hello world", "abc abc abc"]
    eng = _engine("distinct", spec_k=4, spec_rounds=1)
    toks, _ = _run(eng, prompts, 12)
    assert toks == _run(_engine("none"), prompts, 12)[0]
    assert eng.spec_ticks > 0
    assert eng.hist.shape[1] == 1  # no lookup history when drafting by model


def test_perfect_drafter_accepts_k_a_round():
    """The target as its own drafter: drafts agree with the verify's argmax
    but where the one-token and (k+1)-token forwards round a near-tie
    differently, so about k + 1 tokens a round (the JAX engine's counts,
    request by request), and the plain engine's tokens."""
    prompts = ["the quick brown fox", "zzz"]
    eng = _engine("self")
    toks, counts = _run(eng, prompts, 12)
    jtoks, jcounts, _ = _jax_run("self", False, tuple(prompts), 12)
    assert toks == jtoks == _run(_engine("none"), prompts, 12)[0]
    assert counts == jcounts
    assert eng.spec_acceptance_ema is not None and eng.spec_acceptance_ema > 2.0
    # full rounds accept all k drafts plus the verify's own token
    full = [t / f for t, f in counts if f]
    assert max(full) >= eng.spec_k


def test_draft_with_paged_target_at_a_context_cap():
    """``test_draft_with_paged_target``: a contiguous draft cache under a
    paged target at a 64-token context cap, k = 3."""
    prompts = ["paged target", "with a draft"]
    kw = dict(spec_k=3, max_cache_len=64)
    toks, counts = _run(_engine("self", **kw), prompts, 10)
    ref = _run(_engine("none", max_cache_len=64), prompts, 10)[0]
    assert toks == ref
    jtoks, jcounts, _ = _jax_run("self", False, tuple(prompts), 10, tuple(kw.items()))
    assert (toks, counts) == (jtoks, jcounts)
    assert sum(t for t, _ in counts) / sum(f for _, f in counts) > 2.0


def test_more_requests_than_slots_prefill_the_draft_on_reuse():
    """Six requests through two slots: every reused slot's draft row is
    prefilled anew, so the tokens and counters stay the JAX engine's."""
    prompts = PROMPTS + ["abab", "qrsqrsqrs"]
    toks, counts = _run(_engine("self"), prompts, 9)
    jtoks, jcounts, _ = _jax_run("self", False, tuple(prompts), 9)
    assert toks == jtoks
    assert counts == jcounts


def test_draft_mid_flight_admission():
    """A request admitted while another decodes gets its draft row
    prefilled and still gives its isolated result."""
    eng = _engine("self", n_slots=4, decode_chunk=3, spec_k=3)
    tok = eng.tokenizer
    first = eng.submit([tok.bos_id] + tok.encode("first request"), max_new_tokens=10,
                       temperature=0.0)
    eng.step()
    second = eng.submit([tok.bos_id] + tok.encode("second"), max_new_tokens=10,
                        temperature=0.0)
    res = eng.run()
    ref = _run(_engine("none", n_slots=4, decode_chunk=3), ["first request", "second"], 10)[0]
    assert [res[first], res[second]] == ref


def test_sampled_reproducible_and_mixed_greedy_exact():
    """Sampled requests ride drafted ticks: the same seeds give the same
    tokens, and a greedy request sharing ticks with a sampled one decodes
    the plain greedy engine's tokens."""
    prompts = ["hello world", "abc abc abc"]
    o1 = _run(_engine("self"), prompts, 12, temperature=0.8, seed=7)[0]
    o2 = _run(_engine("self"), prompts, 12, temperature=0.8, seed=7)[0]
    assert o1 == o2 and all(len(o) > 0 for o in o1)
    eng = _engine("distinct")
    tok = eng.tokenizer
    r_g = eng.submit([tok.bos_id] + tok.encode(prompts[0]), max_new_tokens=12,
                     temperature=0.0)
    eng.submit([tok.bos_id] + tok.encode(prompts[1]), max_new_tokens=12, temperature=0.9,
               seed=3)
    out = eng.run()
    assert eng.spec_ticks > 0
    assert out[r_g] == _run(_engine("none"), prompts[:1], 12)[0][0]


def test_drafter_with_chunked_prefill():
    """A prompt longer than ``prefill_chunk`` fills the draft cache chunk by
    chunk after its target prefill's last chunk: tokens and counters equal
    the unchunked drafting engine's and the JAX engine's."""
    prompts = ["0123456789" * 6, "abcabc"]
    kw = dict(prefill_chunk=16, max_cache_len=96)
    toks, counts = _run(_engine("self", **kw), prompts, 14)
    assert (toks, counts) == _run(_engine("self", max_cache_len=96), prompts, 14)
    jtoks, jcounts, _ = _jax_run("self", False, tuple(prompts), 14, tuple(kw.items()))
    assert (toks, counts) == (jtoks, jcounts)


def test_verify_reaches_the_wrapper_with_4d_q_when_drafting(monkeypatch):
    """Every verify round of every layer calls ``paged_attention`` once with
    a (B, k+1, H, D) q and the tail; the drafter's decode steps attend its
    contiguous cache and never call the paged wrapper."""
    from ditl_tpu_torch.ops import paged_attention as tpa

    shapes = []
    wrapper = tpa.paged_attention

    def counting(q, *args, **kw):
        shapes.append(tuple(q.shape))
        assert kw.get("tail_k") is not None
        return wrapper(q, *args, **kw)

    monkeypatch.setattr(tpa, "paged_attention", counting)
    eng = _engine("distinct", spec_k=5, spec_rounds=3)
    _run(eng, PROMPTS[:2], 12)
    st = eng.stats()["speculative"]
    assert len(shapes) == TINY["num_layers"] * st["verify_rounds"] > 0
    assert set(shapes) == {(2, 6, TINY["num_heads"], TINY["head_dim"])}


def _bad(what: str):
    """Constructor kwargs for one invalid drafting setup, for both packages:
    (port kwargs, JAX kwargs)."""
    (jcfg, _, cfg, _), (jdcfg, jdparams, dcfg, dparams) = _models()
    if what == "params alone":
        return dict(speculative=True, draft_params=dparams), dict(
            speculative=True, draft_params=jdparams)
    if what == "cfg alone":
        return dict(speculative=True, draft_cfg=dcfg), dict(speculative=True, draft_cfg=jdcfg)
    if what == "not speculative":
        return dict(draft_params=dparams, draft_cfg=dcfg), dict(
            draft_params=jdparams, draft_cfg=jdcfg)
    if what == "vocab":
        return (dict(speculative=True, draft_params=dparams,
                     draft_cfg=dataclasses.replace(dcfg, vocab_size=256)),
                dict(speculative=True, draft_params=jdparams,
                     draft_cfg=dataclasses.replace(jdcfg, vocab_size=256)))
    return (dict(speculative=True, draft_params=dparams,
                 draft_cfg=dataclasses.replace(dcfg, max_seq_len=64)),
            dict(speculative=True, draft_params=jdparams,
                 draft_cfg=dataclasses.replace(jdcfg, max_seq_len=64)))


@pytest.mark.parametrize("what,match", [
    ("params alone", "together"), ("cfg alone", "together"),
    ("not speculative", "speculative"), ("vocab", "vocab"),
    ("short context", "max_seq_len"),
])
def test_drafter_validation_errors(what, match):
    """Each case the reference refuses with ``ValueError``, the port refuses
    too (the draft-params case of the old not-ported test lands here)."""
    (jcfg, jparams, cfg, tparams), _ = _models()
    kw, jkw = _bad(what)
    with pytest.raises(ValueError, match=match):
        ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **PAGED, **kw)
    with pytest.raises(ValueError, match=match):
        JaxEngine(jparams, jcfg, JaxByteTokenizer(), **PAGED, **jkw)


def test_draft_cache_lives_on_the_engine_device_and_shapes():
    """The draft cache is ``init_cache(draft_cfg, n_slots, context cap)`` on
    the engine's device, int8 when the draft config asks for it."""
    eng = _engine("distinct", n_slots=3, max_cache_len=80)
    shape = (DRAFT["num_layers"], 3, 80, DRAFT["num_kv_heads"], DRAFT["head_dim"])
    assert {k: tuple(v.shape) for k, v in eng.draft_cache.items()} == {"k": shape, "v": shape}
    assert eng.draft_cache["k"].device.type == "cpu"
    assert eng.draft_cache["k"].dtype == torch.float32
    (_, _, _, _), (_, _, dcfg, dparams) = _models()
    eng8 = _engine("none", n_slots=2, speculative=True, draft_params=dparams,
                   draft_cfg=dataclasses.replace(dcfg, kv_cache_dtype="int8"))
    assert eng8.draft_cache["k"].dtype == torch.int8 and "k_scale" in eng8.draft_cache
    toks, _ = _run(eng8, PROMPTS[:2], 8)
    assert toks == _run(_engine("none"), PROMPTS[:2], 8)[0]
    np.testing.assert_array_equal(eng8.hist.shape, (2, 1))
