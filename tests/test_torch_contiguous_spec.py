"""Port parity: speculative and int8 ticks of the port's continuous engine
over the contiguous KV cache against the JAX package's ``ContinuousEngine``
with its default cache mode, on the same weights.

The tiny f32 config (context 128) of ``tests/test_torch_contiguous.py``:
greedy tokens must be identical on prompt-lookup speculative ticks (every
tick speculates), on draft-model ticks (the target as its own drafter, over
its own contiguous cache), and on plain and lookup ticks over an int8 cache
(values plus per-position scales). Logprobs of speculative rounds agree
within ``LP_TOL``; the verify rounds' acceptance accounting is the
reference's (no page cap on a contiguous row). The port's rows write each
verify window at their own depth, so every tick of a speculative engine is
checked against the plain engine's tokens too.
"""

import dataclasses

import jax
import numpy as np
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
LP_TOL = 1e-5
MAX_NEW = 16
SPEC = dict(speculative=True, spec_k=4, spec_threshold=0.0)
ENGINES = {
    "plain": dict(n_slots=4, decode_chunk=4),
    "lookup": dict(n_slots=4, decode_chunk=4, logprobs_k=2, **SPEC),
    "draft": dict(n_slots=4, decode_chunk=4, spec_rounds=2, draft=True, **SPEC),
    "int8": dict(n_slots=4, decode_chunk=4, kv8=True),
    "int8_lookup": dict(n_slots=4, decode_chunk=4, kv8=True, **SPEC),
}
# prompts that repeat a span (what prompt lookup is for), one long enough
# that its verify windows near the row's end
SPAN = ["the cat sat on the the cat sat on the", "a b a b a b a b", "n = 1 2 3 1 2 3",
        "abc abc abc", "xy " * 39]


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _make(models, kind: str, port: bool):
    jcfg, jparams, cfg, tparams = models
    kw = dict(ENGINES[kind])
    if kw.pop("kv8", False):
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if kw.pop("draft", False):
        kw.update(draft_params=tparams if port else jparams, draft_cfg=cfg if port else jcfg)
    if port:
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu",
                                gen=GenerateConfig(max_new_tokens=MAX_NEW), **kw)
    return JaxEngine(jparams, jcfg, JaxByteTokenizer(),
                     gen=JaxGenerateConfig(max_new_tokens=MAX_NEW), **kw)


def _run(eng, **kw) -> list:
    tok = eng.tokenizer
    rids = [eng.submit([tok.bos_id] + tok.encode(p), max_new_tokens=(8 if len(p) > 90
                                                                     else MAX_NEW), **kw)
            for p in SPAN]
    done, steps = {}, 0
    while eng.pending:
        eng.step()
        steps += 1
        assert steps < 2000
        done.update({r.req_id: r for r in eng.take_finished()})
    return [done[r] for r in rids]


@pytest.fixture(scope="module")
def runs(models):
    """{kind: (JAX requests, port requests, JAX stats, port stats)}."""
    out = {}
    for kind in ENGINES:
        kw = {"logprobs": 2} if kind == "lookup" else {}
        engines = [_make(models, kind, port) for port in (False, True)]
        reqs = [_run(e, **kw) for e in engines]
        out[kind] = (*reqs, *(e.stats() for e in engines))
    return out


@pytest.mark.parametrize("kind", list(ENGINES))
def test_greedy_tokens_match_jax(runs, kind):
    jreqs, treqs, _, tst = runs[kind][:4]
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert tst["cache_mode"] == "contiguous"


@pytest.mark.parametrize("kind", ["lookup", "draft"])
def test_speculative_ticks_give_the_plain_tokens(runs, kind):
    """Every tick speculates, and the tokens are the plain ticks'."""
    assert [r.tokens for r in runs[kind][1]] == [r.tokens for r in runs["plain"][1]]
    spec = runs[kind][3]["speculative"]
    assert spec["spec_ticks"] == spec["ticks"] > 0 and spec["drafter"] == (
        "model" if kind == "draft" else "lookup")


def test_int8_cache_rows_hold_int8_values_and_scales(models):
    eng = _make(models, "int8", True)
    assert eng.cache["k"].dtype == torch.int8 and eng.cache["k_scale"].dtype == torch.float32
    assert eng.cache["k"].shape == (2, 4, 128, 2, 16)


def test_speculative_logprobs_and_acceptance_match_jax(runs):
    """The lookup rounds score every emitted token as the reference's, and
    accept the same drafts (acceptance EMA and tick counts)."""
    jreqs, treqs, jst, tst = runs["lookup"]
    for t, j in zip(treqs, jreqs):
        assert t.lp_top_ids == j.lp_top_ids and len(t.lp_token) == len(t.tokens)
        np.testing.assert_allclose(t.lp_token, j.lp_token, rtol=0, atol=LP_TOL)
        np.testing.assert_allclose(t.lp_top, j.lp_top, rtol=0, atol=LP_TOL)
    for key in ("spec_ticks", "ticks"):
        assert tst["speculative"][key] == jst["speculative"][key], key
    assert tst["speculative"]["acceptance_ema"] == pytest.approx(
        jst["speculative"]["acceptance_ema"], rel=1e-9)
