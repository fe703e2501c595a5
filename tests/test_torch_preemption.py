"""Port parity: optimistic admission with preemption and exact resume, in
the scenarios of ``tests/test_preemption.py``.

The JAX ``ContinuousEngine`` and the port's run the same schedules on the
same weights (the reference tests' tiny f32 config, page size 16): the peak
number of decoding slots, ``preemptions``, each request's
``preempt_count``, ``resume_prefill_tokens`` and the anti-thrash guard's
``admission_degrades`` must be equal, and greedy tokens identical. The JAX
runs are made once, by a module fixture. Sampled, logprob, streamed and
drafted resumes are held to the port's own uncontended run: tokens and
logprob top ids exactly; logprob values within ``LP_RESUME_TOL``, because
a resume re-prefills the generated tokens' K/V in one batched forward whose
f32 sums round apart from the decode steps that first wrote them (the
reference's own test allows the same).
"""

import queue

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
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256,
            dtype="float32")
LP_RESUME_TOL = 1e-5
PROMPT = [1] + list(range(5, 21))
PROMPT_B = [1] + list(range(30, 46))
PROMPT_C = [1] + list(range(50, 66))
# 12 staggered arrivals into 12 usable pages (the reference's thrash drill)
THRASH_PROMPTS = [[1] + list(range(5 + 3 * i, 21 + 3 * i)) for i in range(12)]
LONG_B = [1] + list(range(2, 152))  # 151 tokens: 5 chunks of 32

# Scenario -> (engine settings, requests (prompt, submit kwargs)). Pool: 12
# usable pages of 16 tokens; a 17-token prompt with max_new 144 needs 11
# pages at worst, so reserve admission runs one request at a time.
SCENARIOS = {
    "reserve": (dict(n_pages=13, admission="reserve", max_new=144),
                [(p, {}) for p in (PROMPT, PROMPT_B, PROMPT_C)]),
    "optimistic": (dict(n_pages=13, admission="optimistic", max_new=144),
                   [(p, {}) for p in (PROMPT, PROMPT_B, PROMPT_C)]),
    # 9 usable pages: both requests cannot run to their budget together
    "greedy": (dict(n_pages=10, admission="optimistic", max_new=96),
               [(p, {}) for p in (PROMPT, PROMPT_B)]),
    # the worst (class, id) goes first: best_effort, then batch
    "classes": (dict(n_pages=13, admission="optimistic", max_new=144),
                [(PROMPT, {"slo_class": "batch"}), (PROMPT_B, {"slo_class": "interactive"}),
                 (PROMPT_C, {"slo_class": "best_effort"})]),
}


def _drive(eng, requests, every: int = 0):
    """Submit ``requests`` (all at once, or one each ``every`` steps) and
    step until done: (peak decoding slots, finished requests in submission
    order)."""
    rids, peak, done, steps = [], 0, {}, 0
    while eng.pending or len(rids) < len(requests):
        while len(rids) < len(requests) and (not every or steps % every == 0):
            prompt, kw = requests[len(rids)]
            rids.append(eng.submit(prompt, **kw))
            if every:
                break
        eng.step()
        steps += 1
        assert steps < 5000
        peak = max(peak, sum(r is not None and not r.prefilling for r in eng._slots))
        done.update({r.req_id: r for r in eng.take_finished()})
    return peak, [done[r] for r in rids]


def _summary(eng, peak, reqs) -> dict:
    st = eng.stats()
    return {"peak": peak, "tokens": [r.tokens for r in reqs],
            "preempt_count": [r.preempt_count for r in reqs],
            "preemptions": eng.preemptions,
            **{k: st.get(k) for k in ("resume_prefill_tokens", "admission_degrades")}}


def _jax_engine(pair, max_new=16, **kw):
    jcfg, params, _, _ = pair
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_chunk", 4)
    return JaxEngine(params, jcfg, JaxByteTokenizer(), cache_mode="paged", page_size=16,
                     gen=JaxGenerateConfig(max_new_tokens=max_new), **kw)


def _engine(pair, max_new=16, **kw):
    _, _, cfg, tparams = pair
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_chunk", 4)
    return ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged", page_size=16,
                            gen=GenerateConfig(max_new_tokens=max_new), device="cpu", **kw)


def _mid_prefill(make):
    """The reference's mid-prefill case: a decoding, b still prefilling
    (151 tokens in chunks of 32) when a's pages run out; b is the victim,
    requeued fresh. Returns what the scenario shows and both results."""
    eng = make(n_pages=40, admission="optimistic", max_new=32, prefill_chunk=32)
    ra = eng.submit(PROMPT)
    eng.step()
    rb = eng.submit(LONG_B)
    eng.step()
    areq = next(r for r in eng._slots if r is not None and r.req_id == ra)
    breq = next(r for r in eng._slots if r is not None and r.req_id == rb)
    victim = eng._pick_victim(areq)
    seen = (breq.prefilling, victim == breq.slot)
    eng._preempt_slot(victim)
    seen += (breq.preempted, breq.prefilling, breq in eng._queue, eng.preemptions)
    res = eng.run()
    return seen, res[ra], res[rb], eng.stats()["prefix_cache"]


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


@pytest.fixture(scope="module")
def jax_runs(pair):
    """Every JAX schedule of this file, run once."""
    out = {}
    for name, (kw, requests) in SCENARIOS.items():
        eng = _jax_engine(pair, **kw)
        out[name] = _summary(eng, *_drive(eng, requests))
    eng = _jax_engine(pair, n_pages=13, admission="optimistic", max_new=96, thrash_window=8)
    out["thrash"] = _summary(eng, *_drive(eng, [(p, {}) for p in THRASH_PROMPTS], every=6))
    out["mid_prefill"] = _mid_prefill(lambda **kw: _jax_engine(pair, **kw))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_schedule_and_tokens_match_jax(pair, jax_runs, name):
    """``test_optimistic_strictly_more_concurrent_at_equal_pool``,
    ``test_preemption_exact_resume_greedy`` and the SLO-class victim rule:
    the same peaks, preemptions, per-request preemption counts and
    re-prefilled tokens as the JAX engine, and identical greedy tokens."""
    kw, requests = SCENARIOS[name]
    eng = _engine(pair, **kw)
    got = _summary(eng, *_drive(eng, requests))
    assert got == jax_runs[name]
    if name == "reserve":
        assert got["peak"] == 1  # worst-case reservations serialise the pool
    elif name == "optimistic":
        assert got["peak"] == 3 and got["preemptions"] >= 1
        assert got["tokens"] == jax_runs["reserve"]["tokens"]
    elif name == "classes":  # best_effort is evicted first, interactive never
        assert got["preempt_count"][1] == 0 and got["preempt_count"][2] >= 1
    st = eng.stats()
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
    assert st["slots_busy"] == st["queue_depth"] == 0


def test_greedy_resume_equals_the_uncontended_run(pair, jax_runs):
    """The preempted request's tokens equal an uncontended engine's."""
    solo = _engine(pair, max_new=96, n_pages=20)
    rids = [solo.submit(p) for p in (PROMPT, PROMPT_B)]
    ref = solo.run()
    assert solo.preemptions == 0
    assert [ref[r] for r in rids] == jax_runs["greedy"]["tokens"]
    assert jax_runs["greedy"]["preemptions"] >= 1


def test_thrash_guard_matches_jax(pair, jax_runs):
    """``test_anti_thrash_hysteresis_engages_and_releases``: twelve staggered
    arrivals into a pool that barely holds three; the guard engages once
    over windows of 8 ticks, with the JAX engine's preemptions and
    re-prefilled tokens, the same tokens, and a light workload after the
    drain releases it."""
    eng = _engine(pair, n_pages=13, admission="optimistic", max_new=96, thrash_window=8)
    got = _summary(eng, *_drive(eng, [(p, {}) for p in THRASH_PROMPTS], every=6))
    assert got == jax_runs["thrash"]
    assert got["admission_degrades"] == 1
    unguarded = _engine(pair, n_pages=13, admission="optimistic", max_new=96,
                        thrash_window=10_000_000)
    free = _summary(unguarded, *_drive(unguarded, [(p, {}) for p in THRASH_PROMPTS], every=6))
    assert free["tokens"] == got["tokens"] and free["admission_degrades"] == 0
    assert got["preemptions"] < free["preemptions"] / 2
    assert got["resume_prefill_tokens"] < free["resume_prefill_tokens"] / 2
    eng._degraded = True  # hold the guard, then let a quiet window release it
    rid = eng.submit([1] + list(range(50, 60)))
    assert len(eng.run()[rid]) > 0
    assert not eng.stats()["admission_degraded"]


def test_mid_prefill_victim_requeued_fresh(pair, jax_runs):
    """``test_prefilling_younger_is_preempted_not_the_needy_oldest``: the
    prefilling younger request is the victim, requeued fresh (no frontier),
    and both finish with the JAX engine's tokens; its prompt counts once in
    the prefix-cache accounting."""
    seen, a, b, prefix = _mid_prefill(lambda **kw: _engine(pair, **kw))
    jseen, ja, jb, _ = jax_runs["mid_prefill"]
    assert seen == jseen == (True, True, False, False, True, 1)
    assert (a, b) == (ja, jb)
    assert prefix["hit_tokens"] + prefix["miss_tokens"] == len(PROMPT) + len(LONG_B)


def _run_lp(eng, requests):
    rids = [eng.submit(p, **kw) for p, kw in requests]
    done = {}
    while eng.pending:
        eng.step()
        done.update({r.req_id: r for r in eng.take_finished()})
    return [done[r] for r in rids]


def test_sampled_logprob_resume_is_exact(pair):
    """``test_preemption_exact_resume_sampled_logprobs``: a sampled request
    resumes with its own generator in the state it had and its pending
    logprob stats, so its tokens and top ids equal the uncontended run's."""
    requests = [(p, dict(temperature=0.9, top_p=0.95, seed=s, logprobs=2))
                for p, s in ((PROMPT, 7), (PROMPT_B, 8))]
    ref = _run_lp(_engine(pair, max_new=96, n_pages=20, logprobs_k=2), requests)
    eng = _engine(pair, max_new=96, n_pages=10, admission="optimistic", logprobs_k=2)
    got = _run_lp(eng, requests)
    assert eng.preemptions >= 1 and any(r.preempt_count for r in got)
    for r, g in zip(ref, got):
        assert g.tokens == r.tokens
        assert g.lp_top_ids == r.lp_top_ids
        np.testing.assert_allclose(g.lp_token, r.lp_token, rtol=0, atol=LP_RESUME_TOL)
        np.testing.assert_allclose(g.lp_top, r.lp_top, rtol=0, atol=LP_RESUME_TOL)


def test_streamed_resume(pair):
    """Streams pause while their request is requeued and resume; their
    chunks concatenate to the uncontended tokens, with one terminal None."""
    solo = _engine(pair, max_new=96, n_pages=20)
    rids = [solo.submit(p) for p in (PROMPT, PROMPT_B)]
    ref = solo.run()
    eng = _engine(pair, max_new=96, n_pages=10, admission="optimistic")
    qs = [queue.Queue(), queue.Queue()]
    got = [eng.submit(p, stream=q) for p, q in zip((PROMPT, PROMPT_B), qs)]
    res = eng.run()
    assert eng.preemptions >= 1
    for q, r, g in zip(qs, rids, got):
        items = [q.get_nowait() for _ in range(q.qsize())]
        assert items.count(None) == 1 and items[-1] is None
        assert sum(items[:-1], []) == ref[r] == res[g]


def test_cancel_of_a_queued_preempted_request(pair):
    """A preempted request cancelled while it waits: one terminal None, no
    result, and nothing released twice (every page back to free or cached,
    the allocator's counts consistent)."""
    eng = _engine(pair, max_new=96, n_pages=40, admission="optimistic")
    q = queue.Queue()
    rid = eng.submit(PROMPT, stream=q)
    eng.step()
    eng.step()
    slot = next(i for i, r in enumerate(eng._slots) if r is not None)
    eng._preempt_slot(slot)
    req = eng._queue[0]
    assert req.preempted and req.req_id == rid and len(req.tokens) == 8
    st = eng.stats()
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
    assert eng.cancel(rid)
    assert not eng._queue and eng.take_result(rid) is None
    st = eng.stats()
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
    items = [q.get_nowait() for _ in range(q.qsize())]
    assert items.count(None) == 1 and items[-1] is None
    other = eng.submit(PROMPT_B)  # the engine goes on serving
    assert len(eng.run()[other]) == 96


@pytest.mark.parametrize("draft", [False, True])
def test_speculative_resume_into_a_foreign_slot(pair, draft):
    """``test_preemption_resume_with_draft_model_spec``: b is preempted past
    20 tokens, held until a finishes, then resumes into a's slot, whose
    drafter cache holds a's context: greedy tokens equal the uncontended
    run's, and (drafter) post-resume acceptance stays near its level (a
    perfect drafter, the target itself; a prompt-only re-prefill would
    collapse it to the bonus token). With lookup drafts the history is
    restored. ``prefill_chunk=32``: the drafter's re-prefill of the resumed
    context runs in chunks."""
    _, _, cfg, tparams = pair
    kw = dict(n_slots=2, n_pages=40, admission="optimistic", speculative=True, spec_k=4,
              spec_threshold=0.0, prefill_chunk=32, max_new=96)
    if draft:
        kw.update(draft_params=tparams, draft_cfg=cfg)
    ref_eng = _engine(pair, **kw)
    rids = [ref_eng.submit(p) for p in (PROMPT, PROMPT_B)]
    ref = ref_eng.run()
    eng = _engine(pair, **kw)
    ra, rb = eng.submit(PROMPT), eng.submit(PROMPT_B)
    while not (eng._slots[1] is not None and len(eng._slots[1].tokens) >= 20):
        eng.step()
    eng._preempt_slot(1)
    held = eng._queue.pop(0)  # park b so that it cannot resume into slot 1
    while any(r is not None for r in eng._slots):
        eng.step()
    pre_t, pre_f = held.spec_tokens, held.spec_forwards
    eng._queue.insert(0, held)
    eng.step()
    assert eng._slots[0] is held and not held.preempted
    res = eng.run()
    assert res[ra] == ref[rids[0]] and res[rb] == ref[rids[1]]
    if draft:
        assert (held.spec_tokens - pre_t) / max(1, held.spec_forwards - pre_f) > 2.0


def test_optimistic_settings_and_stats(pair):
    """Validation and the optimistic block of ``stats()``."""
    with pytest.raises(ValueError, match="thrash_window"):
        _engine(pair, admission="optimistic", thrash_window=0)
    with pytest.raises(ValueError, match="admission"):
        _engine(pair, admission="eager")
    reserve = _engine(pair).stats()
    assert reserve["admission"] == "reserve" and reserve["preemptions"] == 0
    assert "admission_degrades" not in reserve
    st = _engine(pair, admission="optimistic").stats()
    assert (st["admission"], st["admission_degraded"], st["admission_degrades"],
            st["resume_prefill_tokens"]) == ("optimistic", False, 0, 0)
    spec = _engine(pair, admission="optimistic", speculative=True, spec_k=4, spec_rounds=2)
    assert spec._tick_advance_bound() == 2 * 5 + 5
