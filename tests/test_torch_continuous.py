"""Port parity: the port's continuous engine over the paged KV cache against
the JAX package's ``ContinuousEngine(cache_mode="paged")`` on the same
weights, in the scenarios of ``tests/test_paged.py``.

The tiny config and page size 16 are ``tests/test_paged.py``'s. Greedy
tokens must be identical (f32 compute, so argmax ties cannot flip on
rounding). Sampled paths cannot match draw for draw (PyTorch's generator is
not JAX's threefry): they are held by per-seed reproducibility inside the
port, and the per-row temperature/top-p shaping is compared with JAX's on
the same logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import sampling as jsampling  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import sampling  # noqa: E402
from ditl_tpu_torch.infer.continuous import (  # noqa: E402
    BadRequestError,
    ContinuousEngine,
    QueueFullError,
    ThreadedEngine,
)
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256,
            dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxModelConfig(**TINY, param_dtype="float32"), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _engines(pair, max_new: int, eos_id: int | None = None, **kw):
    """The JAX and the port's paged engines with the same settings."""
    jcfg, params, cfg, tparams = pair
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_chunk", 8)
    kw.setdefault("page_size", 16)
    jtok, ttok = JaxByteTokenizer(), ByteTokenizer()
    if eos_id is not None:
        jtok.eos_id = ttok.eos_id = eos_id
    jeng = JaxEngine(params, jcfg, jtok, cache_mode="paged",
                     gen=JaxGenerateConfig(max_new_tokens=max_new), **kw)
    teng = ContinuousEngine(tparams, cfg, ttok, cache_mode="paged",
                            gen=GenerateConfig(max_new_tokens=max_new),
                            device="cpu", **kw)
    return jeng, teng


def _spy_prefills(eng) -> list[tuple[int, int]]:
    calls: list[tuple[int, int]] = []
    orig = eng._paged_prefill_chunk

    def spy(req, slot, d, s, generator):
        calls.append((d, s))
        return orig(req, slot, d, s, generator)

    eng._paged_prefill_chunk = spy
    return calls


def test_greedy_matches_jax_engine_and_lockstep(pair):
    """``test_paged_matches_lockstep_generator_greedy``: both engines, and
    the port's lock-step Generator, give the same tokens."""
    prompts = ["hello world", "the quick brown fox", "a",
               "some longer prompt with more text to cross pages"]
    jeng, teng = _engines(pair, 24)
    ref = jeng.generate(prompts)
    assert teng.generate(prompts) == ref
    _, _, cfg, tparams = pair
    tok = ByteTokenizer()
    lock = Generator(tparams, cfg, tok, device="cpu").generate_tokens(
        [[tok.bos_id] + tok.encode(p) for p in prompts], GenerateConfig(max_new_tokens=24))
    assert [tok.decode(t) for t in lock] == ref
    st = teng.stats()
    assert st["decode_steps"] == st["decode_ticks"] * 8
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_paged_decode_always_calls_the_wrapper(pair, monkeypatch, impl):
    """Every decode step of every layer goes through ``paged_attention``
    (the wrapper that launches K3 on the card), whatever ``attention_impl``
    is, as the reference always calls its Pallas kernel there."""
    import dataclasses

    from ditl_tpu_torch.ops import paged_attention as tpa

    calls = []
    wrapper = tpa.paged_attention

    def counting(*args, **kw):
        calls.append(kw.get("tail_k") is not None)
        return wrapper(*args, **kw)

    monkeypatch.setattr(tpa, "paged_attention", counting)
    _, _, cfg, tparams = pair
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    eng = ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged",
                           gen=GenerateConfig(max_new_tokens=12), n_slots=2,
                           decode_chunk=4, page_size=16, device="cpu")
    eng.generate(["hello world", "the quick brown fox"])
    steps = eng.stats()["decode_steps"]
    assert steps > 0 and calls == [True] * (cfg.num_layers * steps)


def test_eos_stop_matches_jax_engine(pair):
    """Make a greedy token of one prompt the EOS id: both engines stop that
    row there and keep decoding the others."""
    tok = ByteTokenizer()
    prompts = [[tok.bos_id] + tok.encode(p) for p in ("hello world", "the quick brown fox")]
    jeng, _ = _engines(pair, 12)
    ids = [jeng.submit(p) for p in prompts]
    free = jeng.run()
    eos = free[ids[0]][3]
    outs = []
    for eng in _engines(pair, 12, eos_id=eos):
        ids = [eng.submit(p) for p in prompts]
        res = eng.run()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1]
    assert outs[0][0] == free[0][:3] and len(outs[0][1]) == 12


def test_pool_exhaustion_queues_and_recovers(pair):
    """``test_paged_pool_exhaustion_queues_and_recovers``: 16 pages fit two
    of three ~90-token requests; the third waits for pages."""
    prompts = ["a" * 90, "b" * 90, "c" * 90]
    jeng, teng = _engines(pair, 8, n_pages=16)
    ref = jeng.generate(prompts)
    tok = ByteTokenizer()
    for p in prompts:
        teng.submit([tok.bos_id] + tok.encode(p))
    teng._admit()  # the first tick's admission
    st = teng.stats()
    assert (st["slots_busy"], st["queue_depth"]) == (2, 1)
    out = teng.run()
    assert [tok.decode(out[i]) for i in range(3)] == ref


def test_capacity_exceeds_contiguous_equivalent(pair):
    """``test_paged_capacity_exceeds_contiguous_equivalent``: 4 concurrent
    short requests in 12 pages, far below n_slots x max context."""
    prompts = ["one", "two", "three", "four"]
    jeng, teng = _engines(pair, 8, n_pages=13)
    ref = jeng.generate(prompts)
    tok = ByteTokenizer()
    for p in prompts:
        teng.submit([tok.bos_id] + tok.encode(p))
    teng._admit()  # the first tick's admission
    assert teng.stats()["slots_busy"] == 4
    out = teng.run()
    assert [tok.decode(out[i]) for i in range(4)] == ref


def test_automatic_prefix_reuse(pair):
    """``test_paged_automatic_prefix_reuse``: the second prompt's prefill
    starts at the shared-page boundary, and its output equals a cold
    engine's and the JAX engine's."""
    shared = "x" * 150
    jeng, teng = _engines(pair, 8)
    ref = [jeng.generate([shared + " tail one"])[0],
           jeng.generate([shared + " tail two"])[0]]
    calls = _spy_prefills(teng)
    out1 = teng.generate([shared + " tail one"])[0]
    assert calls[0][0] == 0
    calls.clear()
    out2 = teng.generate([shared + " tail two"])[0]
    assert len(calls) == 1
    d, s = calls[0]
    assert d >= 144 and s < 20, (d, s)
    assert [out1, out2] == ref
    assert teng.stats()["prefix_cache"]["hit_tokens"] == d
    _, cold = _engines(pair, 8)
    assert cold.generate([shared + " tail two"])[0] == out2


def test_generated_pages_reused_across_turns(pair):
    """``test_generated_pages_reused_across_turns``: turn 2's prompt embeds
    turn 1's prompt and output; reuse reaches into the generated pages."""
    tok = ByteTokenizer()
    jeng, teng = _engines(pair, 32)
    turn1 = [1] + tok.encode("u" * 60)
    outs = []
    for eng in (jeng, teng):
        rid = eng.submit(turn1)
        outs.append(eng.run()[rid])
    assert outs[0] == outs[1] and len(outs[1]) >= 4
    history = turn1 + outs[1]
    turn2 = history + tok.encode(" next question")
    calls = _spy_prefills(teng)
    outs2 = []
    for eng in (jeng, teng):
        rid = eng.submit(turn2)
        outs2.append(eng.run()[rid])
    assert outs2[0] == outs2[1]
    d, _ = calls[0]
    ps = teng.page_size
    assert d >= (len(history) - 1) // ps * ps - ps, (d, len(history))
    assert d > (len(turn1) // ps) * ps - 1, (d, len(turn1))
    _, cold = _engines(pair, 32)
    rid = cold.submit(turn2)
    assert cold.run()[rid] == outs2[1]


def test_cancel_frees_pages(pair):
    """``test_paged_cancel_frees_pages``, with the JAX engine's page counts
    after the same operations."""
    counts = []
    for eng in _engines(pair, 64):
        free0 = eng.allocator.n_free
        rid = eng.submit([1] + list(range(5, 40)))
        eng.step()
        assert eng.allocator.n_free < free0
        assert eng.cancel(rid)
        assert eng.allocator.n_free + eng.allocator.n_evictable == free0
        assert eng.pending == 0
        counts.append((eng.allocator.n_free, eng.allocator.n_evictable))
    assert counts[0] == counts[1]


def test_sampled_seed_reproducible_solo_and_mixed(pair):
    """``test_paged_sampled_seed_reproducible``: a seeded sampled request
    gives the same tokens alone and beside other requests (greedy and
    sampled, with their own seeds)."""
    _, teng = _engines(pair, 16)
    kw = dict(max_new_tokens=16, temperature=0.9, top_p=0.9, seed=123)
    tok = ByteTokenizer()
    rid = teng.submit([tok.bos_id] + tok.encode("hello"), **kw)
    solo = teng.run()[rid]
    _, mixed = _engines(pair, 16)
    ids = [mixed.submit([tok.bos_id] + tok.encode("aaa"), temperature=0.7, seed=5),
           mixed.submit([tok.bos_id] + tok.encode("hello"), **kw),
           mixed.submit([tok.bos_id] + tok.encode("zzzz"))]
    out = mixed.run()
    assert out[ids[1]] == solo
    _, other = _engines(pair, 16)
    rid = other.submit([tok.bos_id] + tok.encode("hello"), **{**kw, "seed": 124})
    assert other.run()[rid] != solo


@pytest.mark.parametrize("top_k", [0, 7])
def test_per_row_shaping_matches_jax(top_k):
    """Per-row temperature (greedy rows clamp to 1e-6) and per-row top-p:
    the same kept tokens and shaped values as JAX's ``shaped_logits``."""
    logits = np.random.default_rng(6).standard_normal((4, 300)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_p = np.array([0.9, 1.0, 0.5, 0.95], np.float32)
    ref = np.asarray(jsampling.shaped_logits(jnp.asarray(logits), jnp.asarray(temps),
                                             top_k=top_k, top_p=jnp.asarray(top_p)))
    out = sampling.shaped_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                                 top_k=top_k, top_p=torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    keep = np.isfinite(ref)
    np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-6)


def test_per_row_sampling_greedy_rows_and_distribution():
    """Rows with temperature <= 0 take the argmax whatever their uniforms;
    a sampled row follows softmax(logits / T) (20k draws, 0.02)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1e9]]).expand(20000, 4)
    temps = torch.ones(20000)
    temps[:10] = 0.0
    g = torch.Generator().manual_seed(0)
    u = sampling.row_uniforms([g] * 20000, (4,), "cpu")
    draws = sampling.sample_logits(logits, None, temperature=temps, uniforms=u)
    assert bool((draws[:10] == 0).all())
    freq = torch.bincount(draws[10:], minlength=4).float() / (20000 - 10)
    assert torch.all((freq - torch.softmax(logits[0], 0)).abs() < 0.02)
    assert freq[3] == 0


def test_queue_order_limits_and_validation(pair):
    _, teng = _engines(pair, 8, max_queue=3)
    low = teng.submit([1, 5, 6], slo_class="best_effort")
    mid = teng.submit([1, 5, 7], slo_class="batch")
    high = teng.submit([1, 5, 8])
    assert [r.req_id for r in teng._queue] == [high, mid, low]
    with pytest.raises(QueueFullError):
        teng.submit([1, 5, 9])
    assert teng.cancel(low)
    with pytest.raises(BadRequestError, match="exceeds"):
        teng.submit([1] * 250, max_new_tokens=20)
    with pytest.raises(BadRequestError, match="slo_class"):
        teng.submit([1, 2], slo_class="urgent")
    with pytest.raises(BadRequestError, match="int32"):
        teng.submit([1, 2], seed=2**31)
    _, small = _engines(pair, 64, n_pages=4)
    with pytest.raises(BadRequestError, match="pages"):
        small.submit([1] + list(range(5, 100)))


@pytest.mark.parametrize("kw", [
    {"anomaly": object()}, {"usage": object()}, {"host_tier_mb": 1},
    {"pipeline_ticks": True}, {"mesh": object()}, {"usage_ledger": object()},
])
def test_unported_engine_features_raise(pair, kw):
    _, _, cfg, tparams = pair
    kw = {"cache_mode": "paged", **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousEngine(tparams, cfg, ByteTokenizer(), device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    {"adapter_id": 1}, {"tenant": "anonymous"}, {"tenant": "t"},
])
def test_unported_request_features_raise(pair, kw):
    _, teng = _engines(pair, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.submit([1, 5, 6], **kw)
    for call in (teng.export_kv, teng.import_kv):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call([1, 2])


def test_take_result_and_queue_full(pair):
    """``take_result`` pops a finished request's tokens once (None while in
    flight); ``ThreadedEngine.queue_full`` reads the engine's queue cap."""
    jeng, teng = _engines(pair, 8, max_queue=1)
    rids = [eng.submit([1, 5, 6]) for eng in (jeng, teng)]
    assert teng.take_result(rids[1]) is None
    while teng.pending:
        teng.step()
    ref = jeng.run()[rids[0]]
    assert teng.take_result(rids[1]) == ref
    assert teng.take_result(rids[1]) is None
    threaded = ThreadedEngine(teng)
    threaded.close()  # the driver has stopped: the queue below stays put
    assert not threaded.queue_full
    teng.submit([1, 5, 7])
    assert threaded.queue_full


def test_engine_needs_explicit_cpu_without_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, cfg, tparams = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged")


def test_threaded_engine_concurrent_submitters(pair):
    """More submitting threads than cores, with a short switch interval,
    against the driver thread's admissions: every request completes exactly
    once, with its solo greedy tokens, under a unique id."""
    import os
    import sys
    import threading

    _, _, cfg, tparams = pair

    def engine():
        return ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged",
                                n_slots=2, decode_chunk=4, page_size=16,
                                gen=GenerateConfig(max_new_tokens=4), device="cpu")

    prompts = [[1] + list(range(5 + i, 12 + 3 * i)) for i in range(3)]
    solo = engine()
    ids = [solo.submit(p) for p in prompts]
    res = solo.run()
    expected = {tuple(p): res[i] for p, i in zip(prompts, ids)}
    classes = ["interactive", "batch", "best_effort"]
    eng = engine()
    threaded = ThreadedEngine(eng)
    n_threads = 2 * (os.cpu_count() or 4)
    results, errors = [], []

    def worker(i):
        try:
            for j in range(2):
                k = (i + j) % 3
                out = threaded.generate_one(prompts[k], slo_class=classes[k])
                results.append((k, out))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        threaded.close()
    assert not errors, errors
    assert len(results) == 2 * n_threads and eng._next_id == 2 * n_threads
    assert all(out == expected[tuple(prompts[k])] for k, out in results)
    assert eng.pending == 0 and not threaded._thread.is_alive()
