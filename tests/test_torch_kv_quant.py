"""Port parity for int8 KV caches (``kv_cache_dtype="int8"``) against the JAX
package, on the same numpy inputs and weights.

- ``infer/cache.py``: ``_quantize``, ``write_kv`` and ``read_kv`` bit for bit
  (zero rows included: scale 1.0, values 0).
- The cached forward over an int8 cache against the JAX int8 cached forward:
  f32 logits at 1e-4, the forward parity tests' tolerance (the same
  quantized values; the scales factor out of the products in both).
- Greedy tokens: the lock-step ``Generator`` over an int8 cache, and the
  continuous engine over int8 page pools, identical to the JAX package's
  engines with int8 caches, in ``tests/test_paged.py``'s scenario;
  deterministic across two engines; a prompt sharing a cached prefix
  prefills only its suffix (the reference's ``test_paged.py`` int8 case).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import cache as jcache  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JaxContinuousEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import cache  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models import llama  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=256,
            dtype="float32", param_dtype="float32", kv_cache_dtype="int8")


def _chunk(seed: int, shape=(2, 8, 2, 16), zero_rows=True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(0.01, 5, size=shape[:-1] + (1,))
         ).astype(np.float32)
    if zero_rows:
        x[0, 1] = 0.0  # every head of one position
        x[1, 3, 1] = 0.0  # one head
    return x


def test_quantize_matches_jax_bitwise():
    x = _chunk(0)
    jq, js = jcache._quantize(jnp.asarray(x))
    tq, ts = cache._quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(ts.numpy()[0, 1] == 1.0) and np.all(tq.numpy()[0, 1] == 0)


@pytest.mark.parametrize("read_dtype", ["float32", "bfloat16"])
def test_write_and_read_kv_match_jax_bitwise(read_dtype):
    """Two writes at scalar slots (the lock-step engine's prefill, then a
    decode step) into a fresh int8 cache, then the dequantized read."""
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    jlayer = jax.tree.map(lambda c: c[0], jcache.init_cache(jcfg, 2, 12))
    tlayer = {k: c[0] for k, c in cache.init_cache(cfg, 2, 12, "cpu").items()}
    assert {k: tuple(v.shape) for k, v in tlayer.items()} == {
        k: tuple(v.shape) for k, v in jlayer.items()}
    assert (tlayer["v"].dtype, tlayer["v_scale"].dtype) == (torch.int8, torch.float32)
    step = (2, 1, 2, 16)
    for idx, (kx, vx) in ((0, (_chunk(1), _chunk(2))),
                          (8, (_chunk(3, step, False), _chunk(4, step, False)))):
        jlayer = jcache.write_kv(jlayer, jnp.asarray(kx), jnp.asarray(vx), jnp.int32(idx))
        tlayer = cache.write_kv(tlayer, torch.from_numpy(kx), torch.from_numpy(vx), idx)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tlayer[name].numpy(), np.asarray(jlayer[name]),
                                      err_msg=name)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[read_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[read_dtype]
    for got, want in zip(cache.read_kv(tlayer, tdt), jcache.read_kv(jlayer, jdt)):
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_unknown_kv_cache_dtype_raises():
    for make in (lambda c: cache.init_cache(c, 1, 8, "cpu"),
                 lambda c: llama.forward({}, torch.zeros((1, 4), dtype=torch.long), c)):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            make(ModelConfig(**{**TINY, "kv_cache_dtype": "fp8"}))


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    tree = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    return jcfg, tree, cfg, params_from_jax(tree, cfg, "cpu")


def test_cached_forward_matches_jax(pair):
    """A prefill of 12 positions into an int8 cache (masked cached forward),
    then one decode step that reads the quantized cache back."""
    jcfg, tree, cfg, params = pair
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 500, size=(2, 13)).astype(np.int32)
    pos = np.arange(16)
    mask = np.broadcast_to(pos[None, None, :] <= pos[None, :12, None], (2, 12, 16))
    jc = jcache.init_cache(jcfg, 2, 16)
    jl, jc = jllama.forward(tree, jnp.asarray(ids[:, :12]), jcfg, cache=jc,
                            cache_index=jnp.int32(0), attn_mask=jnp.asarray(mask))
    tc = cache.init_cache(cfg, 2, 16, "cpu")
    tl = llama.forward(params, torch.from_numpy(ids[:, :12]).long(), cfg, cache=tc,
                       cache_index=0, attn_mask=torch.from_numpy(mask.copy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    step_mask = (pos <= 12)[None, None, :].repeat(2, 0)
    jl, jc = jllama.forward(tree, jnp.asarray(ids[:, 12:]), jcfg, cache=jc,
                           cache_index=jnp.int32(12), attn_mask=jnp.asarray(step_mask),
                           positions=jnp.full((2, 1), 12, jnp.int32))
    tl = llama.forward(params, torch.from_numpy(ids[:, 12:]).long(), cfg, cache=tc,
                       cache_index=12, attn_mask=torch.from_numpy(step_mask.copy()),
                       positions=torch.full((2, 1), 12))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))


PROMPTS = ["hello world", "the quick brown fox", "a",
           "some longer prompt with more text to cross pages"]


def test_lockstep_generator_int8_cache_greedy_matches_jax(pair):
    jcfg, tree, cfg, params = pair
    ref = JaxGenerator(tree, jcfg, JaxByteTokenizer()).generate(
        PROMPTS, JaxGenerateConfig(max_new_tokens=24))
    tok = ByteTokenizer()
    out = Generator(params, cfg, tok, device="cpu").generate_tokens(
        [[tok.bos_id] + tok.encode(p) for p in PROMPTS], GenerateConfig(max_new_tokens=24))
    assert [tok.decode(o) for o in out] == ref


def _paged(params, cfg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_chunk", 8)
    kw.setdefault("page_size", 16)
    return ContinuousEngine(params, cfg, ByteTokenizer(), cache_mode="paged",
                            device="cpu", **kw)


def test_paged_int8_pools_greedy_match_jax_and_are_deterministic(pair):
    jcfg, tree, cfg, params = pair
    ref = JaxContinuousEngine(tree, jcfg, JaxByteTokenizer(), n_slots=4, decode_chunk=8,
                              page_size=16, cache_mode="paged",
                              gen=JaxGenerateConfig(max_new_tokens=24)).generate(PROMPTS)
    eng = _paged(params, cfg, gen=GenerateConfig(max_new_tokens=24))
    assert eng.cache["kp"].dtype == torch.int8 and eng.cache["ks"].shape == (2, 65, 2, 1, 16)
    assert eng.generate(PROMPTS) == ref
    assert _paged(params, cfg, gen=GenerateConfig(max_new_tokens=24)).generate(PROMPTS) == ref
    # page bytes: int8 values plus one f32 scale per (layer, K or V, head, position)
    assert eng.page_bytes == 2 * 2 * 2 * 16 * (16 + 4)


def test_paged_int8_pools_reuse_a_quantized_prefix(pair):
    """A prompt whose leading pages are cached prefills only its suffix,
    over the dequantized shared pages, and decodes the JAX engine's
    tokens."""
    jcfg, tree, cfg, params = pair
    shared = "q" * 100
    prompts = [shared + " one", shared + " two"]
    jeng = JaxContinuousEngine(tree, jcfg, JaxByteTokenizer(), n_slots=4, decode_chunk=8,
                               page_size=16, cache_mode="paged",
                               gen=JaxGenerateConfig(max_new_tokens=8))
    ref = [jeng.generate([p])[0] for p in prompts]
    eng = _paged(params, cfg, gen=GenerateConfig(max_new_tokens=8))
    assert eng.generate(prompts[:1]) == ref[:1]
    calls = []
    orig = eng._paged_prefill_chunk

    def spy(req, slot, d, s, generator):
        calls.append((d, s))
        return orig(req, slot, d, s, generator)

    eng._paged_prefill_chunk = spy
    assert eng.generate(prompts[1:]) == ref[1:]
    assert calls and calls[0][0] >= 96  # suffix-only prefill
    assert eng.stats()["prefix_cache"]["hit_tokens"] >= 96
