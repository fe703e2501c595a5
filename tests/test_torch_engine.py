"""Port parity: the port's lock-step ``Generator`` against the JAX package's
on the same weights.

Greedy tokens must be identical (f32 compute, so argmax ties cannot flip on
rounding). Logprobs agree to 1e-4 (f32 log-softmax of the same logits).
Sampled paths cannot match draw for draw (PyTorch's generator is not JAX's
threefry): they are held by per-seed reproducibility inside the port, and the
top-k/top-p masks are compared with JAX's exactly on the same logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer import sampling as jsampling  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import sampling  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
            dtype="float32")
PROMPTS = [
    [1, 40, 41, 42, 43],
    [1] + list(range(60, 80)),  # crosses the 16-token bucket
    [1, 99],
]


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    return jcfg, params, cfg, tparams


def _generators(pair, eos_id=None):
    jcfg, params, cfg, tparams = pair
    jtok, ttok = JaxByteTokenizer(), ByteTokenizer()
    if eos_id is not None:
        jtok.eos_id = ttok.eos_id = eos_id
    return (JaxGenerator(params, jcfg, jtok),
            Generator(tparams, cfg, ttok, device="cpu"))


def test_greedy_tokens_identical_to_jax(pair):
    jgen, gen = _generators(pair)
    ref = jgen.generate_tokens(PROMPTS, JaxGenerateConfig(max_new_tokens=12))
    out = gen.generate_tokens(PROMPTS, GenerateConfig(max_new_tokens=12))
    assert out == ref
    assert all(len(r) == 12 for r in ref)


def test_greedy_eos_stop_identical_to_jax(pair):
    """Make the 4th greedy token of prompt 0 the EOS id: both engines stop
    that row there and keep decoding the others."""
    jgen, _ = _generators(pair)
    free = jgen.generate_tokens(PROMPTS, JaxGenerateConfig(max_new_tokens=10))
    eos = free[0][3]
    jgen, gen = _generators(pair, eos_id=eos)
    ref = jgen.generate_tokens(PROMPTS, JaxGenerateConfig(max_new_tokens=10))
    out = gen.generate_tokens(PROMPTS, GenerateConfig(max_new_tokens=10))
    assert out == ref
    assert ref[0] == free[0][:3]


def test_logprobs_match_jax(pair):
    jgen, gen = _generators(pair)
    ref_toks, ref_lp = jgen.generate_tokens_with_logprobs(
        PROMPTS, JaxGenerateConfig(max_new_tokens=6, logprobs=3))
    toks, lp = gen.generate_tokens_with_logprobs(
        PROMPTS, GenerateConfig(max_new_tokens=6, logprobs=3))
    assert toks == ref_toks
    for a, b in zip(lp, ref_lp):
        assert a["top_ids"] == b["top_ids"]
        np.testing.assert_allclose(a["token_logprobs"], b["token_logprobs"],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(a["top_logprobs"], b["top_logprobs"],
                                   atol=1e-4, rtol=1e-4)


def test_sampled_generation_reproducible_per_seed(pair):
    _, gen = _generators(pair)
    g = GenerateConfig(max_new_tokens=10, temperature=1.0, top_k=50, top_p=0.9, seed=7)
    a = gen.generate_tokens(PROMPTS, g)
    b = gen.generate_tokens(PROMPTS, g)
    c = gen.generate_tokens(PROMPTS, GenerateConfig(max_new_tokens=10, temperature=1.0,
                                                    top_k=50, top_p=0.9, seed=8))
    assert a == b
    assert a != c


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (20, 0.5)])
def test_top_k_top_p_masks_match_jax(top_k, top_p):
    logits = np.random.default_rng(3).standard_normal((4, 300)).astype(np.float32) * 3
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if top_k:
        jl = jsampling._apply_top_k(jl, top_k)
        tl = sampling.apply_top_k(tl, top_k)
    if top_p < 1.0:
        jl = jsampling._apply_top_p(jl, top_p)
        tl = sampling.apply_top_p(tl, top_p)
    np.testing.assert_array_equal(np.isfinite(np.asarray(jl)), torch.isfinite(tl).numpy())


def test_per_row_top_p_mask_matches_jax():
    logits = np.random.default_rng(4).standard_normal((3, 200)).astype(np.float32)
    p = np.array([0.3, 1.0, 0.95], np.float32)
    ref = jsampling._apply_top_p(jnp.asarray(logits), jnp.asarray(p))
    out = sampling.apply_top_p(torch.from_numpy(logits), torch.from_numpy(p))
    np.testing.assert_array_equal(np.isfinite(np.asarray(ref)), torch.isfinite(out).numpy())
    assert bool(torch.isfinite(out[1]).all())


def test_sample_logits_greedy_and_distribution():
    """temperature 0 is argmax; a sampled draw follows softmax(logits/T) —
    3 classes, 20k draws, each frequency within 0.02 of its probability."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1e9]])
    assert sampling.sample_logits(logits, None, temperature=0.0).item() == 0
    g = torch.Generator().manual_seed(0)
    draws = sampling.sample_logits(logits.expand(20000, 4), g, temperature=1.0)
    freq = torch.bincount(draws, minlength=4).float() / 20000
    want = torch.softmax(logits[0], 0)
    assert torch.all((freq - want).abs() < 0.02)
    assert freq[3] == 0


def test_generator_needs_explicit_cpu_without_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, cfg, tparams = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(tparams, cfg, ByteTokenizer())
