"""Port parity: ``ditl_tpu_torch.models.llama.forward`` against the JAX
package's ``llama.forward`` on the same weights (bridged by
``params_from_jax``) and the same token ids.

Tolerances: f32 logits at 1e-4 (same arithmetic, different summation order);
bf16 compute at 2e-2 of the logits' scale (both sides round every activation
to bf16, at slightly different places, through two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.infer.cache import init_cache as jax_init_cache  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.infer.cache import init_cache  # noqa: E402
from ditl_tpu_torch.models import llama  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128)
LAYOUTS = {
    "unfused": {},
    "fused_qkv": {"fused_qkv": True},
    "fused_gate_up": {"fused_gate_up": True},
    "qwen2_bias_tied": {"attention_bias": True, "tie_embeddings": True},
    "llama31_rope": {"rope_scaling_factor": 8.0,
                     "rope_scaling_original_max_len": 64, "rope_theta": 10000.0},
}


def _configs(**kw):
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _params(jcfg, seed=0):
    """JAX init, with random norm scales and biases so those paths matter."""
    params = jax.device_get(jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    for group in ("attn_norm", "mlp_norm"):
        scale = params["layers"][group]["scale"]
        params["layers"][group]["scale"] = (1 + 0.1 * rng.standard_normal(scale.shape)
                                            ).astype(np.float32)
    for name in ("bq", "bk", "bv"):
        if name in params["layers"]["attn"]:
            shape = params["layers"]["attn"][name].shape
            params["layers"]["attn"][name] = (0.1 * rng.standard_normal(shape)
                                              ).astype(np.float32)
    return params


def _ids(b, s, seed=1):
    return np.random.default_rng(seed).integers(3, 500, size=(b, s)).astype(np.int32)


def _assert_logits_close(out, ref, dtype):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    else:
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(out, ref, atol=2e-2 * scale, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_forward_logits_match_jax(layout, dtype):
    jcfg, cfg = _configs(**TINY, dtype=dtype, **LAYOUTS[layout])
    params = _params(jcfg)
    ids = _ids(2, 24)
    ref = jllama.forward(params, jnp.asarray(ids), jcfg)
    out = llama.forward(params_from_jax(params, cfg, "cpu"),
                        torch.from_numpy(ids).long(), cfg)
    assert out.dtype == torch.float32 and out.shape == (2, 24, 512)
    _assert_logits_close(out, ref, dtype)


def test_segment_ids_forward_matches_jax():
    jcfg, cfg = _configs(**TINY, dtype="float32")
    params = _params(jcfg)
    ids = _ids(2, 32)
    seg = np.ones((2, 32), np.int32)
    seg[:, 20:] = 2
    seg[1, 28:] = 0
    ref = jllama.forward(params, jnp.asarray(ids), jcfg, segment_ids=jnp.asarray(seg))
    out = llama.forward(params_from_jax(params, cfg, "cpu"),
                        torch.from_numpy(ids).long(), cfg,
                        segment_ids=torch.from_numpy(seg))
    _assert_logits_close(out, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_prefill_and_decode_step_match_jax(dtype):
    """``prefill_causal`` into an empty cache, then one masked decode step,
    the way the engine drives them; logits and cache contents agree."""
    jcfg, cfg = _configs(**TINY, dtype=dtype)
    params = _params(jcfg)
    tparams = params_from_jax(params, cfg, "cpu")
    b, plen, max_len = 2, 16, 24
    ids = _ids(b, plen)
    lengths = np.array([16, 9])
    seg = (np.arange(plen)[None] < lengths[:, None]).astype(np.int32)
    pos = np.tile(np.arange(plen), (b, 1)).astype(np.int32)
    jcache = jax_init_cache(jcfg, b, max_len)
    ref, jcache = jllama.forward(params, jnp.asarray(ids), jcfg,
                                 positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
                                 cache=jcache, cache_index=jnp.int32(0),
                                 prefill_causal=True)
    cache = init_cache(cfg, b, max_len, "cpu")
    out = llama.forward(tparams, torch.from_numpy(ids).long(), cfg,
                        positions=torch.from_numpy(pos).long(),
                        segment_ids=torch.from_numpy(seg), cache=cache,
                        cache_index=0, prefill_causal=True)
    _assert_logits_close(out, ref, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].float().numpy(),
                                   np.asarray(jcache[key], np.float32),
                                   atol=tol, rtol=tol)

    # One decode step: slot plen, RoPE position = length, mask = real
    # prompt slots plus the slot being written.
    nxt = np.array([[7], [11]], np.int32)
    slots = np.arange(max_len)
    mask = ((slots[None] < lengths[:, None])
            | ((slots[None] >= plen) & (slots[None] <= plen)))[:, None, :]
    ref, _ = jllama.forward(params, jnp.asarray(nxt), jcfg,
                            positions=jnp.asarray(lengths[:, None].astype(np.int32)),
                            cache=jcache, cache_index=jnp.int32(plen),
                            attn_mask=jnp.asarray(mask))
    out = llama.forward(tparams, torch.from_numpy(nxt).long(), cfg,
                        positions=torch.from_numpy(lengths[:, None]).long(),
                        cache=cache, cache_index=plen, attn_mask=torch.from_numpy(mask))
    _assert_logits_close(out, ref, dtype)


def test_flash_prefill_runs_jax_kernel_and_matches(monkeypatch):
    """head_dim 64 and S = 128: the JAX side's dispatch runs the Pallas
    ``_fwd_kernel`` (interpret mode); the port's ``flash`` impl runs its
    kernel's plain version on the CPU. f32, so 1e-4."""
    from ditl_tpu.ops import flash_attention as jfa

    kw = dict(TINY, num_heads=2, num_kv_heads=1, head_dim=64, max_seq_len=256,
              dtype="float32", attention_impl="flash")
    jcfg, cfg = _configs(**kw)
    assert jax.default_backend() != "tpu"
    calls = []
    real_fwd = jfa._fwd

    def spy(*args, **kwargs):
        calls.append(kwargs["interpret"])
        return real_fwd(*args, **kwargs)

    monkeypatch.setattr(jfa, "_fwd", spy)
    params = _params(jcfg)
    ids = _ids(1, 128)
    seg = np.ones((1, 128), np.int32)
    seg[:, 100:] = 0
    ref = jllama.forward(params, jnp.asarray(ids), jcfg, segment_ids=jnp.asarray(seg))
    assert calls and all(calls), "the JAX side did not run the Pallas kernel"
    out = llama.forward(params_from_jax(params, cfg, "cpu"),
                        torch.from_numpy(ids).long(), cfg,
                        segment_ids=torch.from_numpy(seg))
    _assert_logits_close(out, ref, "float32")
    xla = llama.forward(params_from_jax(params, cfg, "cpu"),
                        torch.from_numpy(ids).long(),
                        dataclasses.replace(cfg, attention_impl="xla"),
                        segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), xla.numpy(), atol=1e-4, rtol=1e-4)


def test_unported_features_raise():
    with pytest.raises(ValueError, match="ROADMAP"):
        ModelConfig(attention_impl="ring")
    for kw in ({"num_experts": 4}, {"lora_rank": 4}):
        cfg = ModelConfig(**TINY, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            llama.forward({}, torch.zeros((1, 4), dtype=torch.long), cfg)
    # int8 caches are ported; an unknown cache dtype raises ValueError, as
    # the JAX package's init_cache does.
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        llama.forward({}, torch.zeros((1, 4), dtype=torch.long),
                      ModelConfig(**TINY, kv_cache_dtype="fp8"))
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        init_cache(ModelConfig(**TINY, kv_cache_dtype="fp8"), 1, 8, "cpu")


def test_init_params_layout_matches_jax_tree():
    """The port's seed init has the JAX tree's structure and shapes (plus the
    f32 lm head), so both packages describe the same model."""
    for layout in ("unfused", "fused_qkv", "fused_gate_up", "qwen2_bias_tied"):
        jcfg, cfg = _configs(**TINY, **LAYOUTS[layout])
        jtree = jax.eval_shape(lambda: jllama.init_params(jax.random.key(0), jcfg))
        ours = llama.init_params(cfg, seed=0, device="cpu")
        flat_j = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
                  for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
        flat_t = {f"{a}/{b}": tuple(t.shape) for a, grp in ours.items()
                  for b, t in grp.items() if isinstance(t, torch.Tensor)}
        flat_t.update({f"layers/{g}/{k}": tuple(t.shape)
                       for g, grp in ours["layers"].items() for k, t in grp.items()})
        if cfg.tie_embeddings:
            assert flat_t.pop("lm_head/kernel") == (cfg.hidden_size, cfg.vocab_size)
        assert flat_t == flat_j
        assert ours["lm_head"]["kernel"].dtype == torch.float32
