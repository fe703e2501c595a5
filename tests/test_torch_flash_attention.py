"""Port parity: the flash-attention forward's plain PyTorch version against the
JAX package's Pallas kernel (interpret mode on the CPU), and the port's plain
attention against the JAX package's.

Shapes keep Sq >= 128 and head_dim 64 so that the JAX dispatch really runs
``_fwd_kernel`` (its ``supports()`` sends smaller shapes to XLA). Tolerances:
f32 at 1e-4 (the two sides sum in different orders and the kernel runs
blockwise with an online softmax); bf16 at 2e-2 (the kernel casts p to bf16
against its running max, the plain version against the final max, and the
outputs are rounded to bf16: a few bf16 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.ops import flash_attention as jfa  # noqa: E402
from ditl_tpu.ops.attention import _xla_attention as jax_xla_attention  # noqa: E402
from ditl_tpu_torch.ops import attention as tattn  # noqa: E402
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def _to_torch(x, dtype):
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))


def _to_jax(x, dtype):
    return jnp.asarray(x, dtype=dtype)


def _segments(kind, b, s):
    if kind is None:
        return None
    seg = np.ones((b, s), np.int32)
    if kind == "packed":  # two packed documents, then right padding
        seg[:, s // 2:] = 2
        seg[:, s - 16:] = 0
    else:  # "padded": per-row real lengths, pads segment 0
        for i in range(b):
            seg[i, s - 37 * (i + 1):] = 0
    return seg


def _jax_fwd(q, k, v, seg, causal):
    """The JAX package's ``_fwd`` (the function that launches the kernel) in
    interpret mode: returns (o (B,Sq,H,D), lse (B,H,Sq)) from the first
    lane."""
    b, s, h, d = q.shape
    blocks = jfa._pick_blocks(s, k.shape[1], 512, 512)
    o, lse = jfa._fwd(
        jnp.transpose(q, (0, 2, 1, 3)), jnp.transpose(k, (0, 2, 1, 3)),
        jnp.transpose(v, (0, 2, 1, 3)), seg, seg, causal=causal,
        scale=d**-0.5, blocks=blocks, interpret=True,
    )
    return np.asarray(jnp.transpose(o, (0, 2, 1, 3)), np.float32), np.asarray(lse[..., 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_plain_matches_jax_kernel(dtype, causal, groups):
    kv = 2
    q, k, v = _qkv(groups, 1, 128, kv * groups, kv, 64)
    ref = jfa.flash_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                              causal=causal, interpret=True)
    out = tfa.flash_attention(_to_torch(q, dtype), _to_torch(k, dtype),
                              _to_torch(v, dtype), causal=causal)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("segments", ["packed", "padded"])
def test_segment_ids_match_jax_kernel(dtype, segments):
    q, k, v = _qkv(7, 2, 256, 4, 2, 64)
    seg = _segments(segments, 2, 256)
    # 128-blocks: the JAX kernel runs 2 x 2 tiles, so its online softmax
    # carries across KV blocks and skips the block above the diagonal.
    ref = jfa.flash_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                              causal=True, segment_ids=jnp.asarray(seg),
                              block_q=128, block_kv=128, interpret=True)
    out = tfa.flash_attention(_to_torch(q, dtype), _to_torch(k, dtype),
                              _to_torch(v, dtype), causal=True,
                              segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_fwd(causal):
    q, k, v = _qkv(3, 2, 128, 4, 2, 64)
    seg = _segments("padded", 2, 128)
    o_ref, lse_ref = _jax_fwd(_to_jax(q, "float32"), _to_jax(k, "float32"),
                              _to_jax(v, "float32"), jnp.asarray(seg), causal)
    o, lse = tfa.flash_attention_plain(
        _to_torch(q, "float32"), _to_torch(k, "float32"), _to_torch(v, "float32"),
        causal=causal, segment_ids=torch.from_numpy(seg))
    assert lse.shape == (2, 4, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_attention_decode_mask_matches_jax(dtype):
    """The decode path: one query per row against a cache under an explicit
    (B, 1, Smax) validity mask, as the engine builds it."""
    b, smax, h, kv, d = 4, 48, 8, 2, 32
    q, _, _ = _qkv(11, b, 1, h, kv, d)
    _, k, v = _qkv(12, b, smax, h, kv, d)
    lengths = np.array([5, 17, 1, 30])
    slots = np.arange(smax)
    mask = ((slots[None] < lengths[:, None])
            | ((slots[None] >= 32) & (slots[None] <= 34)))[:, None, :]
    ref = jax_xla_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                            causal=False, segment_ids=None, mask=jnp.asarray(mask))
    out = tattn.dot_product_attention(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
        causal=False, mask=torch.from_numpy(mask), impl="flash")
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_xla_attention_causal_segments_matches_jax():
    q, k, v = _qkv(13, 2, 40, 4, 1, 16)
    seg = _segments("packed", 2, 40)
    ref = jax_xla_attention(_to_jax(q, "float32"), _to_jax(k, "float32"),
                            _to_jax(v, "float32"), causal=True,
                            segment_ids=jnp.asarray(seg))
    out = tattn.dot_product_attention(
        _to_torch(q, "float32"), _to_torch(k, "float32"), _to_torch(v, "float32"),
        causal=True, segment_ids=torch.from_numpy(seg), impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    q, k, v = (_to_torch(x, "bfloat16") for x in _qkv(5, 1, 100, 4, 2, 48))
    tfa.reset_launches()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_plain, lse_plain = tfa.flash_attention_plain(q, k, v, causal=True)
    assert tfa.launches == 0
    assert torch.equal(o, o_plain) and torch.equal(lse, lse_plain)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (_to_torch(x, "float32") for x in _qkv(6, 1, 32, 4, 2, 16))
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="segment_ids"):
        tfa.flash_attention(q, k, v, segment_ids=torch.ones(1, 31, dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention(q, k.bfloat16(), v)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tattn.dot_product_attention(q, k, v, impl=impl)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
