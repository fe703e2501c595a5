"""Port parity for the flash-attention backward: the plain PyTorch version of
K2a/K2b (``flash_attention_bwd_plain``) and the autograd path through the
port's ``flash_attention`` against ``jax.vjp`` of the JAX package's
``flash_attention`` with its Pallas kernels in interpret mode.

Shapes keep S=256, head_dim 64 and 128-blocks so that the JAX side really
runs ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` over 2 x 2 tiles
(its ``supports()`` sends smaller shapes to XLA attention). Tolerances,
relative to each gradient's largest magnitude: f32 at 1e-4 (the same
formulas, whole-tensor here and tiled there, summed in other orders); bf16
at 2e-2 (both round the outputs to bf16, and the port recomputes delta from
its own forward's bf16 ``o``, which can sit a bf16 ulp from the kernel's);
float16 at 4e-3, the same reasons with three more mantissa bits (2e-2 / 8,
rounded up to a power of two's worth of headroom).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.ops import flash_attention as jfa  # noqa: E402
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}
LAYOUTS = {  # name: (heads, kv heads, packed segments)
    "gqa": (8, 2, False),
    "gqa-packed": (8, 2, True),
    "mha-packed": (4, 4, True),
}


def _inputs(seed, b, s, h, kv, d, packed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32) for _ in range(2))
    seg = None
    if packed:  # three documents per row at uneven cuts, then right padding
        seg = np.ones((b, s), np.int32)
        for row in range(b):
            seg[row, 70 + 9 * row:] = 2
            seg[row, 190 - 13 * row:] = 3
            seg[row, s - 11:] = 0
    return q, k, v, do, seg


def _jax_grads(q, k, v, do, seg, causal, dtype):
    def f(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_, causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg),
            block_q=128, block_kv=128, interpret=True)

    args = [jnp.asarray(x, dtype=dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype=dtype))]


def _close(got, want, tol, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * scale,
                               err_msg=name)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_plain_backward_and_autograd_match_jax_kernels(dtype, causal, layout):
    h, kv, packed = LAYOUTS[layout]
    q, k, v, do, seg = _inputs(len(layout) + causal, 2, 256, h, kv, 64, packed)
    want = _jax_grads(q, k, v, do, seg, causal, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)

    # The plain backward from the plain forward's o and lse.
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal, segment_ids=tseg)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                        segment_ids=tseg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        _close(g, w, TOL[dtype], name)

    # torch.autograd through the port's flash_attention (CPU: plain versions).
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    tfa.reset_launches()
    out = tfa.flash_attention(*leaves, causal=causal, segment_ids=tseg)
    grads = torch.autograd.grad(out, leaves, grad_outputs=tdo)
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == (0, 0, 0)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(g, w, TOL[dtype], name)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    q, k, v, do, seg = _inputs(3, 1, 100, 4, 2, 48, False)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    tfa.reset_launches()
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=True)
    want = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=True)
    assert (tfa.launches_dq, tfa.launches_dkv) == (0, 0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_backward_wrapper_rejects_bad_inputs():
    q, k, v, do, _ = _inputs(4, 1, 32, 4, 2, 16, False)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv)
    with pytest.raises(ValueError, match="like q"):
        tfa.flash_attention_bwd(tq, tk, tv, o[:, :16], lse, tdo)
    with pytest.raises(ValueError, match=r"\(B, H, Sq\)"):
        tfa.flash_attention_bwd(tq, tk, tv, o, lse[:, :2], tdo)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention_bwd(tq[:, :, :3], tk, tv, o[:, :, :3], lse[:, :3], tdo[:, :, :3])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd(*(x.to("meta") for x in (tq, tk, tv, o, lse, tdo)))


# ---------------------------------------------------------------------------
# The backward kernels' tile skipping (``tile_schedule`` at their tilings)
# ---------------------------------------------------------------------------

from test_torch_flash_attention import _admitted, _expand, _schedule_ids  # noqa: E402

# (block_q, block_kv) of each kernel at head_dim 64: K2a walks K1's tiles
# (BWD_DQ_BLOCK_Q rows, fwd_block_kv keys), K2b BWD_DKV_BLOCK_Q rows against
# its bwd_dkv_block_kv keys; K2a-f32 and K2b-f32 take square tiles of
# f32_bwd_block(head_dim) at every head dim (64 at D = 64 and 128, 32 at D =
# 256; K2b-f32 reads the map by columns).
BWD_TILINGS = {
    "dq": (tfa.BWD_DQ_BLOCK_Q, tfa.fwd_block_kv(64)),
    "dkv": (tfa.BWD_DKV_BLOCK_Q, tfa.bwd_dkv_block_kv(64)),
    "f32_d64_d128": (tfa.f32_bwd_block(64), tfa.f32_bwd_block(128)),
    "f32_d256": (tfa.f32_bwd_block(256), tfa.f32_bwd_block(256)),
}


def _plain_bwd_on_schedule(q, k, v, o, lse, do, causal, seg, block_q, block_kv):
    """``flash_attention_bwd_plain``'s arithmetic with every pair outside the
    visited tiles masked as well: (dq, dk, dv)."""
    b, s_q, h, d = q.shape
    s_kv, kv_heads = k.shape[1], k.shape[2]
    groups = h // kv_heads
    scale = d**-0.5
    visit = tfa.tile_schedule(seg, causal, s_q, s_kv, block_q, block_kv)
    mask = torch.from_numpy(_expand(visit.numpy(), block_q, block_kv, s_q, s_kv))
    mask = mask & torch.from_numpy(_admitted(None if seg is None else seg.numpy(),
                                             causal, s_q, s_kv))
    qs = q.float().reshape(b, s_q, kv_heads, groups, d) * scale
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, s_q, kv_heads, groups, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, kf)
    s = s.masked_fill(~mask[:, None, None], tfa.NEG_INF)
    p = torch.exp(s - lse.float().reshape(b, kv_heads, groups, s_q)[..., None])
    delta = (dof * o.float().reshape(b, s_q, kv_heads, groups, d)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = scale * torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qs)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dq.reshape(b, s_q, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _schedule_case(kind, dtype):
    """Inputs with ``kind`` ids (B=2, S=256, 4/2 heads, D=64) and the JAX
    package's gradients for them, computed once per (kind, dtype)."""
    q, k, v, do, _ = _inputs(11, 2, 256, 4, 2, 64, False)
    seg = _schedule_ids(kind, 2, 256, seed=5)
    return (q, k, v, do, seg), _jax_grads(q, k, v, do, seg, True, dtype)


@pytest.mark.parametrize("kernel", sorted(BWD_TILINGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["sorted", "padded", "nonmono", "mid"])
def test_schedule_masked_plain_backward_matches_jax_kernels(kind, dtype, kernel):
    """Masking everything outside K2a's or K2b's visited tiles changes no
    gradient: the result equals the plain backward and ``jax.vjp`` of the
    JAX package's kernels in interpret mode, at this file's tolerances."""
    (q, k, v, do, seg), want = _schedule_case(kind, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=True, segment_ids=tseg)
    got = _plain_bwd_on_schedule(tq, tk, tv, o, lse, tdo, True, tseg, *BWD_TILINGS[kernel])
    plain = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=True,
                                          segment_ids=tseg)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        _close(g, p.float().numpy(), TOL[dtype], name)
        _close(g, w, TOL[dtype], name)


@pytest.mark.parametrize("kernel", sorted(BWD_TILINGS))
def test_training_batch_backward_visits_under_half_the_causal_tiles(kernel):
    """The training pipeline's first batch (packed documents): K2a's and
    K2b's tilings at D = 128, and the f32 backward's, visit fewer than half
    of the causal tiles."""
    from ditl_tpu_torch.config import DataConfig
    from ditl_tpu_torch.data.dataset import synthetic_dataset
    from ditl_tpu_torch.data.loader import DataPipeline
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer

    cfg = DataConfig(batch_size=4, seq_len=2048, synthetic=True)
    pipe = DataPipeline(synthetic_dataset(cfg.synthetic_examples, cfg.seed),
                        ByteTokenizer(), cfg, "cpu")
    seg = torch.from_numpy(next(pipe._host_batches(0))["segment_ids"])
    blocks = {"dq": (tfa.BWD_DQ_BLOCK_Q, tfa.fwd_block_kv(128)),
              "dkv": (tfa.BWD_DKV_BLOCK_Q, tfa.bwd_dkv_block_kv(128))}.get(
                  kernel, BWD_TILINGS[kernel])
    visit = tfa.tile_schedule(seg, True, 2048, 2048, *blocks)
    causal = 4 * int(tfa.tile_schedule(None, True, 2048, 2048, *blocks).sum())
    assert int(seg.max()) >= 2 and int(visit.sum()) < causal / 2, (int(visit.sum()), causal)
    admitted = _admitted(seg.numpy(), True, 2048, 2048)
    assert not (admitted & ~_expand(visit.numpy(), *blocks, 2048, 2048)).any()
