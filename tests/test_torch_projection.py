"""Port parity for the attention projections' hand-written backward (K6).

The port's ``ops/projection.projection`` (its backward's plain version on the
CPU) against ``jax.grad`` through the JAX package's ``ops/projection.
projection`` with ``bwd_impl="pallas"``, whose Pallas kernel runs in
interpret mode on the CPU, on the same numpy inputs. Every kernel-path
comparison first asserts that both packages' dispatch picks the kernel.

Tolerances: f32 at 1e-4 relative and 1e-5 absolute (the reference's own test
against autodiff); bf16 within 8e-3 of each gradient's largest magnitude,
one bf16 ulp (the same bf16 operands, f32 sums in another order, one
rounding each); float16 within 2e-3 of it, two float16 ulps.

K6's tile order (``k6_tile_order``, the plain list of what the kernel's
scheduler hands out) is checked for coverage and for the rule that the role
with the longer contraction goes first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.ops import projection as jproj  # noqa: E402
from ditl_tpu_torch.ops import projection as tproj  # noqa: E402

torch.set_num_threads(1)

BLOCKS = (64, 128)  # the reference test's blocks
HALF_TOL = {"bfloat16": 8e-3, "float16": 2e-3}  # of each gradient's largest magnitude


def _inputs(b, s, d, f, dtype, seed=0):
    """x, w and the upstream gradient g, as (jax arrays, torch tensors) of
    ``dtype`` holding the same values."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, d)), d**-0.5 * rng.standard_normal((d, f)),
              rng.standard_normal((b, s, f))]
    jx = [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
          for a in jx]
    return jx, tx


def _grads_jax(x, w, g, impl, blocks):
    """(dx, dw) of <projection(x, w), g> through the reference."""
    _, vjp = jax.vjp(lambda x, w: jproj.projection(x, w, bwd_impl=impl, blocks=blocks),
                     x, w)
    return vjp(g)


def _grads_port(x, w, g, impl, blocks):
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    tproj.projection(x, w, bwd_impl=impl, blocks=blocks).backward(g)
    return x.grad, w.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d,f", [(256, 256), (256, 128), (128, 384)])
def test_projection_grads_match_jax_kernel(dtype, d, f):
    b, s = 2, 32
    assert jproj.effective_bwd_impl("pallas", b, s, d, f, BLOCKS) == "pallas"
    assert tproj.effective_bwd_impl("pallas", b, s, d, f, BLOCKS) == "pallas"
    (jx, jw, jg), (tx, tw, tg) = _inputs(b, s, d, f, dtype)
    want = _grads_jax(jx, jw, jg, "pallas", BLOCKS)
    got = _grads_port(tx, tw, tg, "pallas", BLOCKS)
    for name, x, r in zip(("dx", "dw"), got, want):
        assert x.dtype == getattr(torch, dtype) and tuple(x.shape) == r.shape, name
        r = np.asarray(r.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(x.numpy(), r, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(x.float().numpy(), r, rtol=0,
                                       atol=HALF_TOL[dtype] * float(np.abs(r).max()),
                                       err_msg=name)


def test_projection_bwd_wrapper_matches_jax_kernel():
    """The wrapper itself (what K6 replaces) against the reference's Pallas
    backward, with the upstream gradient a column slice of a wider one (a
    fused projection's split), f32."""
    b, s, d, f = 2, 32, 256, 128
    (jx, jw, jg), (tx, tw, tg) = _inputs(b, s, d, f + 128, "float32", seed=1)
    want = jproj._pallas_bwd(jx, jw[:, :f], jg[..., :f], blocks=BLOCKS, interpret=True)
    tproj.reset_launches()
    got = tproj.projection_bwd(tx, tw[:, :f], tg[..., :f], blocks=BLOCKS)
    assert tproj.launches == 0  # CPU tensors: the plain version
    for name, x, r in zip(("dx", "dw"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_projection_falls_back_on_untileable_shapes():
    """D = 200 is not lane-tileable: both packages take the einsum backward,
    and ``"pallas"`` gives the ``"xla"`` gradients."""
    b, s, d, f = 2, 32, 200, 256
    assert jproj.effective_bwd_impl("pallas", b, s, d, f, BLOCKS) == "xla"
    assert tproj.effective_bwd_impl("pallas", b, s, d, f, BLOCKS) == "xla"
    (jx, jw, jg), (tx, tw, tg) = _inputs(b, s, d, f, "float32", seed=2)
    got = _grads_port(tx, tw, tg, "pallas", BLOCKS)
    plain = _grads_port(tx, tw, tg, "xla", BLOCKS)
    want = _grads_jax(jx, jw, jg, "pallas", BLOCKS)
    for x, p, r in zip(got, plain, want):
        assert torch.equal(x, p)
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="cannot tile"):
        tproj.projection_bwd(tx, tw, tg, blocks=BLOCKS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tproj.projection(tx, tw, bwd_impl="pallas", mesh=object())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_projection_forward_is_the_inline_product(dtype):
    _, (x, w, _) = _inputs(2, 16, 128, 256, dtype, seed=3)
    for impl in ("pallas", "xla"):
        assert torch.equal(tproj.projection(x, w, bwd_impl=impl, blocks=BLOCKS), x @ w)


# (N, D, F) of wq/wo and wk/wv at the training step (N = B*S = 4 x 2048), a
# ragged N with F an odd multiple of 128, and F > N (dx first).
K6_SHAPES = [(8192, 4096, 4096), (8192, 4096, 1024), (2064, 256, 384), (16, 384, 384)]


@pytest.mark.parametrize("n,d,f", K6_SHAPES)
@pytest.mark.parametrize("dx_first", [None, True, False])
def test_k6_tile_order_covers_every_output_tile_once(n, d, f, dx_first):
    order = tproj.k6_tile_order(n, d, f, dx_first)
    bm, bn = tproj.K5_BLOCK_M, tproj.K5_BLOCK_N
    for name, rows, cols, nk in (("dx", n, d, -(-f // 64)), ("dw", d, f, -(-n // 64))):
        tiles = [(r, c) for o, r, c, k in order if o == name]
        assert len(tiles) == len(set(tiles)), name
        assert set(tiles) == {(r, c) for r in range(0, rows, bm) for c in range(0, cols, bn)}
        assert {k for o, _, _, k in order if o == name} == {nk}, name


@pytest.mark.parametrize("n,d,f", K6_SHAPES)
def test_k6_tile_order_hands_out_the_longer_role_first(n, d, f):
    """By default every tile of the role with the longer contraction comes
    before any of the other: dw (over N) at wq/wo and wk/wv, where at wk/wv
    its 128 tiles of 128 k-tiles would otherwise be a ragged tail behind
    1024 dx tiles of 16."""
    order = tproj.k6_tile_order(n, d, f)
    roles = [o for o, _, _, _ in order]
    first = roles[0]
    assert roles == sorted(roles, key=lambda o: o != first)
    nk = {o: k for o, _, _, k in order}
    assert nk[first] == max(nk.values())
    assert tproj.k6_dx_first(n, f) == (first == "dx")
    if (n, d, f) == (8192, 4096, 1024):
        counts = {o: roles.count(o) for o in nk}
        assert (counts, nk) == ({"dw": 128, "dx": 1024}, {"dw": 128, "dx": 16})


def test_profile_tells_k5b_from_k6():
    """K5b and K6 launch two instances of one CUDA kernel, tagged 5 and 6:
    the training profile's categories keep them apart, demangled or not."""
    from ditl_tpu_torch.tools.profile_train import _category

    for tag, cat in ((5, "K5b mlp_dh_dwgu"), (6, "K6 proj_bwd")):
        assert _category(f"void (anonymous namespace)::sm90::proj_bwd_kernel<{tag}>("
                         "(anonymous namespace)::sm90::ProjMaps, "
                         "(anonymous namespace)::sm90::ProjArgs)") == cat
        assert _category(f"_ZN50_GLOBAL__N__cb170ab1_17_projection_bwd_cu_781a32314sm90"
                         f"15proj_bwd_kernelILi{tag}EEEvNS0_8ProjMapsENS0_8ProjArgsE") == cat
    assert _category("mlp_dgu_dwdown_kernel") == "K5a mlp_dgu_dwdown"
