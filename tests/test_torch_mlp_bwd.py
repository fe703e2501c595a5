"""Port parity for the MLP block's hand-written backward (K5a/K5b) and for
the model's loss gradients with the three backward flags.

The port's ``ops/mlp_bwd.fused_mlp_bwd`` (its plain version on the CPU),
``ops/mlp.mlp_gu`` and ``train/step.loss_fn`` against the JAX package's
``ops/mlp_bwd.fused_mlp_bwd``, ``ops/mlp.mlp_gu`` and ``train/step.loss_fn``,
whose Pallas kernels run in interpret mode on the CPU, as
``tests/test_bwd_kernels.py`` runs them. Inputs are made with numpy from a
seed. Every comparison of a kernel path first asserts that both packages'
dispatch picks it (``supports`` and ``effective_bwd_impl``), so no test
compares the einsum spelling with itself.

Tolerances:
- f32: 1e-5 relative and absolute on the kernel's outputs (the reference's
  own test of its kernels against the einsum backward), 1e-4 on gradients
  through the ops and through the model (other summation orders);
- bf16: each output within 8e-3 of its largest magnitude, one bf16 ulp:
  both sides round ``dgate``, ``dup`` and ``inner`` to bf16 at the same
  places, so only the order of the f32 sums differs, which can move a
  rounding by one ulp;
- float16: the same within 2e-3 of the largest magnitude, two float16 ulps
  (float16 keeps three more mantissa bits than bf16).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.ops import mlp as jmlp  # noqa: E402
from ditl_tpu.ops import mlp_bwd as jmlp_bwd  # noqa: E402
from ditl_tpu.ops import projection as jproj  # noqa: E402
from ditl_tpu.train import step as jstep  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.models import llama  # noqa: E402
from ditl_tpu_torch.models.convert import params_to_numpy, train_params_from_jax  # noqa: E402
from ditl_tpu_torch.ops import mlp as tmlp  # noqa: E402
from ditl_tpu_torch.ops import mlp_bwd as tmlp_bwd  # noqa: E402
from ditl_tpu_torch.ops import projection as tproj  # noqa: E402
from ditl_tpu_torch.train import state as tstate  # noqa: E402
from ditl_tpu_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

MLP_BLOCKS = (64, 128, 128)  # the reference test's blocks
BF16_ULP = 8e-3
F16_ULP = 2e-3
HALF_TOL = {"bfloat16": BF16_ULP, "float16": F16_ULP}  # the 2-byte dtypes' tolerances


def _identity(t):
    return t


def _inputs(b, s, d, f, seed=0):
    """h, w_gu, w_down, g and the forward's gate/up (the halves of h @ w_gu,
    computed in f32), as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w_gu = (d**-0.5 * rng.standard_normal((d, 2 * f))).astype(np.float32)
    w_down = (f**-0.5 * rng.standard_normal((f, d))).astype(np.float32)
    g = rng.standard_normal((b, s, d)).astype(np.float32)
    gu = h @ w_gu
    return h, w_gu, w_down, g, gu[..., :f], gu[..., f:]


def _cast(arrays, dtype):
    """The same values in both packages: numpy -> (jax arrays, torch tensors)
    of ``dtype``, rounded to bf16 once by JAX and read back by torch."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
          for a in jx]
    return jx, tx


def _close_to_scale(got, want, rel, name=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("dtype,d,f", [("float32", 256, 128), ("bfloat16", 256, 384),
                                       ("float16", 256, 384)])
def test_fused_mlp_bwd_matches_jax_kernels(dtype, d, f):
    """``fused_mlp_bwd`` against the reference's two Pallas passes (interpret
    mode) on the same inputs: dh, d_w_gu, d_w_down."""
    b, s = 2, 32
    assert jmlp_bwd.supports(b * s, d, f, MLP_BLOCKS)
    assert tmlp_bwd.supports(b * s, d, f, MLP_BLOCKS)
    (h, w_gu, w_down, g, gate, up), ours = _cast(_inputs(b, s, d, f), dtype)
    want = jmlp_bwd.fused_mlp_bwd(h, w_gu, w_down, gate, up, g, blocks=MLP_BLOCKS,
                                  interpret=True)
    got = tmlp_bwd.fused_mlp_bwd(*ours[:3], ours[4], ours[5], ours[3], blocks=MLP_BLOCKS)
    for name, x, r in zip(("dh", "d_w_gu", "d_w_down"), got, want):
        assert x.dtype == ours[0].dtype and tuple(x.shape) == r.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            _close_to_scale(x, r, HALF_TOL[dtype], name)


def test_plain_passes_match_jax_kernels_with_gate_up_views():
    """K5a's and K5b's plain versions, gate and up given as the halves of one
    gu buffer (as the op saves them), against the reference passes: the dgu
    buffer is the reference's concatenation of dgate and dup."""
    b, s, d, f = 2, 32, 256, 128
    h, w_gu, w_down, g, gate, up = _inputs(b, s, d, f, seed=3)
    gu = torch.from_numpy(np.concatenate([gate, up], -1).reshape(b * s, 2 * f))
    tgate, tup = gu.chunk(2, dim=-1)
    dgu, d_w_down = tmlp_bwd.dgu_dwdown_plain(torch.from_numpy(g.reshape(b * s, d)),
                                              torch.from_numpy(w_down), tgate, tup)
    dh, d_w_gu = tmlp_bwd.dh_dwgu_plain(torch.from_numpy(h.reshape(b * s, d)), dgu,
                                        torch.from_numpy(w_gu))
    want = jmlp_bwd.fused_mlp_bwd(*(jnp.asarray(a) for a in (h, w_gu, w_down, gate, up, g)),
                                  blocks=MLP_BLOCKS, interpret=True)
    for name, x, r in (("dh", dh.reshape(b, s, d), want[0]), ("d_w_gu", d_w_gu, want[1]),
                       ("d_w_down", d_w_down, want[2])):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mlp_gu_grads_match_jax(impl):
    """Gradients of sum(out^2) through the port's ``mlp_gu`` against
    ``jax.grad`` through the reference's, with the same backward."""
    b, s, d, f = 2, 32, 256, 128
    assert jmlp.effective_bwd_impl(impl, b, s, d, f, MLP_BLOCKS) == impl
    assert tmlp.effective_bwd_impl(impl, b, s, d, f, MLP_BLOCKS) == impl
    h, w_gu, w_down, *_ = _inputs(b, s, d, f, seed=1)
    want = jax.grad(
        lambda h, a, c: jnp.sum(jmlp.mlp_gu(_identity, h, a, c, impl, MLP_BLOCKS) ** 2),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (h, w_gu, w_down)))
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (h, w_gu, w_down)]
    tmlp_bwd.reset_launches()
    (tmlp.mlp_gu(*leaves, impl, MLP_BLOCKS) ** 2).sum().backward()
    for name, x, r in zip(("h", "w_gu", "w_down"), leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # CPU tensors run the plain version: no kernel launch is counted.
    assert (tmlp_bwd.launches_dgu, tmlp_bwd.launches_dh) == (0, 0)


def test_mlp_gu_pallas_falls_back_on_untileable_shapes():
    """F = 96 is not lane-tileable: both packages take the einsum spelling,
    and ``"pallas"`` gives the ``"xla"`` gradients (the reference's
    ``test_mlp_gu_pallas_falls_back_on_untileable_shapes``)."""
    b, s, d, f = 2, 32, 256, 96
    assert jmlp.effective_bwd_impl("pallas", b, s, d, f, ()) == "xla"
    assert tmlp.effective_bwd_impl("pallas", b, s, d, f, ()) == "xla"
    h, w_gu, w_down, *_ = _inputs(b, s, d, f, seed=2)
    grads = {}
    for impl in ("pallas", "xla"):
        x = torch.from_numpy(h.copy()).requires_grad_()
        (tmlp.mlp_gu(x, torch.from_numpy(w_gu), torch.from_numpy(w_down), impl) ** 2
         ).sum().backward()
        grads[impl] = x.grad.numpy()
    np.testing.assert_allclose(grads["pallas"], grads["xla"], rtol=1e-5, atol=1e-6)
    want = jax.grad(lambda x: jnp.sum(jmlp.mlp_gu(
        _identity, x, jnp.asarray(w_gu), jnp.asarray(w_down), "pallas", ()) ** 2))(
        jnp.asarray(h))
    np.testing.assert_allclose(grads["pallas"], np.asarray(want), rtol=1e-4, atol=1e-5)


NS = (16, 48, 64, 63, 256, 2064, 8192)
DS = (128, 200, 256, 4096)
FS = (96, 128, 384, 14336)
MLP_BLOCK_CASES = ((), (64, 128, 128), (16, 128, 256), (32, 512, 128), (0, 0, 0),
                   (48, 128, 128))


@pytest.mark.parametrize("blocks", MLP_BLOCK_CASES, ids=str)
def test_supports_matches_jax(blocks):
    """``supports`` is the reference's over a grid of (N, D, F), including
    the rejections of ``test_supports_rejects_unaligned_shapes``."""
    for n, d, f in itertools.product(NS, DS, FS):
        assert tmlp_bwd.supports(n, d, f, blocks) == jmlp_bwd.supports(n, d, f, blocks), (
            n, d, f, blocks)
        assert tproj.supports(n, d, f, blocks[:2]) == jproj.supports(n, d, f, blocks[:2]), (
            n, d, f, blocks)
    assert tmlp_bwd.supports(64, 256, 128, MLP_BLOCKS)
    assert not tmlp_bwd.supports(64, 256, 96, MLP_BLOCKS)
    assert not tmlp_bwd.supports(63, 256, 128, MLP_BLOCKS)
    assert tproj.supports(64, 256, 256, (64, 128))
    assert not tproj.supports(64, 200, 256, (64, 128))


def test_fused_mlp_bwd_rejects_what_supports_rejects():
    h, w_gu, w_down, g, gate, up = (torch.from_numpy(a) for a in _inputs(1, 63, 256, 128))
    with pytest.raises(ValueError, match="cannot tile"):
        tmlp_bwd.fused_mlp_bwd(h, w_gu, w_down, gate, up, g, blocks=MLP_BLOCKS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmlp.mlp_block(h, w_gu, w_down, bwd_impl="pallas", mesh=object())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mlp_gu_forward_is_the_inline_forward(dtype):
    """``mlp_gu``'s output is bit-identical to the inline layer's MLP."""
    h, w_gu, w_down, *_ = (torch.from_numpy(a).to(getattr(torch, dtype))
                           for a in _inputs(2, 16, 128, 128, seed=4))
    gate, up = (h @ w_gu).chunk(2, dim=-1)
    inline = (torch.nn.functional.silu(gate) * up) @ w_down
    for impl in ("pallas", "xla"):
        assert torch.equal(tmlp.mlp_gu(h, w_gu, w_down, impl, MLP_BLOCKS), inline)


def test_config_validation_matches_jax():
    """The port's ModelConfig rejects what the reference's rejects, with the
    same error type and message (``test_bwd_kernels.py::test_config_validation``),
    and accepts the kernels' configuration."""
    cases = [
        (dict(mlp_bwd_impl="pallas"), "fused_gate_up"),
        (dict(mlp_bwd_impl="cuda"), "xla|pallas"),
        (dict(proj_bwd_impl="cuda"), "xla|pallas"),
        (dict(num_experts=4, fused_gate_up=True, mlp_bwd_impl="pallas"), "MoE|dense"),
        (dict(num_experts=4, mlp_custom_vjp=True), "MoE|dense"),
        (dict(fused_gate_up=True, mlp_bwd_impl="pallas", mlp_bwd_block_n=-256),
         "mlp_bwd_block_n"),
        (dict(proj_bwd_block_d=-1), "proj_bwd_block_d"),
    ]
    for kw, match in cases:
        for cls in (JModelConfig, ModelConfig):
            with pytest.raises(ValueError, match=match):
                cls(**kw)
    kw = dict(fused_gate_up=True, mlp_bwd_impl="pallas", proj_bwd_impl="pallas",
              mlp_custom_vjp=True, mlp_bwd_block_n=64, proj_bwd_block_d=128)
    assert dataclasses.asdict(ModelConfig(**kw)) == {
        k: v for k, v in dataclasses.asdict(JModelConfig(**kw)).items()
        if k in dataclasses.asdict(ModelConfig(**kw))}


# ---------------------------------------------------------------------------
# The kernels' tile schedule and data flow (K5a writes inner once, then
# reads it back for d_w_down)
# ---------------------------------------------------------------------------

# (N, D, F): the training shape, chip_smoke.py's ragged MLP case (F = 384,
# an odd multiple of 128, overhung by 256-wide tiles) and the least N.
K5_SHAPES = [(8192, 4096, 14336), (2064, 256, 384), (16, 384, 384)]


def _k5_extents(n, d, f):
    return {"dinner": (n, f), "d_w_down": (f, d), "dh": (n, d), "d_w_gu": (d, 2 * f)}


@pytest.mark.parametrize("n,d,f", K5_SHAPES, ids=str)
def test_k5_tile_order_covers_every_output_tile_once(n, d, f):
    """Every output tile of every role appears once in ``k5_tile_order``,
    the tiles' grid covers the output, and what overhangs its edge (256-wide
    tiles over F = 384 or D = 384, 128-row tiles over a ragged N) is only
    the masked remainder of the last row or column of tiles."""
    bm, bn = tmlp_bwd.K5_BLOCK_M, tmlp_bwd.K5_BLOCK_N
    extents = _k5_extents(n, d, f)
    for kernel, roles in (("K5a", ("dinner", "d_w_down")), ("K5b", ("dh", "d_w_gu"))):
        order = tmlp_bwd.k5_tile_order(n, d, f, kernel)
        assert len(order) == len(set(order)), kernel
        assert {name for name, _, _ in order} == set(roles)
        for role in roles:
            rows, cols = extents[role]
            tiles = {(r, c) for name, r, c in order if name == role}
            assert tiles == set(itertools.product(range(0, rows, bm), range(0, cols, bn))), role
            # the masked overhang: past the edge only in the last tile row/column
            assert max(r for r, _ in tiles) + bm - rows in range(bm)
            assert max(c for _, c in tiles) + bn - cols in range(bn)
    if f == 384:  # the dinner tiles of columns 256..511 store only 256..383
        assert ("dinner", 0, 256) in tmlp_bwd.k5_tile_order(n, d, f, "K5a")


@pytest.mark.parametrize("n,d,f", K5_SHAPES, ids=str)
def test_k5_tile_order_hands_out_activation_tiles_first(n, d, f):
    """K5a hands out every dinner tile before any d_w_down tile (a d_w_down
    tile waits for the inner its strip's dinner tiles write, so it may only
    wait on tiles already held by running blocks); K5b every dh tile before
    any d_w_gu tile. Within a role, the grouped raster walks K5_GROUP
    column tiles at a time."""
    for kernel, first in (("K5a", "dinner"), ("K5b", "dh")):
        names = [name for name, _, _ in tmlp_bwd.k5_tile_order(n, d, f, kernel)]
        n_first = names.count(first)
        assert n_first > 0 and set(names[:n_first]) == {first}, kernel
        assert first not in names[n_first:], kernel
    order = [t for t in tmlp_bwd.k5_tile_order(n, d, f, "K5a") if t[0] == "dinner"]
    cols = sorted({c for _, _, c in order})
    group = cols[:tmlp_bwd.K5_GROUP]
    rows_first = len({r for _, r, _ in order})
    assert [c for _, _, c in order[:len(group)]] == group
    assert {c for _, _, c in order[:len(group) * rows_first]} == set(group)


def _k5_emulated(g, w_down, gate, up, h, w_gu):
    """K5a then K5b as their tiles run, in ``k5_tile_order``: each tile's
    product over its block of zero-padded operands (TMA's fill past an
    edge) with f32 sums, stores masked to the output's edge. K5a's dinner
    tiles write dgu and inner; its d_w_down tiles read inner only, and only
    once every dinner tile of their 256-column strip has run. Outputs start
    as NaN, so a tile that is never stored shows."""
    bm, bn = tmlp_bwd.K5_BLOCK_M, tmlp_bwd.K5_BLOCK_N
    n, d = g.shape
    f = w_down.shape[0]
    dt = g.dtype

    def pad(x, rows, cols):
        out = torch.zeros(rows, cols, dtype=torch.float32)
        out[: x.shape[0], : x.shape[1]] = x.float()
        return out

    rows_n = -(-n // bm) * bm
    gp, hp = pad(g, rows_n, -(-d // bn) * bn), pad(h, rows_n, -(-d // bn) * bn)
    wdp = pad(w_down, -(-f // bn) * bn, d)
    dgu = torch.full((n, 2 * f), float("nan"), dtype=dt)
    inner = torch.full((n, f), float("nan"), dtype=dt)
    d_w_down = torch.full((f, d), float("nan"), dtype=w_down.dtype)
    done = {}  # strip -> dinner tiles run
    for name, r, c in tmlp_bwd.k5_tile_order(n, d, f, "K5a"):
        if name == "dinner":
            dinner = gp[r:r + bm] @ wdp[c:c + bn].T
            rr, cc = slice(r, min(r + bm, n)), slice(c, min(c + bn, f))
            dinner = dinner[: rr.stop - r, : cc.stop - c]
            gt, ut = gate[rr, cc].float(), up[rr, cc].float()
            sg = torch.sigmoid(gt)
            silu = gt * sg
            dgu[rr, cc] = (dinner * ut * (sg * (1.0 + gt * (1.0 - sg)))).to(dt)
            dgu[rr, f + cc.start:f + cc.stop] = (dinner * silu).to(dt)
            inner[rr, cc] = (silu * ut).to(dt)
            done[c // bn] = done.get(c // bn, 0) + 1
        else:
            assert done.get(r // bn) == -(-n // bm), (name, r, c)  # the strip is ready
            ip = pad(inner, rows_n, f)
            d_w_down[r:r + bm, c:c + bn] = (ip[:, r:r + bm].T @ gp[:, c:c + bn])[
                :, : min(bn, d - c)].to(w_down.dtype)
    dgup = pad(dgu, rows_n, 2 * f)
    wgup = pad(w_gu, -(-d // bn) * bn, 2 * f)
    dh = torch.full((n, d), float("nan"), dtype=h.dtype)
    d_w_gu = torch.full((d, 2 * f), float("nan"), dtype=w_gu.dtype)
    for name, r, c in tmlp_bwd.k5_tile_order(n, d, f, "K5b"):
        if name == "dh":
            tile = dgup[r:r + bm] @ wgup[c:c + bn].T
            dh[r:min(r + bm, n), c:min(c + bn, d)] = tile[: min(bm, n - r),
                                                          : min(bn, d - c)].to(h.dtype)
        else:
            d_w_gu[r:r + bm, c:c + bn] = (hp[:, r:r + bm].T @ dgup[:, c:c + bn]).to(w_gu.dtype)
    return dgu, d_w_down, dh, d_w_gu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_k5_tile_data_flow_matches_plain_and_jax_kernels(dtype):
    """The kernels' data flow, tile by tile in the scheduler's order (inner
    materialised by the dinner tiles and read back by the d_w_down tiles,
    256-wide tiles overhanging F = 384, a ragged N = 272), against the plain
    versions and the reference's two Pallas passes in interpret mode: every
    output stored, within the file's tolerance for sums in other orders in
    f32 (1e-4) and one bf16 ulp (two float16 ulps) of each output's scale in
    bf16 (float16)."""
    b, s, d, f = 1, 272, 256, 384
    blocks = (16, 128, 128)
    assert jmlp_bwd.supports(b * s, d, f, blocks) and tmlp_bwd.supports(b * s, d, f, blocks)
    (h, w_gu, w_down, g, gate, up), ours = _cast(_inputs(b, s, d, f, seed=5), dtype)
    th, tw_gu, tw_down, tg, tgate, tup = (t.reshape(-1, t.shape[-1]) for t in ours)
    dgu, d_w_down, dh, d_w_gu = _k5_emulated(tg, tw_down, tgate, tup, th, tw_gu)
    dgu_ref, d_w_down_ref = tmlp_bwd.dgu_dwdown_plain(tg, tw_down, tgate, tup)
    dh_ref, d_w_gu_ref = tmlp_bwd.dh_dwgu_plain(th, dgu_ref, tw_gu)
    want = jmlp_bwd.fused_mlp_bwd(h, w_gu, w_down, gate, up, g, blocks=blocks,
                                  interpret=True)
    for name, x, r, j in (("dgu", dgu, dgu_ref, None), ("d_w_down", d_w_down, d_w_down_ref,
                                                        want[2]),
                          ("dh", dh.reshape(b, s, d), dh_ref.reshape(b, s, d), want[0]),
                          ("d_w_gu", d_w_gu, d_w_gu_ref, want[1])):
        assert not bool(torch.isnan(x.float()).any()), name  # every element stored
        refs = [r] + ([] if j is None else [j])
        for ref in refs:
            if dtype == "float32":
                np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                           err_msg=name)
            else:
                _close_to_scale(x, jnp.asarray(np.asarray(torch.as_tensor(ref).float())),
                                HALF_TOL[dtype], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_d_w_down_from_materialised_inner_is_plain_bits(dtype):
    """d_w_down from a materialised inner = (silu(gate) * up) rounded to the
    dtype once, as K5a's dinner tiles store it, is bit for bit the plain
    version's, and within the file's tolerance of the reference's pass 1 in
    interpret mode."""
    b, s, d, f = 2, 32, 256, 384
    (h, w_gu, w_down, g, gate, up), ours = _cast(_inputs(b, s, d, f, seed=6), dtype)
    tg, tgate, tup = (t.reshape(b * s, -1) for t in (ours[3], ours[4], ours[5]))
    gt = tgate.float()
    inner = (gt * torch.sigmoid(gt) * tup.float()).to(tg.dtype)  # the scratch
    d_w_down = (inner.float().T @ tg.float()).to(ours[2].dtype)
    _, d_w_down_ref = tmlp_bwd.dgu_dwdown_plain(tg, ours[2], tgate, tup)
    assert torch.equal(d_w_down, d_w_down_ref)
    want = jmlp_bwd.fused_mlp_bwd(h, w_gu, w_down, gate, up, g, blocks=MLP_BLOCKS,
                                  interpret=True)[2]
    if dtype == "float32":
        np.testing.assert_allclose(d_w_down.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        _close_to_scale(d_w_down, want, HALF_TOL[dtype])


# ---------------------------------------------------------------------------
# The model: loss gradients with the three flags
# ---------------------------------------------------------------------------

# The reference test's model (test_bwd_kernels.py::model_cfg): D, F and every
# head projection 128-multiples, f32.
MODEL = dict(vocab_size=512, hidden_size=256, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=64,
             dtype="float32", param_dtype="float32", fused_gate_up=True)
FLAGS = dict(mlp_bwd_impl="pallas", proj_bwd_impl="pallas", mlp_bwd_block_n=32,
             mlp_bwd_block_f=128, mlp_bwd_block_d=128, proj_bwd_block_n=32,
             proj_bwd_block_d=128)


@pytest.mark.parametrize("fused_qkv,flags", [
    (False, FLAGS), (True, FLAGS),
    (False, dict(mlp_custom_vjp=True)),  # the einsum spelling behind the seam
], ids=["kernels-unfused_qkv", "kernels-fused_qkv", "custom_vjp_xla"])
def test_loss_fn_grads_with_kernel_flags_match_jax(fused_qkv, flags):
    """``loss_fn`` gradients with ``mlp_bwd_impl``/``proj_bwd_impl="pallas"``
    (or ``mlp_custom_vjp`` alone) against the JAX ``loss_fn`` gradients with
    the same flags, on the same tree (``train_params_from_jax``, which
    converts the fused w_gu tree leaf for leaf), at 1e-4. With the kernel
    flags both sides run the kernel path for the MLP and every projection."""
    kw = dict(MODEL, fused_qkv=fused_qkv, **flags)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    b, s, d, f = 2, 16, cfg.hidden_size, cfg.intermediate_size
    hd = cfg.head_dim
    mlp_blocks = (cfg.mlp_bwd_block_n, cfg.mlp_bwd_block_f, cfg.mlp_bwd_block_d)
    proj_blocks = (cfg.proj_bwd_block_n, cfg.proj_bwd_block_d)
    outs = ([(cfg.num_heads + 2 * cfg.num_kv_heads) * hd] if fused_qkv
            else [cfg.num_heads * hd, cfg.num_kv_heads * hd])
    for mod, pmod in ((jmlp, jproj), (tmlp, tproj)):
        assert mod.effective_bwd_impl(cfg.mlp_bwd_impl, b, s, d, f,
                                      mlp_blocks) == cfg.mlp_bwd_impl
        for d_in, d_out in [(d, o) for o in outs] + [(cfg.num_heads * hd, d)]:
            assert pmod.effective_bwd_impl(cfg.proj_bwd_impl, b, s, d_in, d_out,
                                           proj_blocks) == cfg.proj_bwd_impl
    params = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(3, 500, size=(b, s)).astype(np.int32),
             "loss_mask": np.ones((b, s), np.float32)}
    jloss, jgrads = jax.value_and_grad(lambda p: jstep.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(
        jax.tree.map(jnp.asarray, params))

    tparams = train_params_from_jax(params, cfg, "cpu")
    assert "w_gu" in tparams["layers"]["mlp"]
    np.testing.assert_array_equal(params_to_numpy(tparams)["layers"]["mlp"]["w_gu"],
                                  params["layers"]["mlp"]["w_gu"])
    st = tstate.TrainState(tparams, tstate.make_leaves(tparams))
    layers, top = st.model_views()
    tproj.reset_launches()
    loss, _ = tstep.loss_fn(layers, top, {k: torch.from_numpy(v) for k, v in batch.items()},
                            cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    jflat = dict(_flat(jax.device_get(jgrads)))
    for leaf in st.leaves:
        grad = (torch.stack([p.grad for p in leaf.parts]) if leaf.stacked
                else leaf.parts[0].grad)
        want = jflat["/".join(leaf.path)]
        np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg="/".join(leaf.path))
    assert tproj.launches == 0  # CPU tensors: the plain versions ran


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v, np.float32)


def test_serving_forward_with_kernel_flags_is_unchanged():
    """The forwards behind the seams are the same products: ``forward`` under
    ``torch.no_grad`` gives bit-identical logits with and without the flags."""
    base = ModelConfig(**dict(MODEL, num_layers=1))
    flagged = ModelConfig(**dict(MODEL, num_layers=1, **FLAGS))
    params = llama.init_params(base, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(3, 500, (2, 16)))
    want = llama.forward(params, ids, base)
    assert torch.equal(llama.forward(params, ids, flagged), want)
    unfused = ModelConfig(**dict(MODEL, num_layers=1, fused_gate_up=False))
    with pytest.raises(ValueError, match="fused_gate_up"):
        llama.forward(llama.init_params(unfused, seed=0, device="cpu"), ids,
                      dataclasses.replace(unfused, mlp_custom_vjp=True))
