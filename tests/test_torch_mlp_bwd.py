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
  rounding by one ulp.
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


@pytest.mark.parametrize("dtype,d,f", [("float32", 256, 128), ("bfloat16", 256, 384)])
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
            _close_to_scale(x, r, BF16_ULP, name)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
