"""float16 training on the CPU against the JAX package, and the reference's
flash dispatch.

The reference trains with ``model.dtype=float16``: ``ModelConfig.dtype`` is
the compute dtype, the masters stay f32 by default, and its Pallas kernels
(flash forward and backward, the MLP and projection backward) take any float
dtype, casting their outputs to the operands'. The port runs these on the
card through K1-f16, K2a-f16, K2b-f16, K5a-f16, K5b-f16 and K6-f16; here,
without a card, the wrappers run their plain versions. What this file holds:

- the flash dispatch (``ops/attention.py``): ``flash_attention.supports`` is
  the reference's rule over a grid of sequence lengths and head dims, and
  ``dot_product_attention(impl="flash")`` calls the flash kernel exactly
  where the reference calls its own (forward and backward blocks 512), and
  plain attention (the reference's output) elsewhere;
- ``flash_attention_bwd_plain`` in float16 against ``jax.vjp`` of the JAX
  flash attention (its Pallas kernels in interpret mode): dq, dk and dv
  within 4e-3 of each gradient's largest magnitude (both round the outputs
  to float16, and each side's delta comes from its own forward's float16
  o, which can sit a float16 ulp from the other's);
- the MLP block (``mlp_gu``) and the projection with ``"pallas"`` backward
  in float16 against the JAX ops with their Pallas kernels, within 2e-3 of
  each gradient's largest magnitude (two float16 ulps: the same float16
  operands, f32 sums in other orders);
- the fused loss (``ops/fused_ce.py``) in float16 at a size where the
  softmax part of the logits' gradient, about 1/(N V), lies below
  float16's least subnormal: the reference keeps that gradient in f32, so
  its head gradient is dense; the port's is too (not flushed to 0), within
  2e-3 of the largest magnitude (float16's rounding of the logits'
  gradient), and the hidden states' float16 gradient within 2e-2 (it lies
  among float16's subnormals, which XLA on the CPU flushes to 0 and
  PyTorch keeps);
- ``loss_fn`` gradients of a float16 config (flash, ``fused_gate_up``,
  ``fused_qkv``, both kernel flags with blocks that admit its widths)
  against ``jax.grad`` of the JAX ``loss_fn``: the loss within 2e-3
  relative and each leaf's gradient within 2e-2 of its largest magnitude
  (every activation is float16 on both sides, rounded at slightly
  different places, and the fused loss rounds its logits' gradient to
  float16 before the backward products where the reference keeps it in
  f32: bf16's tolerance, which float16's extra bits meet with room);
- two adafactor train steps against ``make_train_step`` with f32 masters
  (loss 2e-3 relative, grad_norm 2e-2, parameters 2e-2 of each leaf's
  largest value, as the bf16 step cases of tests/test_torch_train.py), and
  with float16 masters, where the reference's first update is non-finite:
  its first step's loss and grad_norm, and the reference's non-finite
  masters, are what that case asserts;
- ``launch.py ... model.dtype=float16`` training end to end on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import MeshConfig  # noqa: E402
from ditl_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ditl_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from ditl_tpu.data.loader import make_global_batch  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.ops import attention as jattn  # noqa: E402
from ditl_tpu.ops import flash_attention as jfa  # noqa: E402
from ditl_tpu.ops import mlp as jmlp  # noqa: E402
from ditl_tpu.ops import projection as jproj  # noqa: E402
from ditl_tpu.runtime.mesh import build_mesh  # noqa: E402
from ditl_tpu.train import state as jstate  # noqa: E402
from ditl_tpu.train import step as jstep  # noqa: E402
from ditl_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from ditl_tpu_torch.models.convert import params_to_numpy, train_params_from_jax  # noqa: E402
from ditl_tpu_torch.ops import attention as tattn  # noqa: E402
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from ditl_tpu_torch.ops import mlp as tmlp  # noqa: E402
from ditl_tpu_torch.ops import projection as tproj  # noqa: E402
from ditl_tpu_torch.train import state as tstate  # noqa: E402
from ditl_tpu_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BWD_TOL = 4e-3  # flash backward, float16
OP_TOL = 2e-3  # MLP and projection backward, float16
MODEL_TOL = 2e-2  # gradients and parameters through the float16 model
LOSS_TOL = 2e-3
# tests/test_torch_f16.py's float16 config (Llama layout, head_dim 64) under
# the kernel flags, with the blocks of tests/test_torch_train.py's
# mlp_proj_kernels case, which admit its widths in both packages.
F16_TRAIN = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=256,
                 dtype="float16", param_dtype="float32", attention_impl="flash",
                 fused_gate_up=True, fused_qkv=True, mlp_bwd_impl="pallas",
                 proj_bwd_impl="pallas", mlp_bwd_block_n=64, mlp_bwd_block_f=128,
                 mlp_bwd_block_d=128, proj_bwd_block_n=64, proj_bwd_block_d=128,
                 loss_impl="fused", loss_block_tokens=256, remat="full")


# ---------------------------------------------------------------------------
# The reference's flash dispatch
# ---------------------------------------------------------------------------

SEQS = (16, 64, 100, 128, 300, 512, 1024, 2048)


@pytest.mark.parametrize("head_dim", [16, 32, 64, 96, 128, 256])
def test_flash_supports_matches_the_reference(head_dim):
    """The port's copy of ``supports`` gives the reference's answer for
    every (Sq, Skv) of ``SEQS`` at this head dim, with the default 512
    blocks and with 128-blocks."""
    for s_q in SEQS:
        for s_kv in SEQS:
            for blocks in ((), (128, 128)):
                assert tfa.supports(s_q, s_kv, head_dim, *blocks) == jfa.supports(
                    s_q, s_kv, head_dim, *blocks), (s_q, s_kv, head_dim, blocks)


# (label, S, H, K, D, ids): shapes the reference sends to XLA attention (D =
# 32, S = 100 and S = 64, the lock-step engine's bucket of 64) and shapes it
# sends to its kernel (D = 128 at S = 512, D = 64 at S = 2048, the training
# rows).
DISPATCH_CASES = {
    "xla-d32": (256, 4, 2, 32, True),
    "xla-s100": (100, 4, 2, 64, True),
    "xla-s64": (64, 4, 2, 128, False),
    "flash-d128-s512": (512, 4, 2, 128, True),
    "flash-d64-s2048": (2048, 2, 1, 64, True),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_flash_dispatch_follows_the_reference(case, monkeypatch):
    """``dot_product_attention(impl="flash")`` calls ``flash_attention``
    only where the reference's ``supports`` holds for its forward and
    backward blocks; elsewhere it returns plain attention, which is the
    reference's output on the same inputs (its XLA path)."""
    s, h, kv, d, ids = DISPATCH_CASES[case]
    calls = []
    real = tfa.flash_attention

    def recording(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tfa, "flash_attention", recording)
    rng = np.random.default_rng(s + d)
    q = rng.standard_normal((1, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, kv, d)).astype(np.float32) for _ in range(2))
    seg = None
    if ids:
        seg = np.ones((1, s), np.int32)
        seg[:, s // 3:] = 2
    tseg = None if seg is None else torch.from_numpy(seg)
    out = tattn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                      causal=True, segment_ids=tseg, impl="flash")
    want_flash = case.startswith("flash")
    assert bool(calls) == want_flash, calls
    assert want_flash == jfa.supports(s, s, d)
    if not want_flash:
        ref = jattn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            segment_ids=None if seg is None else jnp.asarray(seg), impl="flash")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The kernels' plain versions in float16
# ---------------------------------------------------------------------------

# (D, H, K): G = 2 and G = 7 (qwen2's 14/2 heads) at D = 64 and 128
FLASH_LAYOUTS = [(64, 4, 2), (64, 14, 2), (128, 4, 2), (128, 14, 2)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal-packed", "noncausal"])
@pytest.mark.parametrize("d,h,kv", FLASH_LAYOUTS, ids=str)
def test_flash_bwd_plain_float16_matches_jax_kernels(d, h, kv, causal):
    """``flash_attention_bwd_plain`` in float16 (from the plain forward's o
    and lse) against ``jax.vjp`` of the reference's flash attention in
    float16 (``_fwd_kernel`` then ``_bwd_impl``'s ``_dq_kernel`` and
    ``_dkv_kernel``, interpret mode), causal with packed ids or
    non-causal without: every gradient float16 and within ``BWD_TOL``."""
    b, s = 2, 256
    rng = np.random.default_rng(d + h)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32) for _ in range(2))
    seg = None
    if causal:
        seg = np.ones((b, s), np.int32)
        seg[:, 70:] = 2
        seg[1, 190:] = 3

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal,
                                   segment_ids=None if seg is None else jnp.asarray(seg),
                                   block_q=128, block_kv=128, interpret=True)

    jargs = [jnp.asarray(x, jnp.float16) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *jargs)
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jnp.float16))]
    tq, tk, tv, tdo = (torch.from_numpy(x).half() for x in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal, segment_ids=tseg)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                        segment_ids=tseg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float16, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=BWD_TOL * float(np.abs(w).max()), err_msg=name)


def _f16_pair(*arrays):
    """The same float16 values as jax arrays and torch tensors."""
    jx = [jnp.asarray(a).astype(jnp.float16) for a in arrays]
    return jx, [torch.from_numpy(np.array(a.astype(jnp.float32))).half() for a in jx]


def _close_scaled(got, want, tol, name):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.dtype == torch.float16, name
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()), err_msg=name)


def test_mlp_and_projection_pallas_backward_float16_match_jax_kernels():
    """The MLP block (``mlp_gu`` with ``"pallas"``, which runs
    ``fused_mlp_bwd``: K5a-f16 and K5b-f16 on the card) and a projection
    (``projection`` with ``"pallas"``: K6-f16) in float16 against the JAX
    ops with their Pallas kernels in interpret mode: the gradients of h,
    w_gu, w_down, x and w within ``OP_TOL``."""
    b, s, d, f = 2, 64, 256, 384
    mlp_blocks, proj_blocks = (64, 128, 128), (64, 128)
    assert jmlp.effective_bwd_impl("pallas", b, s, d, f, mlp_blocks) == "pallas"
    assert tmlp.effective_bwd_impl("pallas", b, s, d, f, mlp_blocks) == "pallas"
    assert jproj.effective_bwd_impl("pallas", b, s, d, f, proj_blocks) == "pallas"
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((b, s, d)), d**-0.5 * rng.standard_normal((d, 2 * f)),
              f**-0.5 * rng.standard_normal((f, d)), rng.standard_normal((b, s, d)),
              d**-0.5 * rng.standard_normal((d, f)), rng.standard_normal((b, s, f))]
    (jh, jwgu, jwd, jg, jw, jgp), (th, twgu, twd, tg, tw, tgp) = _f16_pair(*arrays)

    _, vjp = jax.vjp(lambda h_, a, c: jmlp.mlp_gu(lambda t: t, h_, a, c, bwd_impl="pallas",
                                                  bwd_blocks=mlp_blocks), jh, jwgu, jwd)
    want = vjp(jg)
    leaves = [t.clone().requires_grad_() for t in (th, twgu, twd)]
    out = tmlp.mlp_gu(*leaves, "pallas", mlp_blocks)
    got = torch.autograd.grad(out, leaves, grad_outputs=tg)
    for name, x, r in zip(("h", "w_gu", "w_down"), got, want):
        _close_scaled(x, r, OP_TOL, name)

    _, vjp = jax.vjp(lambda x_, w_: jproj.projection(x_, w_, bwd_impl="pallas",
                                                     blocks=proj_blocks), jh, jw)
    want = vjp(jgp)
    leaves = [t.clone().requires_grad_() for t in (th, tw)]
    out = tproj.projection(*leaves, bwd_impl="pallas", blocks=proj_blocks)
    got = torch.autograd.grad(out, leaves, grad_outputs=tgp)
    for name, x, r in zip(("x", "w"), got, want):
        _close_scaled(x, r, OP_TOL, name)


def test_fused_loss_float16_keeps_the_logits_gradient_in_range():
    """The fused loss's gradients in float16 against the reference's at N =
    16384 tokens and V = 2048, where ``g / V`` (g = 1/N) is below float16's
    least subnormal: the head's gradient is dense on both sides and within
    ``OP_TOL``, the hidden states' within ``MODEL_TOL``."""
    from ditl_tpu.ops import fused_ce as jce
    from ditl_tpu_torch.ops import fused_ce as tce

    n, d, v = 16384, 64, 2048
    assert 1.0 / (n * v) < 2.0**-24  # float16's least subnormal
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    head = (0.02 * rng.standard_normal((d, v))).astype(np.float32)
    t, m = rng.integers(0, v, n).astype(np.int32), np.ones(n, np.float32)
    jgx, jgh = jax.grad(lambda x_, h_: jce.fused_cross_entropy(
        x_, h_, jnp.asarray(t), jnp.asarray(m), block_tokens=4096,
        compute_dtype=jnp.float16) / n, argnums=(0, 1))(jnp.asarray(x, jnp.float16),
                                                        jnp.asarray(head))
    tx = torch.from_numpy(x).half().requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    (tce.fused_cross_entropy(tx, th, torch.from_numpy(t), torch.from_numpy(m),
                             block_tokens=4096, compute_dtype=torch.float16) / n).backward()
    jgh = np.asarray(jgh, np.float32)
    assert (jgh == 0).mean() < 1e-3 and float((th.grad == 0).float().mean()) < 1e-3
    _close_scaled(tx.grad, jgx, MODEL_TOL, "dx")
    np.testing.assert_allclose(th.grad.numpy(), jgh, rtol=0,
                               atol=OP_TOL * float(np.abs(jgh).max()), err_msg="dhead")


# ---------------------------------------------------------------------------
# The model and the train step in float16
# ---------------------------------------------------------------------------


def _configs(**over):
    kw = dict(F16_TRAIN, **over)
    return JModelConfig(**kw), ModelConfig(**kw)


def _batch(seed=0, b=4, s=128):
    """Packed rows: two or three documents a row, positions restarting at
    each document, a loss mask with a few holes."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, size=(b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    for row in range(b):
        cuts = sorted(rng.choice(np.arange(16, s - 16), size=1 + row % 2, replace=False))
        for n, c in enumerate(cuts):
            seg[row, c:] = n + 2
            pos[row, c:] = np.arange(s - c)
    mask = np.ones((b, s), np.float32)
    mask[:, -5:] = 0.0
    return {"input_ids": ids, "loss_mask": mask, "labels": np.zeros((b,), np.int32),
            "segment_ids": seg, "positions": pos}


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v, np.float32)


def _assert_kernel_dispatch(cfg, b, s):
    """Both packages send the MLP, every projection and the attention of
    ``cfg`` at (b, s) to the kernel paths."""
    d, hd = cfg.hidden_size, cfg.head_dim
    mlp_blocks = (cfg.mlp_bwd_block_n, cfg.mlp_bwd_block_f, cfg.mlp_bwd_block_d)
    proj_blocks = (cfg.proj_bwd_block_n, cfg.proj_bwd_block_d)
    for mod, pmod in ((jmlp, jproj), (tmlp, tproj)):
        assert mod.effective_bwd_impl("pallas", b, s, d, cfg.intermediate_size,
                                      mlp_blocks) == "pallas"
        for d_in, d_out in ((d, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd),
                            (cfg.num_heads * hd, d)):
            assert pmod.effective_bwd_impl("pallas", b, s, d_in, d_out,
                                           proj_blocks) == "pallas"
    assert tfa.supports(s, s, hd) and jfa.supports(s, s, hd)


def test_loss_fn_float16_gradients_match_jax():
    """``loss_fn`` and every gradient leaf of the float16 config (f32
    masters cast to float16 once) against ``jax.grad`` of the JAX
    ``loss_fn`` on the same tree and batch: the loss within ``LOSS_TOL``
    relative, each leaf within ``MODEL_TOL`` of its largest magnitude, and
    the same leaves flushed to zero where the reference flushes them."""
    jcfg, cfg = _configs()
    _assert_kernel_dispatch(cfg, 4, 128)
    params = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    batch = _batch()
    jloss, jgrads = jax.value_and_grad(lambda p: jstep.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(
        jax.tree.map(jnp.asarray, params))
    tparams = train_params_from_jax(params, cfg, "cpu")
    st = tstate.TrainState(tparams, tstate.make_leaves(tparams))
    layers, top = st.model_views(tstep.cast_for_compute(cfg))
    assert layers[0]["attn"]["w_qkv"].dtype == torch.float16
    loss, _ = tstep.loss_fn(layers, top, {k: torch.from_numpy(v) for k, v in batch.items()},
                            cfg)
    loss.backward()
    assert np.isfinite(float(jloss))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_TOL)
    jflat = dict(_flat(jax.device_get(jgrads)))
    for leaf in st.leaves:
        grad = (torch.stack([p.grad for p in leaf.parts]) if leaf.stacked
                else leaf.parts[0].grad)
        want = jflat["/".join(leaf.path)]
        assert grad.dtype == torch.float32 and bool(torch.isfinite(grad).all())
        np.testing.assert_allclose(grad.numpy(), want, rtol=0,
                                   atol=MODEL_TOL * float(np.abs(want).max()),
                                   err_msg="/".join(leaf.path))
        assert bool((grad == 0).all()) == bool((want == 0).all()), leaf.path


@pytest.mark.parametrize("masters", ["float32", "float16"])
def test_float16_train_steps_match_jax(masters):
    """Two adafactor steps of the float16 config against
    ``make_train_step`` on a one-device mesh, from the same masters (f32,
    the reference's default, or float16) and batches: loss and grad_norm
    of each step, and every updated master after it while the reference's
    masters stay finite. With float16 masters they do not: the reference's
    first update is non-finite (its second-moment statistics in float16,
    where ``grad**2 + 1e-30`` is 0 for the gradients below float16's range
    and for the rows that saw no token, so their inverse square root is
    infinite), so only the first step's loss and grad_norm are compared
    there, and the test asserts that the reference's masters are
    non-finite."""
    jcfg, cfg = _configs(param_dtype=masters)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5, optimizer="adafactor")
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    params = jax.device_get(jllama.init_params(jax.random.key(1), jcfg))
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    batches = [_batch(seed) for seed in range(2)]
    gb = [make_global_batch(mesh, b) for b in batches]
    with mesh:
        jparams = jax.tree.map(jnp.asarray, params)
        tx = jstate.make_optimizer(jtcfg, jparams)
        jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                                opt_state=tx.init(jparams))
        jtrain = jstep.make_train_step(jcfg, jtcfg, mesh, gb[0])
    tparams = train_params_from_jax(params, cfg, "cpu")
    opt = tstate.make_optimizer(tcfg, tparams)
    st = tstate.TrainState.create(tparams, opt)
    assert all(leaf.master.dtype == getattr(torch, masters) for leaf in st.leaves)
    for i in range(2):
        with mesh:
            jst, jm = jtrain(jst, gb[i])
        m = tstep.train_step(st, {k: torch.from_numpy(v.copy()) for k, v in batches[i].items()},
                             cfg, opt)
        assert np.isfinite(float(jm["loss"])) and np.isfinite(float(m["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=10 * LOSS_TOL)
        jflat = dict(_flat(jax.device_get(jst.params)))
        if not all(np.isfinite(x).all() for x in jflat.values()):
            assert masters == "float16" and i == 0
            return
        for path, got in _flat(params_to_numpy(st.params)):
            want = jflat[path]
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=MODEL_TOL * max(float(np.abs(want).max()), 1e-3),
                                       err_msg=path)
    assert masters == "float32" and st.step == 2


def test_launcher_trains_float16_on_cpu_end_to_end():
    """``python -m ditl_tpu_torch.launch --device cpu ... model.dtype=float16``
    under the kernel flags: finite losses that fall, the summary JSON last."""
    args = [f"model.{k}={v}" for k, v in F16_TRAIN.items()] + [
        "data.synthetic=true", "data.batch_size=4", "data.seq_len=128",
        "train.total_steps=6", "train.log_every=1", "train.warmup_steps=1",
        "train.learning_rate=1e-2", "train.optimizer=adafactor"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "ditl_tpu_torch.launch", "--device", "cpu",
                           *args], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    losses = summary["losses"]
    assert summary["steps"] == 6 and summary["device"] == "cpu"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
