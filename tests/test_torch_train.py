"""Port parity for the training path: the port's optimizers, loss, train step
and data pipeline against the JAX package on the same numpy inputs, and the
launcher end to end on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on a one-CPU-device mesh, its flash attention through the
Pallas kernels in interpret mode (S=128 and head_dim 64, so its dispatcher
does not fall back to XLA attention).

Tolerances:
- f32 compute and masters: 1e-5 relative on losses, 1e-4 relative (of the
  leaf's largest value) on gradients and on parameters after optimizer
  updates from the same gradients; 1e-3 on parameters after train steps:
  the same arithmetic summed in other orders through three updates;
- after train steps, two stated exceptions. Leaves smaller than 1e-3 are
  held to 1e-3 of 1e-3: the q/k biases' gradients nearly cancel (softmax
  ignores a shift shared by a row's scores), so summation noise is a large
  share of them. And Adam divides each element's gradient by its own
  magnitude, so an element whose gradient sits at the level of the
  summation noise moves by up to a learning rate on that noise: at most
  0.1% of a leaf's elements may differ by up to three learning rates
  (three steps). With bf16 compute every gradient carries bf16-level
  differences, which Adam would amplify on most small elements, so the
  bf16 cases run adafactor (its normalization is per row and column);
- bf16 masters (the optimizer case): 1e-2 of the leaf's largest value, a
  couple of bf16 ulps (sums run in another order before each rounding);
- bf16 compute through the model (the bf16 step cases): loss and
  grad_norm at 2e-2 relative, parameters at 2e-2 of the leaf's largest
  value: both sides round every activation to bf16 at slightly different
  places, and the fused loss rounds its logits' gradient to bf16 before the
  backward products (ops/fused_ce.py) where the reference keeps it in f32.
"""

import dataclasses
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

from ditl_tpu.config import DataConfig as JDataConfig  # noqa: E402
from ditl_tpu.config import MeshConfig  # noqa: E402
from ditl_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ditl_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from ditl_tpu.data.dataset import synthetic_dataset as jsynthetic  # noqa: E402
from ditl_tpu.data.loader import DataPipeline as JDataPipeline  # noqa: E402
from ditl_tpu.data.loader import make_global_batch  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.runtime.mesh import build_mesh  # noqa: E402
from ditl_tpu.train import state as jstate  # noqa: E402
from ditl_tpu.train import step as jstep  # noqa: E402
from ditl_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: E402
from ditl_tpu_torch.data.dataset import synthetic_dataset  # noqa: E402
from ditl_tpu_torch.data.loader import DataPipeline  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.models import llama  # noqa: E402
from ditl_tpu_torch.models.convert import params_to_numpy, train_params_from_jax  # noqa: E402
from ditl_tpu_torch.train import state as tstate  # noqa: E402
from ditl_tpu_torch.train import step as tstep  # noqa: E402
from ditl_tpu_torch.train.trainer import train  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# 2 layers, head_dim 64, vocab 512; hidden 128 and MLP 256 so that some
# leaves are factored by adafactor (two dims >= 128) and others are not.
TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=64, max_seq_len=128)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_trees_close(ours, ref, rel, floor=1e-30, outliers=0.0, outlier_atol=0.0):
    """Every leaf within ``rel`` of the reference leaf's largest value (or
    of ``floor``, whichever is larger), except at most a fraction
    ``outliers`` of its elements, which must be within ``outlier_atol``."""
    for path, want in _leaves(ref):
        got = np.asarray(_get(ours, path), np.float32)
        want = np.asarray(want, np.float32)
        atol = rel * max(float(np.abs(want).max()), floor)
        diff = np.abs(got - want)
        bad = diff > atol
        if bad.mean() <= outliers and (diff[bad] <= outlier_atol).all():
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

OPT_SHAPES = {  # a small stacked tree: factored and unfactored leaves
    "embed": {"embedding": (300, 128)},
    "layers": {"attn": {"wq": (2, 128, 256), "wk": (2, 128, 64)},
               "attn_norm": {"scale": (2, 128)}},
    "lm_head": {"kernel": (64, 40)},
}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_optax(optimizer, dtype):
    """Three updates through ``make_optimizer`` against the JAX package's
    optax chain, the first with gradients large enough to be clipped."""
    rng = np.random.default_rng(0)
    params = _tree_map(lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32),
                       OPT_SHAPES)
    grads = [_tree_map(lambda s, i=i: ((3.0 if i == 0 else 0.3)
                                       * rng.standard_normal(s)).astype(np.float32),
                       OPT_SHAPES) for i in range(3)]
    kw = dict(optimizer=optimizer, learning_rate=1e-2, warmup_steps=1, total_steps=5,
              adam_mu_dtype="bfloat16" if dtype == "bfloat16" else "float32")
    jparams = _tree_map(lambda a: jnp.asarray(a, dtype=dtype), params)
    tx = jstate.make_optimizer(JTrainConfig(**kw), jparams)
    jopt = tx.init(jparams)
    tparams = _tree_map(lambda a: torch.from_numpy(a.copy()).to(getattr(torch, dtype)),
                        params)
    leaves = tstate.make_leaves(tparams)
    opt = tstate.make_optimizer(TrainConfig(**kw), tparams)
    topt = opt.init(leaves)
    rel = 1e-5 if dtype == "float32" else 1e-2
    for g in grads:
        updates, jopt = tx.update(_tree_map(lambda a: jnp.asarray(a, dtype=dtype), g),
                                  jopt, jparams)
        jparams = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jparams, updates)
        for leaf in leaves:
            arr = _get(g, leaf.path)
            for i, part in enumerate(leaf.parts):
                part.grad = torch.from_numpy((arr[i] if leaf.stacked else arr).copy()
                                             ).to(part.dtype)
        opt.step(leaves, topt)
        _assert_trees_close(params_to_numpy(tparams), jax.device_get(jparams), rel)
        for leaf in leaves:
            assert leaf.master.dtype == getattr(torch, dtype)


def test_schedule_matches_optax():
    import optax

    cfg = TrainConfig(learning_rate=3e-4, warmup_steps=3, total_steps=10)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10, 3e-5)
    ours = tstate.make_schedule(cfg)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)


def test_unported_optimizers_and_lora_raise():
    params = {"layers": {"attn": {"wq": torch.zeros(2, 4, 4)}}}
    for name in ("lion", "sgd"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tstate.make_optimizer(TrainConfig(optimizer=name), params)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstate.make_optimizer(TrainConfig(), {"layers": {"lora": {"a": torch.zeros(2, 2)}}})


# ---------------------------------------------------------------------------
# Loss and train step
# ---------------------------------------------------------------------------


def _configs(dtype="float32", param_dtype=None, **kw):
    over = dict(TINY, dtype=dtype, param_dtype=param_dtype or dtype, **kw)
    return JModelConfig(**over), ModelConfig(**over)


def _jax_params(jcfg, seed=0):
    """JAX init, with random norm scales so their gradients matter."""
    params = jax.device_get(jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    for group in ("attn_norm", "mlp_norm"):
        s = params["layers"][group]["scale"]
        params["layers"][group]["scale"] = (1 + 0.1 * rng.standard_normal(s.shape)
                                            ).astype(s.dtype)
    return params


def _batch(seed=0, b=4, s=128):
    """Packed rows: two or three documents per row, positions restarting at
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


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.mark.parametrize("loss_impl", ["naive", "fused"])
@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_loss_fn_and_gradients_match_jax(loss_impl, attention_impl):
    """``loss_fn`` value and every gradient leaf against ``jax.grad`` of the
    JAX ``loss_fn`` (f32)."""
    jcfg, cfg = _configs(loss_impl=loss_impl, attention_impl=attention_impl,
                         loss_block_tokens=200, remat="none")
    params = _jax_params(jcfg)
    batch = _batch()
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jstep.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    tparams = train_params_from_jax(params, cfg, "cpu")
    st = tstate.TrainState(tparams, tstate.make_leaves(tparams))
    layers, top = st.model_views()
    loss, aux = tstep.loss_fn(layers, top, _torch_batch(batch), cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(aux["n_tokens"]) == float(jaux["n_tokens"])
    grads = {}
    for leaf in st.leaves:
        g = torch.stack([p.grad for p in leaf.parts]) if leaf.stacked else leaf.parts[0].grad
        node = grads
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = g.numpy()
    _assert_trees_close(grads, jax.device_get(jgrads), 1e-4)


STEP_CASES = {  # id: (model overrides, train overrides)
    "xla-adamw-accum1-remat_none-fused_layouts": (
        dict(attention_impl="xla", remat="none", fused_qkv=True, fused_gate_up=True),
        dict(optimizer="adamw", grad_accum_steps=1)),
    "flash-adafactor-accum2-remat_full-fused": (
        dict(attention_impl="flash", remat="full", loss_impl="fused",
             loss_block_tokens=256),
        dict(optimizer="adafactor", grad_accum_steps=2)),
    "flash-adamw-accum1-remat_full": (dict(attention_impl="flash", remat="full"),
                                      dict(optimizer="adamw", grad_accum_steps=1)),
    "xla-adafactor-accum2-remat_none-tied_bias": (
        dict(attention_impl="xla", remat="none", tie_embeddings=True, attention_bias=True),
        dict(optimizer="adafactor", grad_accum_steps=2)),
    # The reference's default: f32 masters cast to bf16 once per step.
    # Adafactor: Adam would turn the bf16-level gradient differences of
    # near-zero elements into whole learning-rate steps (see the module doc).
    "bf16compute-f32masters-flash-adafactor-remat_full": (
        dict(attention_impl="flash", remat="full", dtype="bfloat16",
             param_dtype="float32"),
        dict(optimizer="adafactor", grad_accum_steps=1)),
    "bf16-flash-adafactor-remat_full-fused": (
        dict(attention_impl="flash", remat="full", loss_impl="fused",
             loss_block_tokens=256, dtype="bfloat16"),
        dict(optimizer="adafactor", grad_accum_steps=1)),
    # The MLP and projection backward kernels (K5a/K5b, K6) on both sides.
    # The blocks admit TINY's shapes in both packages' supports (asserted in
    # the test); fused_qkv, because TINY's unfused wk/wv (64 columns) are
    # not lane-tileable and would take the einsum backward.
    "flash-adafactor-remat_full-mlp_proj_kernels": (
        dict(attention_impl="flash", remat="full", fused_gate_up=True, fused_qkv=True,
             mlp_bwd_impl="pallas", proj_bwd_impl="pallas", mlp_bwd_block_n=64,
             mlp_bwd_block_f=128, mlp_bwd_block_d=128, proj_bwd_block_n=64,
             proj_bwd_block_d=128),
        dict(optimizer="adafactor", grad_accum_steps=1)),
    # The selective remat policies, each against the reference's policy of
    # the same name: the weight products kept; the JAX package's one-chip
    # recipe (dots_inputs with fused_gate_up and both backward kernels,
    # flash, fused loss, adafactor); the attention output alone kept.
    "flash-adamw-accum1-remat_dots": (dict(attention_impl="flash", remat="dots"),
                                      dict(optimizer="adamw", grad_accum_steps=1)),
    "flash-adafactor-remat_dots_inputs-recipe": (
        dict(attention_impl="flash", remat="dots_inputs", fused_gate_up=True,
             fused_qkv=True, mlp_bwd_impl="pallas", proj_bwd_impl="pallas",
             mlp_bwd_block_n=64, mlp_bwd_block_f=128, mlp_bwd_block_d=128,
             proj_bwd_block_n=64, proj_bwd_block_d=128, loss_impl="fused",
             loss_block_tokens=256),
        dict(optimizer="adafactor", grad_accum_steps=1)),
    "xla-adafactor-accum2-remat_attn": (dict(attention_impl="xla", remat="attn"),
                                        dict(optimizer="adafactor", grad_accum_steps=2)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    """Three train steps against ``make_train_step`` on a one-device mesh:
    loss, grad_norm and every updated parameter leaf after each step."""
    model_kw, train_kw = (dict(kw) for kw in STEP_CASES[case])
    dtype = model_kw.pop("dtype", "float32")
    jcfg, cfg = _configs(dtype, **model_kw)
    if cfg.mlp_bwd_impl == "pallas":  # both sides run the kernel path
        from ditl_tpu.ops import mlp as jmlp
        from ditl_tpu.ops import projection as jproj
        from ditl_tpu_torch.ops import mlp as tmlp
        from ditl_tpu_torch.ops import projection as tproj

        b, s, d, hd = 4, 128, cfg.hidden_size, cfg.head_dim
        mlp_blocks = (cfg.mlp_bwd_block_n, cfg.mlp_bwd_block_f, cfg.mlp_bwd_block_d)
        proj_blocks = (cfg.proj_bwd_block_n, cfg.proj_bwd_block_d)
        for mod, pmod in ((jmlp, jproj), (tmlp, tproj)):
            assert mod.effective_bwd_impl("pallas", b, s, d, cfg.intermediate_size,
                                          mlp_blocks) == "pallas"
            for d_in, d_out in ((d, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd),
                                (cfg.num_heads * hd, d)):
                assert pmod.effective_bwd_impl("pallas", b, s, d_in, d_out,
                                               proj_blocks) == "pallas"
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5, **train_kw)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    params = _jax_params(jcfg)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    batches = [_batch(seed) for seed in range(3)]
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
    rel_loss, rel_p = (1e-5, 1e-3) if dtype == "float32" else (2e-2, 2e-2)
    for i in range(3):
        with mesh:
            jst, jm = jtrain(jst, gb[i])
        m = tstep.train_step(st, _torch_batch(batches[i]), cfg, opt, tcfg.grad_accum_steps)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=rel_loss)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=10 * rel_loss)
        assert float(m["n_tokens"]) == float(jm["n_tokens"])
        _assert_trees_close(params_to_numpy(st.params), jax.device_get(jst.params), rel_p,
                            floor=1e-3, outliers=1e-3 if dtype == "float32" else 0.0,
                            outlier_atol=3 * kw["learning_rate"])
    assert st.step == 3


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", [True, False])
def test_host_batches_match_jax_pipeline(pack):
    kw = dict(batch_size=4, seq_len=96, synthetic=True, synthetic_examples=40,
              pack_sequences=pack, seed=3)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    ref = JDataPipeline(jsynthetic(40, 3), JByteTokenizer(), JDataConfig(**kw), mesh)
    ours = DataPipeline(synthetic_dataset(40, 3), ByteTokenizer(), DataConfig(**kw), "cpu")
    for epoch in (0, 1):
        want = list(ref._host_batches(epoch))
        got = list(ours._host_batches(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    # Device batches: the same arrays as int32/f32 tensors, prefetched.
    first = next(iter(ours.epoch(0)))
    assert first["segment_ids"].dtype == torch.int32 and first["input_ids"].shape == (4, 96)
    np.testing.assert_array_equal(first["positions"].numpy(),
                                  next(ours._host_batches(0))["positions"])


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

_TINY_ARGS = [f"model.{k}={v}" for k, v in TINY.items()] + [
    "data.synthetic=true", "data.batch_size=4", "data.seq_len=128",
    "train.total_steps=6", "train.log_every=1", "train.warmup_steps=1",
    "train.learning_rate=1e-2", "train.optimizer=adafactor",
    "model.attention_impl=flash", "model.loss_impl=fused", "model.loss_block_tokens=200",
]


def test_launcher_trains_on_cpu_end_to_end(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    metrics_file = tmp_path / "metrics.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "ditl_tpu_torch.launch", "--device", "cpu", *_TINY_ARGS,
         f"train.metrics_file={metrics_file}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    losses = summary["losses"]
    assert summary["steps"] == 6 and len(losses) == 6
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert summary["device"] == "cpu" and summary["step_time_p50_s"] > 0
    rows = [json.loads(line) for line in metrics_file.read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(6))
    assert [r["loss"] for r in rows] == pytest.approx(losses, rel=1e-5)
    assert all(r["step_time_s"] > 0 and r["n_tokens"] == 4 * 127 for r in rows)


def test_entry_points_default_to_the_card():
    """Without a card, the trainer and the launcher refuse to run unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(Config())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "ditl_tpu_torch.launch", *_TINY_ARGS],
                          cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_config_overrides_and_unported_knobs():
    from ditl_tpu_torch.launch import build_config

    config, device = build_config(["--preset", "llama3-8b", "model.param_dtype=bfloat16",
                                   "model.remat=full", "train.optimizer=adafactor",
                                   "data.seq_len=2048"])
    assert (config.model.name, config.model.num_layers, config.model.param_dtype,
            config.data.seq_len, device) == ("llama3-8b", 32, "bfloat16", 2048, "cuda")
    config, _ = build_config(["model.name=llama3-8b", "model.num_layers=2"])
    assert (config.model.hidden_size, config.model.num_layers) == (4096, 2)
    config, _ = build_config(["model.remat=dots_inputs", "train.checkpoint_dir=/x",
                              "train.checkpoint_every=5", "train.keep_checkpoints=2",
                              "train.resume=false", "train.val_every=2",
                              "train.val_batches=3", "data.eval_fraction=0.1"])
    assert (config.model.remat, config.train.checkpoint_dir, config.train.checkpoint_every,
            config.train.keep_checkpoints, config.train.resume, config.train.val_every,
            config.train.val_batches, config.data.eval_fraction) == (
        "dots_inputs", "/x", 5, 2, False, 2, 3, 0.1)
    with pytest.raises(ValueError, match="unknown remat policy"):
        build_config(["model.remat=everything"])
    for bad in (["train.fault_kill_step=2"], ["train.steps_per_call=2"], ["train.init_from_hf=/x"],
                ["train.telemetry_dir=/x"], ["train.profile_dir=/x"],
                ["train.fault_nan_step=3"], ["mesh.fsdp=2"], ["chaos.rules=x"],
                ["--simulate", "8"], ["--distributed"], ["--supervise"], ["--pod", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_config(bad)
    with pytest.raises(ValueError, match="unknown key"):
        build_config(["train.nonsense=1"])
    cfg = dataclasses.replace(ModelConfig(), loss_impl="fused")
    assert cfg.loss_impl == "fused"
