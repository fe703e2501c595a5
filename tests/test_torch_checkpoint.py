"""The port's checkpointing (``train/checkpoint.py``), exact resume and
validation, on the CPU at tiny size.

The manager's cases mirror ``tests/test_checkpoint.py`` (the JAX package's):
a roundtrip, an empty directory, the params-only restore (here into the
serving tree), a config mismatch that fails loudly, a torn newest step
(truncated, or one byte flipped so that only the checksum sees it)
quarantined with a fallback to the previous step, every step torn, a step
without a manifest, leftover temporary directories swept. Then the
trainer: six steps straight against three, a restart and three more, equal
to the bit in losses, masters, optimizer state and data position; the save
cadence and ``keep_checkpoints``. Validation is held to the JAX package: the
held-out split text for text, and ``val_loss`` against its eval step in f32
(rtol 1e-5: the same forward in another summation order).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import Config as JConfig  # noqa: E402
from ditl_tpu.config import DataConfig as JDataConfig  # noqa: E402
from ditl_tpu.config import MeshConfig  # noqa: E402
from ditl_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ditl_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.runtime.mesh import build_mesh  # noqa: E402
from ditl_tpu.train import trainer as jtrainer  # noqa: E402
from ditl_tpu.train.step import make_eval_step  # noqa: E402
from ditl_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: E402
from ditl_tpu_torch.data.dataset import synthetic_dataset  # noqa: E402
from ditl_tpu_torch.data.loader import DataPipeline  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.models import llama  # noqa: E402
from ditl_tpu_torch.models.convert import train_params_from_jax  # noqa: E402
from ditl_tpu_torch.train import state as tstate  # noqa: E402
from ditl_tpu_torch.train.checkpoint import (  # noqa: E402
    MANIFEST_NAME,
    CheckpointManager,
    DataIterState,
)
from ditl_tpu_torch.train.step import train_step  # noqa: E402
from ditl_tpu_torch.train.trainer import run_validation, split_validation, train  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=64, max_seq_len=128)


def _batch(seed, b=2, s=64):
    rng = np.random.default_rng(seed)
    return {"input_ids": torch.from_numpy(rng.integers(3, 500, (b, s)).astype(np.int32)),
            "loss_mask": torch.ones(b, s),
            "segment_ids": torch.ones(b, s, dtype=torch.int32),
            "positions": torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()}


def _state(optimizer="adafactor", steps=1, **model_kw):
    """A train state after ``steps`` steps (non-zero optimizer statistics)."""
    cfg = ModelConfig(**TINY, **model_kw)
    tcfg = TrainConfig(optimizer=optimizer, warmup_steps=1, total_steps=10,
                       learning_rate=1e-2)
    params = llama.init_train_params(cfg, seed=0, device="cpu")
    opt = tstate.make_optimizer(tcfg, params)
    st = tstate.TrainState.create(params, opt)
    for i in range(steps):
        train_step(st, _batch(i), cfg, opt)
    return st, cfg, tcfg


def _fresh(cfg, tcfg, seed=1):
    params = llama.init_train_params(cfg, seed=seed, device="cpu")
    return tstate.TrainState.create(params, tstate.make_optimizer(tcfg, params))


def _flat(tree, path=""):
    """``{path: value}`` of every tensor and scalar of a nested structure."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {k: v for key, sub in items for k, v in _flat(sub, f"{path}/{key}").items()}


def _assert_states_equal(a, b):
    assert a.step == b.step
    fa, fb = _flat(a.state_dict()), _flat(b.state_dict())
    assert fa.keys() == fb.keys()
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def _largest_file(step_dir) -> str:
    files = [os.path.join(r, n) for r, _, names in os.walk(step_dir) for n in names
             if n != MANIFEST_NAME]
    return max(files, key=os.path.getsize)


def _tear(step_dir, mode: str) -> None:
    victim = _largest_file(step_dir)
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        if mode == "truncate":
            f.truncate(size // 2)
        else:  # bit-flip: size unchanged, only the checksum can catch it
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))


def _save(directory, state, steps, **kw):
    mgr = CheckpointManager(str(directory), **kw)
    for step in steps:
        mgr.save(step, state, DataIterState(global_step=step))
    mgr.close()


@pytest.mark.parametrize("optimizer,param_dtype", [("adamw", "float32"),
                                                   ("adafactor", "float32"),
                                                   ("adafactor", "bfloat16")])
def test_save_restore_roundtrip(tmp_path, optimizer, param_dtype):
    """Masters, every optimizer statistic (Adam's moments; adafactor's
    factored rows and columns and its full second moments), the step and the
    data position, to the bit, into a fresh state of the same config."""
    st, cfg, tcfg = _state(optimizer, steps=2, param_dtype=param_dtype)
    mgr = CheckpointManager(str(tmp_path), save_every=2)
    assert not mgr.should_save(1) and mgr.should_save(2) and mgr.should_save(5, 2)
    mgr.save(2, st, DataIterState(epoch=1, step_in_epoch=3, global_step=2))
    mgr.close()
    assert sorted(os.listdir(tmp_path / "2")) == [MANIFEST_NAME, "meta.json",
                                                  "opt_state.pt", "params.pt"]
    fresh = _fresh(cfg, tcfg)
    restored, data_iter = CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert restored is fresh
    assert data_iter == DataIterState(epoch=1, step_in_epoch=3, global_step=2)
    _assert_states_equal(fresh, st)
    if optimizer == "adafactor":  # both kinds of statistic took part
        assert any(v is not None for v in st.opt_state["v_row"])
        assert any(v is not None for v in st.opt_state["v"])
    # The restored state trains on exactly as the original does.
    opt = tstate.make_optimizer(tcfg, fresh.params)
    train_step(fresh, _batch(9), cfg, opt)
    train_step(st, _batch(9), cfg, tstate.make_optimizer(tcfg, st.params))
    _assert_states_equal(fresh, st)


def test_save_copies_the_state_before_returning(tmp_path):
    """The step after a save updates the masters in place; the checkpoint
    holds the state as it was at the save."""
    st, cfg, tcfg = _state(steps=1)
    before = tstate.tree_to(st.state_dict(), "cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st, DataIterState(global_step=1))
    train_step(st, _batch(5), cfg, tstate.make_optimizer(tcfg, st.params))
    mgr.close()
    fresh = _fresh(cfg, tcfg)
    CheckpointManager(str(tmp_path)).restore_latest(fresh)
    for k, v in _flat(before).items():
        got = _flat(fresh.state_dict())[k]
        assert torch.equal(got, v) if isinstance(v, torch.Tensor) else got == v, k


def test_a_failed_save_raises_on_wait(tmp_path):
    """The write runs on a thread: its error reaches the next ``wait`` (and
    so fails the trainer's run), never a silent missing step."""
    st, _, _ = _state(steps=0)
    blocked = tmp_path / "not-a-directory"
    blocked.write_text("")
    mgr = CheckpointManager(str(blocked))
    mgr.save(1, st, DataIterState(global_step=1))
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()
    mgr.close()  # nothing left to report


def test_restore_latest_none_when_empty(tmp_path):
    st, cfg, _ = _state(steps=0)
    mgr = CheckpointManager(str(tmp_path / "never-written"))
    assert mgr.restore_latest(st) is None
    assert mgr.restore_latest_params(cfg) is None


@pytest.mark.parametrize("tied", [False, True])
def test_restore_latest_params_gives_the_serving_tree(tmp_path, tied):
    """Only ``params.pt`` is read, and the masters come back as the tree
    ``init_params`` builds: weights in the compute dtype, norms in f32, the
    head in f32 (the transposed embedding when tied)."""
    st, cfg, _ = _state(steps=1, tie_embeddings=tied, param_dtype="float32")
    _save(tmp_path, st, [5])
    os.remove(tmp_path / "5" / "opt_state.pt")
    os.remove(tmp_path / "5" / MANIFEST_NAME)  # legacy: no manifest to miss it in
    params = CheckpointManager(str(tmp_path)).restore_latest_params(
        cfg, llama.init_params(cfg, device="meta"))
    want = llama.init_params(cfg, seed=0, device="cpu")
    fp, fw = _flat(params), _flat(want)
    assert fp.keys() == fw.keys()
    for k, v in fw.items():
        assert (fp[k].shape, fp[k].dtype) == (v.shape, v.dtype), k
    cd = llama.torch_dtype(cfg.dtype)
    wq = st.params["layers"]["attn"]["wq"]
    assert torch.equal(params["layers"]["attn"]["wq"], wq.to(cd))
    emb = st.params["embed"]["embedding"].to(cd)
    head = emb.float().T if tied else st.params["lm_head"]["kernel"].to(cd).float()
    assert torch.equal(params["lm_head"]["kernel"], head)
    assert torch.equal(params["final_norm"]["scale"], st.params["final_norm"]["scale"])


def test_restore_mismatch_fails_loudly(tmp_path):
    st, cfg, tcfg = _state(steps=1)
    _save(tmp_path, st, [1])
    wrong = dataclasses.replace(cfg, hidden_size=256)
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match="does not match the model config"):
        mgr.restore_latest_params(wrong, llama.init_params(wrong, device="meta"))
    fused = dataclasses.replace(cfg, fused_gate_up=True)
    with pytest.raises(ValueError, match="does not match the model config"):
        mgr.restore_latest_params(fused, llama.init_params(fused, device="meta"))
    other = _fresh(wrong, tcfg)
    with pytest.raises(ValueError, match="checkpoint leaf"):
        mgr.restore_latest(other)
    adamw = _fresh(cfg, dataclasses.replace(tcfg, optimizer="adamw"))
    with pytest.raises(ValueError, match="checkpoint node"):
        mgr.restore_latest(adamw)
    assert os.path.isdir(tmp_path / "1")  # verified bytes are never quarantined


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_torn_newest_step_is_quarantined_and_restore_falls_back(tmp_path, mode):
    st, cfg, tcfg = _state(steps=1)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    mgr.save(2, st, DataIterState(global_step=2))
    older = tstate.tree_to(st.state_dict(), "cpu")
    train_step(st, _batch(3), cfg, tstate.make_optimizer(tcfg, st.params))
    mgr.save(4, st, DataIterState(global_step=4))
    mgr.close()
    _tear(tmp_path / "4", mode)
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.verify_step(4) == "corrupt" and mgr2.verify_step(2) == "verified"
    fresh = _fresh(cfg, tcfg)
    _, data_iter = mgr2.restore_latest(fresh)
    assert data_iter.global_step == 2
    for k, v in _flat(older["params"]).items():
        assert torch.equal(_flat(fresh.params)[k], v), k
    assert os.path.isdir(tmp_path / "quarantine" / "4")
    assert not os.path.exists(tmp_path / "4")


def test_restore_latest_params_falls_back_past_torn_step(tmp_path):
    st, cfg, _ = _state(steps=1)
    _save(tmp_path, st, [1, 3], max_to_keep=10)
    _tear(tmp_path / "3", "truncate")
    params = CheckpointManager(str(tmp_path)).restore_latest_params(cfg)
    assert params is not None
    assert torch.equal(params["layers"]["mlp"]["w_up"],
                       st.params["layers"]["mlp"]["w_up"].to(llama.torch_dtype(cfg.dtype)))
    assert os.path.isdir(tmp_path / "quarantine" / "3")


def test_all_steps_torn_restores_none(tmp_path):
    st, cfg, _ = _state(steps=1)
    _save(tmp_path, st, [2])
    _tear(tmp_path / "2", "truncate")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(st) is None
    assert mgr.restore_latest_params(cfg) is None
    assert os.path.isdir(tmp_path / "quarantine" / "2")


def test_legacy_step_without_manifest_still_restores(tmp_path):
    st, cfg, tcfg = _state(steps=1)
    _save(tmp_path, st, [2])
    os.remove(tmp_path / "2" / MANIFEST_NAME)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.verify_step(2) == "legacy"
    restored = mgr.restore_latest(_fresh(cfg, tcfg))
    assert restored is not None and restored[1].global_step == 2
    _tear(tmp_path / "2", "truncate")  # a legacy step that fails to load goes
    assert mgr.restore_latest(_fresh(cfg, tcfg)) is None
    assert os.path.isdir(tmp_path / "quarantine" / "2")


def test_torn_tmp_dirs_are_swept_to_quarantine(tmp_path):
    st, cfg, tcfg = _state(steps=1)
    _save(tmp_path, st, [2])
    wreck = tmp_path / "4.ditl-checkpoint-tmp-123-456"
    wreck.mkdir()
    (wreck / "params.pt").write_bytes(b"\x00" * 128)
    restored = CheckpointManager(str(tmp_path)).restore_latest(_fresh(cfg, tcfg))
    assert restored is not None and restored[1].global_step == 2
    assert not wreck.exists()
    assert os.path.isdir(tmp_path / "quarantine" / wreck.name)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def _config(ckpt_dir, total, **train_kw):
    # The recipe's flags at tiny size; prefetch 2 keeps the producer thread
    # batches ahead of the steps, as on the card.
    model = ModelConfig(**TINY, remat="dots_inputs", fused_gate_up=True,
                        attention_impl="flash", loss_impl="fused", loss_block_tokens=200)
    # Five documents pack into four batches an epoch.
    data = DataConfig(synthetic=True, synthetic_examples=5, batch_size=4, seq_len=96,
                      num_epochs=3, prefetch=2)
    train_cfg = TrainConfig(optimizer="adafactor", total_steps=total, warmup_steps=1,
                            learning_rate=1e-2, log_every=1, checkpoint_dir=str(ckpt_dir),
                            **train_kw)
    return Config(model=model, data=data, train=train_cfg)


def _final(ckpt_dir, config):
    """The state and data position of a run's newest checkpoint."""
    st = _fresh(config.model, config.train)
    return CheckpointManager(str(ckpt_dir)).restore_latest(st)


def test_trainer_resume_equals_a_straight_run_to_the_bit(tmp_path, monkeypatch):
    """Six steps straight against a run of the same config that dies in its
    fourth step, after the save at step three, and a restart (a new
    ``train`` call) that resumes there. The six steps span the end of an
    epoch (four packed batches), so the data position crosses it too."""
    import json

    from ditl_tpu_torch.train import trainer as trainer_mod

    straight = train(_config(tmp_path / "a", 6), device="cpu")
    real, calls = trainer_mod.train_step, []

    def dies_in_step_four(*args, **kwargs):
        if len(calls) == 3:
            raise RuntimeError("killed in step 4")
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(trainer_mod, "train_step", dies_in_step_four)
    metrics = tmp_path / "first.jsonl"
    with pytest.raises(RuntimeError, match="killed in step 4"):
        train(_config(tmp_path / "b", 6, checkpoint_every=3, metrics_file=str(metrics)),
              device="cpu")
    monkeypatch.undo()
    first = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    assert len(first) == 3 and sorted(os.listdir(tmp_path / "b")) == ["3"]
    second = train(_config(tmp_path / "b", 6, checkpoint_every=3), device="cpu")
    assert straight["resumed_from"] is None and second["resumed_from"] == 3
    assert (straight["steps"], second["steps"]) == (6, 6)
    assert first == [round(x, 6) for x in straight["losses"][:3]]
    assert second["losses"] == straight["losses"][3:]
    config = _config(tmp_path / "a", 6)
    st_a, pos_a = _final(tmp_path / "a", config)
    st_b, pos_b = _final(tmp_path / "b", config)
    assert pos_a == pos_b == DataIterState(epoch=1, step_in_epoch=2, global_step=6)
    _assert_states_equal(st_a, st_b)
    # A run already at its total resumes, takes no step and saves nothing new.
    again = train(_config(tmp_path / "b", 6, checkpoint_every=3), device="cpu")
    assert again["resumed_from"] == 6 and again["steps"] == 6 and again["losses"] == []
    # resume=false starts over from the seed.
    fresh = train(_config(tmp_path / "c", 6, resume=False), device="cpu")
    assert fresh["losses"] == straight["losses"]


def test_checkpoint_cadence_and_keep_checkpoints(tmp_path):
    out = train(_config(tmp_path, 7, checkpoint_every=2, keep_checkpoints=2), device="cpu")
    assert out["steps"] == 7
    # Saves at 2, 4, 6 and at the end (7); the two newest stay.
    assert sorted(n for n in os.listdir(tmp_path)) == ["6", "7"]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.verify_step(6) == mgr.verify_step(7) == "verified"


# ---------------------------------------------------------------------------
# Validation against the JAX package
# ---------------------------------------------------------------------------


def test_validation_split_matches_the_jax_trainer(monkeypatch):
    """The held-out split is the JAX trainer's, text for text: its
    validation pipeline's dataset, captured where the trainer builds it."""
    kw = dict(synthetic=True, synthetic_examples=60, batch_size=8, seq_len=64, seed=4,
              eval_fraction=0.15)
    seen = []

    class Stop(Exception):
        pass

    class Capture(jtrainer.DataPipeline):
        def __init__(self, dataset, tokenizer, config, mesh):
            seen.append((dataset, config.shuffle))
            if len(seen) == 2:
                raise Stop
            super().__init__(dataset, tokenizer, config, mesh)

    monkeypatch.setattr(jtrainer, "DataPipeline", Capture)
    jmodel = JModelConfig(**dict(TINY, hidden_size=64, intermediate_size=128,
                                 num_heads=2, head_dim=32))
    jconfig = JConfig(model=jmodel, data=JDataConfig(**kw),
                      train=JTrainConfig(val_every=2, total_steps=2))
    with pytest.raises(Stop):
        jtrainer.train(jconfig)
    (jtrain_ds, shuffled), (jval_ds, val_shuffled) = seen
    assert shuffled and not val_shuffled
    config = Config(data=DataConfig(**kw), train=TrainConfig(val_every=2))
    from ditl_tpu_torch.data.dataset import load_text_dataset

    train_ds, val_ds = split_validation(load_text_dataset(config.data), config)
    assert len(val_ds) == 9 and len(train_ds) == 51
    assert (val_ds.texts, val_ds.labels) == (jval_ds.texts, jval_ds.labels)
    assert (train_ds.texts, train_ds.labels) == (jtrain_ds.texts, jtrain_ds.labels)
    for bad in (dict(eval_fraction=0.1), dict(val_every=3)):
        data = DataConfig(**{**kw, "eval_fraction": bad.get("eval_fraction", 0.0)})
        cfg = Config(data=data, train=TrainConfig(val_every=bad.get("val_every", 0)))
        with pytest.raises(ValueError, match="set together"):
            split_validation(load_text_dataset(data), cfg)


def test_val_loss_matches_jax_eval_step():
    """``run_validation`` on converted masters against the JAX package's
    ``_run_validation`` over ``make_eval_step``, the same host batches
    (packed rows of the held-out split, no shuffle), f32."""
    over = dict(TINY, dtype="float32", param_dtype="float32", attention_impl="xla")
    jcfg, cfg = JModelConfig(**over), ModelConfig(**over)
    kw = dict(synthetic=True, synthetic_examples=80, batch_size=2, seq_len=96, seed=2,
              eval_fraction=0.25)
    config = Config(model=cfg, data=DataConfig(**kw), train=TrainConfig(val_every=1))
    _, val_ds = split_validation(synthetic_dataset(80, 2), config)
    pipe = DataPipeline(val_ds, ByteTokenizer(), dataclasses.replace(config.data,
                                                                     shuffle=False), "cpu")
    val_batches = list(pipe._host_batches(0))[:3]
    assert len(val_batches) == 3
    jparams = jllama.init_params(jax.random.key(7), jcfg)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    with mesh:
        want = jtrainer._run_validation(make_eval_step(jcfg, mesh), jparams, val_batches,
                                        mesh)
    params = train_params_from_jax(jax.device_get(jparams), cfg, "cpu")
    st = tstate.TrainState(params, tstate.make_leaves(params))
    got = run_validation(st, val_batches, cfg, torch.device("cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_trainer_reports_val_loss_on_its_cadence(tmp_path):
    config = _config(tmp_path, 4, checkpoint_every=0)
    config = dataclasses.replace(
        config,
        data=dataclasses.replace(config.data, eval_fraction=0.2, synthetic_examples=60),
        train=dataclasses.replace(config.train, val_every=2, val_batches=2,
                                  checkpoint_dir=""))
    out = train(config, device="cpu")
    assert out["steps"] == 4 and np.isfinite(out["val_loss"])
    assert out["val_loss"] < out["losses"][0]
