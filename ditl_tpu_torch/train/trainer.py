"""The training loop on one device.

Counterpart of ``ditl_tpu.train.trainer.train``, the subset that one card
runs: tokenizer -> dataset (and its seeded held-out split) -> pipeline ->
train state (restored from the newest checkpoint when there is one) -> step
loop (saves on the ``checkpoint_every`` cadence and at the end, validation
loss on the ``val_every`` cadence, API eval on the ``eval_every`` cadence:
the first ``eval_samples`` training examples sent to the ``api`` section's
OpenAI-compatible endpoint through ``client/eval_loop.py``) -> summary.
Goodput accounting, the anomaly plane and flight recorder, profiling and
multi-step calls are not ported yet (ROADMAP.md); the config rejects their
knobs.

The weights are seed-initialised (``models/llama.py::init_train_params``,
masters in ``model.param_dtype``) from ``train.seed``; a torch generator
cannot draw the JAX package's numbers, so the two packages' runs start from
different weights (the tests convert one tree into the other with
``models/convert.py`` and drive ``train/step.py`` directly).

Resume is exact: the checkpoint holds the masters, the optimizer state, the
step and the data position as the batches the steps *consumed* (epoch,
batch within it), not the batches the prefetch thread produced; the run
continues the same epoch-seeded shuffle from the next batch, so N steps
straight and N/2 + restart + N/2 give the same bits.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import numpy as np
import torch

from ditl_tpu_torch.client import LLMClient, run_api_eval
from ditl_tpu_torch.config import Config
from ditl_tpu_torch.data.dataset import TextDataset, load_text_dataset
from ditl_tpu_torch.data.loader import DataPipeline
from ditl_tpu_torch.data.tokenizer import get_tokenizer
from ditl_tpu_torch.models import llama
from ditl_tpu_torch.train.checkpoint import CheckpointManager, DataIterState
from ditl_tpu_torch.train.metrics import MetricsLogger
from ditl_tpu_torch.train.state import TrainState, make_optimizer
from ditl_tpu_torch.train.step import eval_step, train_step
from ditl_tpu_torch.utils.device import resolve_device
from ditl_tpu_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)

__all__ = ["train", "split_validation", "run_validation"]


def _crossed(step: int, n_advanced: int, every: int) -> bool:
    """True if the last ``n_advanced`` steps ending at ``step`` crossed a
    multiple of ``every``."""
    return every > 0 and step > 0 and (step // every) > ((step - n_advanced) // every)


def split_validation(dataset: TextDataset, config: Config
                     ) -> tuple[TextDataset, TextDataset | None]:
    """(train, held-out) as the reference splits them: a permutation drawn
    from ``data.seed`` (a label-sorted corpus gives no one-class holdout),
    the last ``max(1, int(n * eval_fraction))`` examples held out. Raises
    unless ``data.eval_fraction`` and ``train.val_every`` are set together."""
    frac = config.data.eval_fraction
    if (frac > 0) != (config.train.val_every > 0):
        raise ValueError(
            "data.eval_fraction and train.val_every must be set together "
            f"(got eval_fraction={frac}, val_every={config.train.val_every}): one "
            "without the other either wastes held-out data or never validates")
    if frac <= 0:
        return dataset, None
    n_val = max(1, int(len(dataset) * frac))
    n_train = len(dataset) - n_val
    if n_train < 1:
        raise ValueError(f"eval_fraction {frac} leaves no training data")
    perm = np.random.default_rng(config.data.seed).permutation(len(dataset))
    texts = [dataset.texts[i] for i in perm]
    labels = [dataset.labels[i] for i in perm]
    return (TextDataset(texts[:n_train], labels[:n_train]),
            TextDataset(texts[n_train:], labels[n_train:]))


def run_validation(state: TrainState, val_batches: list[dict], model_cfg,
                   device: torch.device) -> float:
    """Token-weighted mean NLL over the held-out host batches (the
    reference's ``_run_validation``), each copied to the device per pass."""
    tot_nll = tot_tok = 0.0
    for host in val_batches:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in host.items()}
        aux = eval_step(state, batch, model_cfg)
        n = float(aux["n_tokens"])
        tot_nll += float(aux["loss"]) * n
        tot_tok += n
    return tot_nll / max(tot_tok, 1.0)


def train(config: Config, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Run the fine-tune; returns the summary (also logged)."""
    t_start = time.time()
    setup_logging()
    dev = resolve_device(device)
    model_cfg, tcfg = config.model, config.train
    tokenizer = get_tokenizer(config.data.tokenizer)
    if model_cfg.vocab_size < tokenizer.vocab_size:
        raise ValueError(
            f"model vocab {model_cfg.vocab_size} < tokenizer vocab {tokenizer.vocab_size}")
    dataset, val_dataset = split_validation(load_text_dataset(config.data), config)
    pipeline = DataPipeline(dataset, tokenizer, config.data, dev)
    logger.info("dataset: %d examples, %d steps/epoch (batch %d)", len(dataset),
                pipeline.steps_per_epoch, config.data.batch_size)
    params = llama.init_train_params(model_cfg, seed=tcfg.seed, device=dev)
    optimizer = make_optimizer(tcfg, params)
    state = TrainState.create(params, optimizer)
    n_params = sum(leaf.numel for leaf in state.leaves)
    logger.info("model %s: %.2fM params", model_cfg.name, n_params / 1e6)

    ckpt = None
    data_iter = DataIterState()
    resumed_from = None
    if tcfg.checkpoint_dir:
        ckpt = CheckpointManager(tcfg.checkpoint_dir, max_to_keep=tcfg.keep_checkpoints,
                                 save_every=tcfg.checkpoint_every)
        if tcfg.resume:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                data_iter = restored[1]
                resumed_from = state.step
                logger.info("restored checkpoint: resuming from step %d (epoch %d, "
                            "batch offset %d)", state.step, data_iter.epoch,
                            data_iter.step_in_epoch)

    val_batches = None
    if val_dataset is not None:
        # Materialised once as host batches (no shuffle, so the same every
        # pass); each pass copies them to the device.
        val_pipeline = DataPipeline(val_dataset, tokenizer,
                                    dataclasses.replace(config.data, shuffle=False), dev)
        val_batches = list(itertools.islice(val_pipeline._host_batches(0),
                                            tcfg.val_batches))
        if not val_batches:
            raise ValueError(
                f"eval_fraction {config.data.eval_fraction} holds out too few tokens for "
                f"even one validation batch (batch {config.data.batch_size} x seq "
                f"{config.data.seq_len}); increase it or shrink the batch")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    metrics = MetricsLogger(log_every=tcfg.log_every, metrics_file=tcfg.metrics_file)
    client = LLMClient(config.api)
    total_steps = tcfg.total_steps
    step_metrics = None
    last_val_loss = None
    last_saved = resumed_from
    epoch, step_in_epoch = data_iter.epoch, data_iter.step_in_epoch
    try:
        for epoch in range(data_iter.epoch, config.data.num_epochs):
            start = data_iter.step_in_epoch if epoch == data_iter.epoch else 0
            step_in_epoch = start
            for batch in pipeline.epoch(epoch, start_step=start):
                if state.step >= total_steps:
                    break
                metrics.start_step()
                step_metrics = train_step(state, batch, model_cfg, optimizer,
                                          tcfg.grad_accum_steps)
                metrics.end_step(state.step - 1, step_metrics)
                step_in_epoch += 1
                if ckpt is not None and ckpt.should_save(state.step):
                    ckpt.save(state.step, state,
                              DataIterState(epoch, step_in_epoch, state.step))
                    last_saved = state.step
                if val_batches is not None and _crossed(state.step, 1, tcfg.val_every):
                    last_val_loss = run_validation(state, val_batches, model_cfg, dev)
                    logger.info("step %d: val_loss=%.4f", state.step, last_val_loss)
                if _crossed(state.step, 1, tcfg.eval_every):
                    n = min(tcfg.eval_samples, len(dataset))
                    run_api_eval(client, [dataset[i]["text"] for i in range(n)],
                                 [dataset[i]["label"] for i in range(n)],
                                 max_samples=tcfg.eval_samples)
            if state.step >= total_steps:
                break
        metrics.flush()
        if ckpt is not None and last_saved != state.step:
            # The next batch to consume (the reference saves the epoch's
            # start here, which would replay the epoch on resume).
            ckpt.save(state.step, state, DataIterState(epoch, step_in_epoch, state.step))
        if ckpt is not None:
            ckpt.wait()  # a failed save fails the run
    finally:
        metrics.close()
        if ckpt is not None:
            ckpt.close()

    summary: dict[str, Any] = metrics.summary()
    summary["final_loss"] = (float(step_metrics["loss"]) if step_metrics is not None
                             else float("nan"))
    summary["losses"] = [row["loss"] for row in metrics.history]
    summary["steps"] = state.step
    if last_val_loss is not None:
        summary["val_loss"] = last_val_loss
    summary["resumed_from"] = resumed_from
    summary["params_m"] = n_params / 1e6
    summary["wall_s"] = time.time() - t_start
    summary["device"] = str(dev)
    if dev.type == "cuda":
        summary["peak_device_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    logger.info("training done: %s", summary)
    return summary
