"""The training loop on one device.

Counterpart of ``ditl_tpu.train.trainer.train``, the subset that one card
runs: tokenizer -> dataset -> pipeline -> train state -> step loop ->
summary. Goodput accounting, the anomaly plane and flight recorder,
checkpointing, validation, API eval, profiling and multi-step calls are not
ported yet (ROADMAP.md); the config rejects their knobs.

The weights are seed-initialised (``models/llama.py::init_train_params``,
masters in ``model.param_dtype``) from ``train.seed``; a torch generator
cannot draw the JAX package's numbers, so the two packages' runs start from
different weights (the tests convert one tree into the other with
``models/convert.py`` and drive ``train/step.py`` directly).
"""

from __future__ import annotations

import time
from typing import Any

import torch

from ditl_tpu_torch.config import Config
from ditl_tpu_torch.data.dataset import load_text_dataset
from ditl_tpu_torch.data.loader import DataPipeline
from ditl_tpu_torch.data.tokenizer import get_tokenizer
from ditl_tpu_torch.models import llama
from ditl_tpu_torch.train.metrics import MetricsLogger
from ditl_tpu_torch.train.state import TrainState, make_optimizer
from ditl_tpu_torch.train.step import train_step
from ditl_tpu_torch.utils.device import resolve_device
from ditl_tpu_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)

__all__ = ["train"]


def train(config: Config, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Run the fine-tune; returns the summary (also logged)."""
    t_start = time.time()
    setup_logging()
    dev = resolve_device(device)
    model_cfg = config.model
    tokenizer = get_tokenizer(config.data.tokenizer)
    if model_cfg.vocab_size < tokenizer.vocab_size:
        raise ValueError(
            f"model vocab {model_cfg.vocab_size} < tokenizer vocab {tokenizer.vocab_size}")
    dataset = load_text_dataset(config.data)
    pipeline = DataPipeline(dataset, tokenizer, config.data, dev)
    logger.info("dataset: %d examples, %d steps/epoch (batch %d)", len(dataset),
                pipeline.steps_per_epoch, config.data.batch_size)
    params = llama.init_train_params(model_cfg, seed=config.train.seed, device=dev)
    optimizer = make_optimizer(config.train, params)
    state = TrainState.create(params, optimizer)
    n_params = sum(leaf.numel for leaf in state.leaves)
    logger.info("model %s: %.2fM params", model_cfg.name, n_params / 1e6)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    metrics = MetricsLogger(log_every=config.train.log_every,
                            metrics_file=config.train.metrics_file)
    total_steps = config.train.total_steps
    step_metrics = None
    try:
        for epoch in range(config.data.num_epochs):
            for batch in pipeline.epoch(epoch):
                if state.step >= total_steps:
                    break
                metrics.start_step()
                step_metrics = train_step(state, batch, model_cfg, optimizer,
                                          config.train.grad_accum_steps)
                metrics.end_step(state.step - 1, step_metrics)
            if state.step >= total_steps:
                break
    finally:
        metrics.close()

    summary: dict[str, Any] = metrics.summary()
    summary["final_loss"] = (float(step_metrics["loss"]) if step_metrics is not None
                             else float("nan"))
    summary["losses"] = [row["loss"] for row in metrics.history]
    summary["steps"] = state.step
    summary["params_m"] = n_params / 1e6
    summary["wall_s"] = time.time() - t_start
    summary["device"] = str(dev)
    if dev.type == "cuda":
        summary["peak_device_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    logger.info("training done: %s", summary)
    return summary
