"""Loss and the train step.

Counterpart of the JAX package's ``train/step.py``. ``loss_fn`` is the
masked next-token cross-entropy with f32 logits, through the naive head
(``(B, S, V)`` logits) or the fused blockwise one (``ops/fused_ce.py``).
``train_step`` is the reference's step on one device:

- each microbatch casts the f32 masters to the compute dtype once (leaves
  under a ``norm`` key stay as they are) and back-propagates its own mean
  loss;
- ``grad_accum_steps`` microbatches (the batch's rows cut into equal
  chunks) are summed into the gradients, then divided by their count;
- ``grad_norm`` is the f32 global norm of those raw gradients;
- the optimizer (``train/state.py``) clips, updates and applies
  ``p + u.astype(p.dtype)`` in place.

The metrics stay on the device (``loss``, ``n_tokens``, ``grad_norm``); the
metrics logger copies them to the host at its flush. ``eval_step`` is the
reference's ``make_eval_step``: the forward alone, under ``torch.no_grad``
(so without remat), returning the batch's mean NLL and its token count.
"""

from __future__ import annotations

from typing import Any

import torch

from ditl_tpu_torch.config import ModelConfig
from ditl_tpu_torch.models import llama
from ditl_tpu_torch.train.state import TrainState, global_norm

__all__ = ["loss_fn", "train_step", "eval_step", "cast_for_compute"]


def loss_fn(layers: list[dict], top: dict, batch: dict[str, torch.Tensor],
            cfg: ModelConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(mean masked NLL, {"loss", "n_tokens"}) for one batch; ``layers`` and
    ``top`` as ``llama.train_forward`` takes them."""
    targets = batch["input_ids"][:, 1:].long()
    mask = batch["loss_mask"][:, 1:].float()
    n_tokens = torch.clamp(mask.sum(), min=1.0)
    fused = cfg.loss_impl == "fused"
    out = llama.train_forward(
        layers, top, batch["input_ids"], cfg, positions=batch.get("positions"),
        segment_ids=batch.get("segment_ids"), return_hidden=fused,
    )
    if fused:
        from ditl_tpu_torch.ops.fused_ce import fused_cross_entropy

        d = out.shape[-1]
        nll_sum = fused_cross_entropy(
            out[:, :-1].reshape(-1, d), llama.head_weights(top, cfg),
            targets.reshape(-1), mask.reshape(-1),
            block_tokens=cfg.loss_block_tokens,
            compute_dtype=llama.torch_dtype(cfg.dtype),
        )
        ce = nll_sum / n_tokens
    else:
        logits = out[:, :-1]
        logz = torch.logsumexp(logits, dim=-1)
        target_logit = logits.gather(-1, targets[..., None])[..., 0]
        ce = ((logz - target_logit) * mask).sum() / n_tokens
    return ce, {"loss": ce, "n_tokens": mask.sum()}


def cast_for_compute(cfg: ModelConfig):
    """``(path, tensor) -> tensor``: f32 masters to the compute dtype, norm
    scales and other dtypes as they are (the reference's per-step cast)."""
    cd = llama.torch_dtype(cfg.dtype)

    def cast(path: tuple[str, ...], t: torch.Tensor) -> torch.Tensor:
        if cd == torch.float32 or any("norm" in k for k in path):
            return t
        return t.to(cd) if t.dtype == torch.float32 else t

    return cast


def train_step(state: TrainState, batch: dict[str, torch.Tensor],
               model_cfg: ModelConfig, optimizer, grad_accum_steps: int = 1
               ) -> dict[str, Any]:
    """One optimizer step on ``batch``; updates ``state`` in place and
    returns the step's device metrics."""
    accum = grad_accum_steps
    b = batch["input_ids"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not divisible by grad_accum_steps {accum}")
    cast = cast_for_compute(model_cfg)
    for leaf in state.leaves:
        for p in leaf.parts:
            p.grad = None
    loss_sum = tokens = 0
    for i in range(accum):
        mb = {k: v[i * (b // accum):(i + 1) * (b // accum)] for k, v in batch.items()}
        layers, top = state.model_views(cast)
        loss, aux = loss_fn(layers, top, mb, model_cfg)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        tokens = tokens + aux["n_tokens"]
        del layers, top, loss
    with torch.no_grad():
        if accum > 1:
            for leaf in state.leaves:
                for p in leaf.parts:
                    p.grad.div_(accum)
        grad_norm = global_norm(state.leaves)
        optimizer.step(state.leaves, state.opt_state)
        for leaf in state.leaves:
            for p in leaf.parts:
                p.grad = None
    state.step += 1
    return {"loss": loss_sum / accum, "n_tokens": tokens, "grad_norm": grad_norm}


@torch.no_grad()
def eval_step(state: TrainState, batch: dict[str, torch.Tensor],
              model_cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """``{"loss", "n_tokens"}`` of ``batch`` under the state's masters, cast
    for compute as the train step casts them; no gradients."""
    layers, top = state.model_views(cast_for_compute(model_cfg))
    _, aux = loss_fn(layers, top, batch, model_cfg)
    return aux
