"""Weight bridge from the JAX package's parameter tree to the port's state.

``params_from_jax`` takes the JAX ``init_params`` layout as nested dicts of
numpy arrays (layers stacked on axis 0) — what ``jax.device_get`` of the JAX
tree returns — and produces the port's serving tensors with the storage
rules of ``models/llama.py::serving_params``. ``train_params_from_jax`` turns
the same tree into the port's training masters, leaf for leaf in
``cfg.param_dtype`` (the JAX tree's
own storage), and ``params_to_numpy`` goes the other way, so the tests can
hold updated parameters leaf by leaf. Weight-only int8 leaves (``{"q",
"scale"}``, ``ops/quant.py``) pass to the serving tree as they are: ``q``
int8, ``scale`` f32; training takes float trees only. Optimizer state is never converted:
both packages' optimizers start from a fresh state. This is the bridge the
parity tests run through; the Hugging Face import and export wait for a
later slice.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ditl_tpu_torch.config import ModelConfig
from ditl_tpu_torch.models.llama import (Params, check_supported, serving_params,
                                         torch_dtype)
from ditl_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_jax", "train_params_from_jax", "params_to_numpy"]


def _tensor(x: Any, dtype: torch.dtype, device: torch.device,
            serving: bool) -> torch.Tensor | dict:
    if isinstance(x, Mapping):
        if not serving:
            raise ValueError("training masters take float weights, not int8 "
                             "{'q', 'scale'} leaves (quantize after training)")
        return {"q": torch.from_numpy(np.array(x["q"], dtype=np.int8)).to(device),
                "scale": torch.from_numpy(np.array(x["scale"], dtype=np.float32)).to(device)}
    # Go through f32 so the rounding to bf16 is PyTorch's round-to-nearest-
    # even of the f32 master, exactly the reference's astype.
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device).to(dtype)


def _convert(tree: Mapping, cfg: ModelConfig, dtype: torch.dtype,
             device: str | torch.device, serving: bool) -> Params:
    """Every leaf of a JAX tree as a tensor of ``dtype`` on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if "lora" in tree["layers"] or "moe" in tree["layers"]:
        raise NotImplementedError(
            "LoRA and MoE trees are not ported to PyTorch yet (see ROADMAP.md)"
        )

    def convert(node):
        if isinstance(node, Mapping) and not ("q" in node and "scale" in node):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dtype, dev, serving)

    return convert(tree)


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> Params:
    """JAX parameter tree (numpy leaves) -> the port's serving tree
    (``models/llama.py::serving_params`` of its f32 values)."""
    return serving_params(_convert(tree, cfg, torch.float32, device, True), cfg)


def train_params_from_jax(tree: Mapping, cfg: ModelConfig,
                          device: str | torch.device = "cuda") -> Params:
    """JAX parameter tree (numpy leaves) -> training masters: the same tree,
    every leaf in ``cfg.param_dtype`` (no separate head when tied)."""
    return _convert(tree, cfg, torch_dtype(cfg.param_dtype), device, False)


def params_to_numpy(params: Mapping) -> dict:
    """The port's parameter tree -> nested dicts of f32 numpy arrays."""
    if isinstance(params, Mapping):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()
