"""Capability-parity device op: the JAX package's ``ops/encode.py``.

The reference's on-device workload encodes characters as float ordinals,
moves them to the device and takes their mean, one round trip per example.
Here, as in the JAX package, the texts go as one padded batch with a mask,
so padding does not bias the mean: one transfer each way. The JAX version
is a jitted XLA expression, not a Pallas kernel; this is its plain PyTorch
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ditl_tpu_torch.utils.device import resolve_device

__all__ = ["encode_texts", "encode_and_reduce"]


def encode_texts(texts: list[str], max_len: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: Unicode code points (UTF-32) -> padded (B, max_len)
    float32 + mask."""
    out = np.zeros((len(texts), max_len), dtype=np.float32)
    mask = np.zeros((len(texts), max_len), dtype=np.float32)
    for i, t in enumerate(texts):
        ords = np.frombuffer(t.encode("utf-32-le"), dtype=np.uint32)[:max_len]
        out[i, : len(ords)] = ords.astype(np.float32)
        mask[i, : len(ords)] = 1.0
    return out, mask


def encode_and_reduce(texts: list[str], max_len: int = 1024,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """Per-example masked mean of the code points, computed on ``device``:
    one copy of the batch and its mask in, one of the means out."""
    dev = resolve_device(device)
    x, mask = encode_texts(texts, max_len)
    xd = torch.from_numpy(x).to(dev)
    md = torch.from_numpy(mask).to(dev)
    means = (xd * md).sum(dim=-1) / md.sum(dim=-1).clamp_min(1.0)
    return means.cpu().numpy()
