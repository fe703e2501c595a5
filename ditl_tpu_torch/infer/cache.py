"""Contiguous KV cache for lock-step decoding.

Counterpart of the JAX package's ``infer/cache.py`` for float caches:
``{"k", "v"}`` of shape (L, B, Smax, K, D) in the compute dtype, all layers
stacked on axis 0. ``write_kv`` writes in place (the reference returns a new
array). int8 caches wait for the int8 slice.
"""

from __future__ import annotations

import torch

from ditl_tpu_torch.config import ModelConfig

__all__ = ["init_cache", "write_kv", "read_kv"]


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: str | torch.device) -> dict:
    """Zero-filled cache for ``batch_size`` sequences of at most ``max_len``."""
    if cfg.kv_cache_dtype not in ("", "model"):
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported to PyTorch "
            "yet (see ROADMAP.md)"
        )
    from ditl_tpu_torch.models.llama import torch_dtype

    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_kv(layer_cache: dict, k: torch.Tensor, v: torch.Tensor, idx: int) -> dict:
    """Write a (B, S, K, D) chunk into one layer's (B, Smax, K, D) cache at
    slot ``idx`` (every row at the same depth), in place."""
    s = k.shape[1]
    if not 0 <= idx <= layer_cache["k"].shape[1] - s:
        raise ValueError(f"cache write [{idx}, {idx + s}) outside "
                         f"{layer_cache['k'].shape[1]} slots")
    layer_cache["k"][:, idx:idx + s] = k
    layer_cache["v"][:, idx:idx + s] = v
    return layer_cache


def read_kv(layer_cache: dict, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's full (B, Smax, K, D) K/V in the compute dtype."""
    return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)
