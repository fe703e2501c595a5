"""Contiguous KV cache for lock-step decoding.

Counterpart of the JAX package's ``infer/cache.py``: ``{"k", "v"}`` of shape
(L, B, Smax, K, D) in the compute dtype, all layers stacked on axis 0. With
``ModelConfig.kv_cache_dtype == "int8"`` the cache stores int8 values plus
f32 scales ``k_scale``/``v_scale`` of shape (L, B, Smax, K), one per
(layer, row, slot, KV head): symmetric absmax over the D values written
together, as the reference. ``write_kv`` writes in place (the reference
returns a new array) and quantizes on the way in; ``read_kv`` dequantizes.
"""

from __future__ import annotations

import torch

from ditl_tpu_torch.config import ModelConfig

__all__ = ["init_cache", "write_kv", "read_kv"]


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: str | torch.device) -> dict:
    """Zero-filled cache for ``batch_size`` sequences of at most ``max_len``
    (int8: values zero, scales one)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device)}
    if cfg.kv_cache_dtype not in ("", "model"):
        raise ValueError(
            f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r} ('', 'model', 'int8')"
        )
    from ditl_tpu_torch.models.llama import torch_dtype

    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize(chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 values and f32 scales of shape (...): absmax over D
    from the f32 value, scale 1.0 for an all-zero row, round half to even,
    clip to +-127."""
    cf = chunk.float()
    absmax = cf.abs().amax(dim=-1)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.round(cf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def write_kv(layer_cache: dict, k: torch.Tensor, v: torch.Tensor, idx: int) -> dict:
    """Write a (B, S, K, D) chunk into one layer's (B, Smax, K, D) cache at
    slot ``idx`` (every row at the same depth), in place; an int8 cache
    quantizes the chunk first."""
    s = k.shape[1]
    if not 0 <= idx <= layer_cache["k"].shape[1] - s:
        raise ValueError(f"cache write [{idx}, {idx + s}) outside "
                         f"{layer_cache['k'].shape[1]} slots")
    if "k_scale" in layer_cache:
        for name, chunk in (("k", k), ("v", v)):
            q, scale = _quantize(chunk)
            layer_cache[name][:, idx:idx + s] = q
            layer_cache[f"{name}_scale"][:, idx:idx + s] = scale
        return layer_cache
    layer_cache["k"][:, idx:idx + s] = k
    layer_cache["v"][:, idx:idx + s] = v
    return layer_cache


def read_kv(layer_cache: dict, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's full (B, Smax, K, D) K/V in the compute dtype; an int8
    cache is dequantized (f32 value times scale, then cast)."""
    k, v = layer_cache["k"], layer_cache["v"]
    if "k_scale" in layer_cache:
        k = (k.float() * layer_cache["k_scale"][..., None]).to(dtype)
        v = (v.float() * layer_cache["v_scale"][..., None]).to(dtype)
        return k, v
    return k.to(dtype), v.to(dtype)
