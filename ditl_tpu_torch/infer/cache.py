"""Contiguous KV cache for lock-step decoding.

Counterpart of the JAX package's ``infer/cache.py``: ``{"k", "v"}`` of shape
(L, B, Smax, K, D) in the compute dtype, all layers stacked on axis 0. With
``ModelConfig.kv_cache_dtype == "int8"`` the cache stores int8 values plus
f32 scales ``k_scale``/``v_scale`` of shape (L, B, Smax, K), one per
(layer, row, slot, KV head): symmetric absmax over the D values written
together, as the reference. ``write_kv`` writes in place (the reference
returns a new array) and quantizes on the way in; ``read_kv`` dequantizes.

``write_kv`` takes a scalar slot (every row at the same depth) or a (B,)
tensor of per-row slots (the continuous engine's decode and verify, where
each row sits at its own depth): ``_scatter_rows`` is the reference's
gather-and-select formulation (positions past the cache are dropped),
copied into the cache; a one-token write is an indexed write of the B
slots instead, with the same result.
``scatter_tail`` does the same for the paged decode tick's tail buffer.
"""

from __future__ import annotations

import torch

from ditl_tpu_torch.config import ModelConfig

__all__ = ["init_cache", "write_kv", "read_kv", "scatter_tail"]


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


def _scatter_rows(cache: torch.Tensor, chunk: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """``cache`` (B, Smax, ...) with ``chunk`` (B, S, ...) written at per-row
    slot offsets ``idx`` (B,), as a new tensor: the reference's gather and
    select over the whole slot axis (slots past Smax are dropped; no host
    sync)."""
    s, smax = chunk.shape[1], cache.shape[1]
    tail = (1,) * (cache.dim() - 2)
    rel = torch.arange(smax, device=cache.device)[None, :] - idx.long()[:, None]
    in_chunk = (rel >= 0) & (rel < s)
    src = rel.clamp(0, s - 1).reshape(rel.shape + tail).expand(-1, -1, *chunk.shape[2:])
    gathered = chunk.to(cache.dtype).gather(1, src)
    return torch.where(in_chunk.reshape(in_chunk.shape + tail), gathered, cache)


def scatter_tail(tail: torch.Tensor, chunk: torch.Tensor, off: torch.Tensor) -> None:
    """Write ``chunk`` (B, K, S, D) into the paged decode tick's tail buffer
    ``tail`` (B, K, T, D) at per-row column offsets ``off`` (B,), in place
    (the reference returns a new buffer): the speculative verify's
    (k+1)-token write, each slot at its own tail depth."""
    t = tail.transpose(1, 2)  # (B, T, K, D) views
    tail.copy_(_scatter_rows(t, chunk.transpose(1, 2), off).transpose(1, 2))


def write_kv(layer_cache: dict, k: torch.Tensor, v: torch.Tensor,
             idx: int | torch.Tensor) -> dict:
    """Write a (B, S, K, D) chunk into one layer's (B, Smax, K, D) cache at
    slot ``idx``, in place: a scalar (every row at the same depth) or a (B,)
    tensor of per-row slots (the speculative verify). An int8 cache
    quantizes the chunk first."""
    s = k.shape[1]
    names = ("k", "v")
    chunks = {"k": k, "v": v}
    if "k_scale" in layer_cache:
        names = ("k", "v", "k_scale", "v_scale")
        (chunks["k"], chunks["k_scale"]), (chunks["v"], chunks["v_scale"]) = (
            _quantize(k), _quantize(v))
    if isinstance(idx, torch.Tensor) and idx.dim() == 1:
        if s == 1:
            # one token a row (the contiguous decode step): an indexed write
            # of the B slots; a row whose slot lies outside the cache writes
            # back the value already at its clamped slot
            rows = torch.arange(idx.shape[0], device=idx.device)
            smax = layer_cache["k"].shape[1]
            at = idx.long().clamp(0, smax - 1)
            keep = (idx >= 0) & (idx < smax)
            for name in names:
                c = layer_cache[name]
                m = keep.reshape((-1,) + (1,) * (c.dim() - 2))
                c[rows, at] = torch.where(m, chunks[name][:, 0].to(c.dtype), c[rows, at])
            return layer_cache
        for name in names:
            layer_cache[name].copy_(_scatter_rows(layer_cache[name], chunks[name], idx))
        return layer_cache
    idx = int(idx)
    if not 0 <= idx <= layer_cache["k"].shape[1] - s:
        raise ValueError(f"cache write [{idx}, {idx + s}) outside "
                         f"{layer_cache['k'].shape[1]} slots")
    for name in names:
        layer_cache[name][:, idx:idx + s] = chunks[name]
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
