"""Attention: the plain implementation and the ``impl`` dispatch.

Counterpart of the JAX package's ``ops/attention.py``. All paths take the GQA
layout q (B, S, H, D), k/v (B, S, K, D) with H % K == 0; scores and softmax
are f32 whatever the input dtype.

- ``"xla"``: ``_xla_attention``, plain PyTorch (the name is kept so a reader
  finds the counterpart).
- ``"flash"``: the CUDA flash-attention kernel (``ops/flash_attention.py``)
  where the reference runs its Pallas kernel: ``flash_attention.supports``
  must hold for the forward's and the backward's blocks (both 512, the
  reference's defaults, since the port's ``ModelConfig`` has no
  ``flash_block_*`` fields). Other shapes (D = 32, sequences that do not
  tile, such as the lock-step engine's buckets of 16-64) take
  ``_xla_attention``, as in the reference, although the port's kernels
  take D = 32 and any sequence length on a direct call.
- The explicit-mask path (KV-cache decode) is ``_xla_attention`` for every
  impl, as in the reference; over an int8 cache it takes the raw int8 K/V
  with ``k_scale``/``v_scale`` (B, Skv, K) and factors the scales out of
  the products (plain PyTorch here: the reference leaves this to XLA, no
  Pallas kernel).
- ``"ring"`` and ``"ulysses"`` wait for the multi-GPU slice.
"""

from __future__ import annotations

import torch

__all__ = ["dot_product_attention", "NEG_INF", "FLASH_BLOCK"]

NEG_INF = -2.3819763e38  # most negative bf16-representable; avoids bf16 NaNs
# The reference's default flash blocks (ditl_tpu/ops/attention.py): forward
# and backward (block_q, block_kv) alike.
FLASH_BLOCK = 512


def _xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    segment_ids: torch.Tensor | None,
    mask: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain GQA attention. ``mask`` is an explicit (B, Sq, Skv) boolean
    (True = attend). The score product accumulates in f32; the probabilities
    are cast to v's dtype before the second product, which returns v's
    dtype. With ``k_scale``/``v_scale`` (B, Skv, K) k and v are int8: they
    are converted to q's dtype, K's per-key scale multiplies the f32 scores
    after the product and V's the probabilities before their cast."""
    b, s_q, h, d = q.shape
    _, s_kv, kv_heads, _ = k.shape
    groups = h // kv_heads
    qg = q.reshape(b, s_q, kv_heads, groups, d)
    if k_scale is not None:
        k, v = k.to(q.dtype), v.to(q.dtype)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * d**-0.5
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if causal:
        causal_mask = torch.ones(s_q, s_kv, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal_mask[None, None, None], NEG_INF)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores.masked_fill(~seg_mask[:, None, None], NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    probs = probs.to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s_q, h, d)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    impl: str = "xla",
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grouped-query attention. ``segment_ids`` (B, S) int32 restricts
    attention to tokens of the same segment; ``mask`` (B, Sq, Skv) is the
    KV-cache decode path's explicit per-slot validity; ``k_scale``/``v_scale``
    mark an int8 cache's K/V (mask path only)."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not divisible by kv heads {k.shape[2]}")
    if k_scale is not None and mask is None:
        raise ValueError("quantized K/V (k_scale/v_scale) require the mask path")
    if mask is not None:
        # Decode: one query per row against the cache, bandwidth-bound;
        # the reference leaves it outside any kernel too.
        return _xla_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                              mask=mask, k_scale=k_scale, v_scale=v_scale)
    if impl == "xla":
        return _xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    if impl == "flash":
        from ditl_tpu_torch.ops import flash_attention as fa

        s_q, s_kv, d = q.shape[1], k.shape[1], q.shape[3]
        # The reference's blocks: forward (512, 512) and backward (0, 0),
        # which falls back to the forward's.
        if not fa.supports(s_q, s_kv, d, FLASH_BLOCK, FLASH_BLOCK):
            return _xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)
        return fa.flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention impl {impl!r} needs the multi-GPU slice of the port "
            "(see ROADMAP.md)"
        )
    raise ValueError(f"unknown attention impl {impl!r}")
