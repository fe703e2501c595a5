"""FlashAttention forward: the hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/flash_attention.py`` (forward only).
The kernel (``csrc/flash_fwd.cu``) replaces the Pallas ``_fwd_kernel``; its
header says how it is laid out for Hopper.

- ``flash_attention_fwd`` is the wrapper: it checks its inputs and, for CUDA
  tensors, launches the kernel or raises. Only for CPU tensors does it run
  ``flash_attention_plain``. ``launches`` counts kernel launches.
- ``flash_attention_plain`` computes what ``_fwd_kernel`` computes, in one
  pass instead of blockwise: q pre-scaled in f32, the q.k product in f32, the
  finite ``NEG_INF`` mask, p cast to v's dtype before the p.v product (f32
  accumulation), rows with a zero normaliser give 0, lse = m + log(l).

Layouts are the JAX package's: q (B, Sq, H, D), k/v (B, Skv, K, D),
segment ids (B, S) int32, o like q, lse (B, H, Sq) f32 (the TPU kernel's
lane-replicated copy without the lanes).
"""

from __future__ import annotations

import ctypes

import torch

from ditl_tpu_torch.ops.attention import NEG_INF

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain",
           "HEAD_DIMS", "launches", "reset_launches"]

HEAD_DIMS = (32, 64, 128)  # the kernel's template instances

# Kernel launches since the last reset_launches(); counted where the kernel
# is launched and nowhere else.
launches = 0

_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    global _fn
    if _fn is None:
        from ditl_tpu_torch.ops.cuda_build import load_library

        fn = load_library("flash_fwd.cu").ditl_flash_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, segment_ids) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,Sq,H,D), k/v (B,Skv,K,D)")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not divisible by kv heads {k.shape[2]}")
    if s_q == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch {q.dtype} {k.dtype} {v.dtype}")
    if segment_ids is not None:
        if segment_ids.shape != (b, s_q) or k.shape[1] != s_q:
            raise ValueError(
                f"segment_ids {tuple(segment_ids.shape)} must be (B, S) with "
                f"Sq == Skv == S (q {tuple(q.shape)}, k {tuple(k.shape)})"
            )
        if segment_ids.device != q.device:
            raise ValueError("segment_ids must be on q's device")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: returns (o, lse)."""
    b, s_q, h, d = q.shape
    s_kv, kv_heads = k.shape[1], k.shape[2]
    groups = h // kv_heads
    qf = q.float().reshape(b, s_q, kv_heads, groups, d) * d**-0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    mask = None
    if causal:
        mask = torch.ones(s_q, s_kv, dtype=torch.bool, device=q.device).tril()
        mask = mask[None, None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (pv / l_safe).permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, s_q)
    return o.to(q.dtype), lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse). CUDA tensors launch the kernel (bf16, contiguous, head_dim
    in ``HEAD_DIMS``) or raise; CPU tensors run the plain version."""
    global launches
    _check(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     segment_ids=segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, s_q, h, d = q.shape
    s_kv, kv_heads = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise ValueError(
            f"the CUDA flash kernel takes bfloat16, got {q.dtype} (use "
            "attention_impl='xla' for other dtypes)"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    seg_ptr = None
    if segment_ids is not None:
        if segment_ids.dtype != torch.int32 or not segment_ids.is_contiguous():
            raise ValueError("segment_ids must be contiguous int32")
        seg_ptr = segment_ids.data_ptr()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, o.data_ptr(),
            lse.data_ptr(), b, s_q, s_kv, h, kv_heads, d, int(causal),
            d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return o, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """FlashAttention with GQA and segment masks on the (B, S, H, D) layout."""
    return flash_attention_fwd(q, k, v, causal=causal, segment_ids=segment_ids)[0]
