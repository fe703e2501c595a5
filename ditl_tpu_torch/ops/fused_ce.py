"""Fused (blockwise) cross-entropy: lm-head product + log-softmax, chunked.

Counterpart of the JAX package's ``ops/fused_ce.py``. Tokens are processed in
blocks of ``block_tokens`` (the last block shorter; the reference pads it
with masked rows, which add nothing): each block's (block, V) f32 logits
live only inside one iteration and are reduced at once to the block's
summed masked NLL. The (N, V) logits are never materialized; the backward
recomputes each block's logits and applies the classic gradient
``(softmax - onehot) * mask * g`` (what autodiff of the reference's
checkpointed scan yields), so peak logits memory is one block's.

Products. The reference takes bf16 x bf16 products with f32 output
(``preferred_element_type=f32``). On the card the three products of a block
(logits, dx, dhead) run as bf16 tensor-core GEMMs with f32 output
(``torch.mm(..., out_dtype=torch.float32)``), never as f32 GEMMs; on the CPU
the same exact products come from f32 copies of the operands. The block's
f32 gradient of the logits is rounded to the compute dtype before the two
backward products (the reference feeds it unrounded to the transpose of its
f32-output product): a bf16 rounding of the logits' gradient, stated as the
loss-gradient tolerance in the tests. float16 lacks f32's exponent range:
the softmax part of that gradient, about ``g / V`` (8e-10 at qwen2-0.5b's
vocabulary and 8192 tokens), lies below its least subnormal (6e-8) and would
round to 0, where the reference keeps it. So the block's gradient is
multiplied by an exact power of two before the rounding (its largest
magnitude, at most ``|g|``, brought to 2^14 or below) and the two products'
f32 outputs are divided by it: the reference's values to float16's relative
precision, not a loss scale (nothing outside this op sees it). Every dtype
takes that path: for bf16 and f32, whose range holds the gradient anyway,
multiplying by a power of two and dividing by it again is exact. With f32
compute nothing is rounded.
This is a plain matmul outside any Pallas kernel, so PyTorch's matmul
computes it.
"""

from __future__ import annotations

import torch

__all__ = ["fused_cross_entropy"]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 output: exact products of the operands' values,
    summed in f32. bf16 CUDA operands run on the tensor cores."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head, targets, mask, block, compute_dtype):
        n = x.shape[0]
        hc = head.to(compute_dtype)
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        lse_all = torch.empty(n, dtype=torch.float32, device=x.device)
        for s in range(0, n, block):
            xb = x[s:s + block].to(compute_dtype)
            logits = _mm_f32(xb, hc)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, targets[s:s + block, None])[:, 0]
            nll = nll + ((lse - tgt) * mask[s:s + block]).sum()
            lse_all[s:s + block] = lse
            del logits
        ctx.save_for_backward(x, head, targets, mask, lse_all)
        ctx.block, ctx.compute_dtype = block, compute_dtype
        return nll

    @staticmethod
    def backward(ctx, g):
        x, head, targets, mask, lse_all = ctx.saved_tensors
        block, cd = ctx.block, ctx.compute_dtype
        hc = head.to(cd)
        # An exact power of two that brings |g|, the bound of every element
        # of a block's gradient, to at most 2^14 (see the module note).
        scale = torch.exp2(torch.floor(torch.log2(16384.0 / g.float().abs().clamp_min(1e-30))))
        dx = torch.empty_like(x)
        dhead = torch.zeros(head.shape, dtype=torch.float32, device=head.device)
        for s in range(0, x.shape[0], block):
            xb = x[s:s + block].to(cd)
            # p = softmax(logits) from the saved lse, minus the target's
            # one-hot, times the row's mask and the upstream gradient.
            p = torch.exp_(_mm_f32(xb, hc).sub_(lse_all[s:s + block, None]))
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, targets[s:s + block]] -= 1.0
            p.mul_((mask[s:s + block] * g * scale)[:, None])
            dlog = p.to(cd)
            del p
            dx[s:s + block] = _mm_f32(dlog, hc.t()).div_(scale).to(x.dtype)
            dhead += _mm_f32(xb.t(), dlog).div_(scale)
            del dlog
        return dx, dhead.to(head.dtype), None, None, None, None


def fused_cross_entropy(
    x: torch.Tensor,  # (N, D) final hidden states (already final-normed)
    head: torch.Tensor,  # (D, V) lm head weights
    targets: torch.Tensor,  # (N,) int target ids
    mask: torch.Tensor,  # (N,) float 0/1 loss mask
    *,
    block_tokens: int = 1024,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Summed masked NLL over all N tokens (f32 scalar), without full-logit
    materialization. Callers divide by ``mask.sum()`` themselves. Blocks of
    ``min(block_tokens, N)`` rows, as the reference cuts them."""
    n = x.shape[0]
    block = min(block_tokens, n) if n > 0 else block_tokens
    return _FusedCE.apply(x, head, targets.long(), mask.float(), block, compute_dtype)
