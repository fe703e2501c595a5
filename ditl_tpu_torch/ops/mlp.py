"""Fused-gate|up SwiGLU MLP block with a hand-written backward.

Counterpart of the JAX package's ``ops/mlp.py``. ``mlp_gu(h, w_gu, w_down)``
is a ``torch.autograd.Function``:

- forward: ``h @ w_gu`` -> gate, up -> ``(silu(gate) * up) @ w_down``, the
  same ops as the inline layer (``models/llama.py``), so its output is
  bit-identical. It saves h, w_gu, w_down and gu; gate and up are the two
  halves of gu (views, not copies).
- backward, per ``bwd_impl``: ``"pallas"`` runs ``ops/mlp_bwd.fused_mlp_bwd``
  (the CUDA kernels K5a then K5b on the card) when ``supports`` admits the
  shape; everything else runs the einsum spelling of the reference's
  ``_bwd``, which is also the ``mlp_custom_vjp=True, mlp_bwd_impl="xla"``
  path.

The reference's ``constrain`` argument is a sharding hint on a mesh; on one
device it is the identity, so the port has none. ``mlp_block`` and
``effective_bwd_impl`` take ``mesh=None`` only: a mesh belongs to the
multi-GPU slice and raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ditl_tpu_torch.ops import mlp_bwd

__all__ = ["mlp_gu", "mlp_block", "effective_bwd_impl"]


class _MlpGu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w_gu, w_down, bwd_impl, bwd_blocks):
        gu = h @ w_gu
        gate, up = gu.chunk(2, dim=-1)
        ctx.bwd_impl, ctx.bwd_blocks = bwd_impl, bwd_blocks
        ctx.save_for_backward(h, w_gu, w_down, gu)
        return (F.silu(gate) * up) @ w_down

    @staticmethod
    def backward(ctx, g):
        h, w_gu, w_down, gu = ctx.saved_tensors
        gate, up = gu.chunk(2, dim=-1)
        b, s, d = h.shape
        if ctx.bwd_impl == "pallas" and mlp_bwd.supports(
                b * s, d, w_down.shape[0], ctx.bwd_blocks):
            # Looked up at call time, so a caller may rebind the wrapper.
            dh, d_w_gu, d_w_down = mlp_bwd.fused_mlp_bwd(
                h, w_gu, w_down, gate, up, g, blocks=ctx.bwd_blocks)
            return dh, d_w_gu, d_w_down, None, None
        # The einsum spelling: the cheap elementwise pieces recomputed.
        sg = torch.sigmoid(gate)
        silu_gate = gate * sg
        inner = silu_gate * up
        d_w_down = torch.einsum("bsf,bsd->fd", inner, g).to(w_down.dtype)
        dinner = torch.einsum("bsd,fd->bsf", g, w_down)
        dgate = dinner * up * (sg * (1.0 + gate * (1.0 - sg)))
        dup = dinner * silu_gate
        dgu = torch.cat([dgate, dup], dim=-1)
        d_w_gu = torch.einsum("bsd,bsf->df", h, dgu).to(w_gu.dtype)
        dh = torch.einsum("bsf,df->bsd", dgu, w_gu).to(h.dtype)
        return dh, d_w_gu, d_w_down, None, None


def mlp_gu(h: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor,
           bwd_impl: str = "xla", bwd_blocks=()) -> torch.Tensor:
    """SwiGLU MLP over the fused gate|up layout: h (B, S, D), w_gu (D, 2F),
    w_down (F, D). ``bwd_impl`` "xla" (einsum spelling) or "pallas" (the
    kernels; ``bwd_blocks`` = the reference's (block_n, block_f, block_d),
    0/empty = its defaults)."""
    return _MlpGu.apply(h, w_gu, w_down, bwd_impl, tuple(bwd_blocks or ()))


def effective_bwd_impl(bwd_impl: str, b: int, s: int, d: int, f: int,
                       blocks=(), mesh=None) -> str:
    """The backward ``mlp_block`` actually runs for these shapes on one
    device (the reference's ``pallas_bwd_effective`` with ``mesh=None``)."""
    if mesh is not None:
        raise NotImplementedError("the MLP block under a mesh belongs to the multi-GPU "
                                  "slice, not ported to PyTorch yet (see ROADMAP.md)")
    if bwd_impl != "pallas":
        return bwd_impl
    return "pallas" if mlp_bwd.supports(b * s, d, f, tuple(blocks or ())) else "xla"


def mlp_block(h: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor, *,
              bwd_impl: str = "xla", bwd_blocks=(), mesh=None) -> torch.Tensor:
    """The custom-backward MLP block as ``models/llama.py`` calls it."""
    b, s, d = h.shape
    eff = effective_bwd_impl(bwd_impl, b, s, d, w_down.shape[0], bwd_blocks, mesh)
    return mlp_gu(h, w_gu, w_down, eff, bwd_blocks)
