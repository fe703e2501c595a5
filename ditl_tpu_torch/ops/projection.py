"""Dense projection with a hand-written backward: the CUDA kernel K6 and its
plain version.

Counterpart of the JAX package's ``ops/projection.py``. ``projection(x, w)``
is ``x @ w`` (the inline path's product, bit-identical) whose backward is
chosen by ``bwd_impl``:

- ``"pallas"``: ``projection_bwd``, the wrapper of K6
  (``csrc/projection_bwd.cu``, ``ditl_proj_bwd_bf16``, replacing
  ``_bwd_kernel``), which emits ``dx = g . w^T`` and ``dw = x^T . g`` from one
  launch of the persistent GEMM core that K5b runs too
  (``csrc/gemm_sm90.cuh``). For CUDA tensors it launches the kernel or
  raises; only for CPU tensors does it run ``projection_bwd_plain``.
  ``launches`` counts launches; ``k6_tile_order`` lists the tiles in the
  order the kernel's scheduler hands them out. float16 operands take
  K6-f16 (``ditl_proj_bwd_f16``, the same kernel's float16 instance),
  counted in ``launches_f16``; float32 operands take
  K6-f32 (``csrc/gemm_f32.cu``, ``ditl_proj_bwd_f32``: 3xTF32 on the
  ``wgmma`` core that K5a-f32 and K5b-f32 run, as K5b-f32's kernel body with
  K5b-f32's two roles; dw split over the tokens by
  ``mlp_bwd.f32_proj_splits``, which counts the dx blocks beside it), counted in
  ``launches_f32``; ``kernel_route`` says which dtype takes which entry
  point.
- ``"xla"``, or a shape ``supports`` rejects: the einsum spelling
  (``projection.py:164-165`` of the reference).

``BlockSizes``, ``DEFAULT_BLOCKS``, ``_pick_blocks`` and ``supports`` are the
reference's, copied, so both packages take the kernel for the same shapes;
the CUDA kernel's tiles are its own constants. Meshes belong to the multi-GPU
slice and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ditl_tpu_torch.ops.mlp_bwd import (K5_BLOCK_K, K5_BLOCK_M, K5_BLOCK_N, _as_rows,
                                        _cdiv, _cuda_rows, _kernel, _on_card, _raster,
                                        f32_proj_splits)

__all__ = ["projection", "projection_bwd", "projection_bwd_plain", "supports",
           "effective_bwd_impl", "BlockSizes", "DEFAULT_BLOCKS", "launches",
           "launches_f16", "launches_f32", "reset_launches", "kernel_route", "proj_bwd_rows",
           "k6_dx_first", "k6_tile_order"]

NUM_LANES = 128
NUM_SUBLANES = 16


class BlockSizes(NamedTuple):
    block_n: int  # token tile
    block_d: int  # input-feature tile


DEFAULT_BLOCKS = BlockSizes(256, 256)

# K6 launches since the last reset_launches(), counted where it is launched:
# bf16, float16 and f32.
launches = 0
launches_f16 = 0
launches_f32 = 0
# dtype -> (source in csrc/, entry point, launch counter)
_ENTRIES = {
    torch.bfloat16: ("projection_bwd.cu", "ditl_proj_bwd_bf16", "launches"),
    torch.float16: ("projection_bwd.cu", "ditl_proj_bwd_f16", "launches_f16"),
    torch.float32: ("gemm_f32.cu", "ditl_proj_bwd_f32", "launches_f32"),
}


def reset_launches() -> None:
    for _, _, counter in _ENTRIES.values():
        globals()[counter] = 0


def kernel_route(dtype: torch.dtype) -> tuple[str, str]:
    """(source in ``csrc/``, entry point) of K6 on ``dtype`` operands: bf16
    and float16 in csrc/projection_bwd.cu, f32 in csrc/gemm_f32.cu; another
    dtype raises ``NotImplementedError`` naming ROADMAP.md §2."""
    if dtype not in _ENTRIES:
        raise NotImplementedError(
            f"the CUDA projection backward kernel takes bfloat16, float16 or float32, got "
            f"{dtype}: not ported (ROADMAP.md §2; proj_bwd_impl='xla' runs it)")
    return _ENTRIES[dtype][:2]


def _pick_blocks(n: int, d: int, blocks) -> BlockSizes:
    bn, bd = blocks or (0, 0)
    bn, bd = bn or DEFAULT_BLOCKS.block_n, bd or DEFAULT_BLOCKS.block_d
    return BlockSizes(min(bn, n), min(bd, d))


def supports(n: int, d: int, f: int, blocks=None) -> bool:
    """True if the backward kernel takes x (N=B*S, D) @ w (D, F)."""
    bn, bd = _pick_blocks(n, d, blocks)
    return (
        n % bn == 0
        and d % bd == 0
        and bn % NUM_SUBLANES == 0
        and bd % NUM_LANES == 0
        and f % NUM_LANES == 0
    )


def effective_bwd_impl(bwd_impl: str, b: int, s: int, d: int, f: int,
                       blocks=(), mesh=None) -> str:
    """The backward ``projection`` actually runs for a (B, S, d) @ (d, f)
    projection on one device (the reference's ``pallas_bwd_effective`` with
    ``mesh=None``)."""
    if mesh is not None:
        raise NotImplementedError("projection under a mesh belongs to the multi-GPU "
                                  "slice, not ported to PyTorch yet (see ROADMAP.md)")
    if bwd_impl != "pallas":
        return bwd_impl
    return "pallas" if supports(b * s, d, f, tuple(blocks or ())) else "xla"


def k6_dx_first(n: int, f: int) -> bool:
    """K6's order rule: the role with the longer contraction goes first, dx
    (over F) when F >= N, else dw (over the N tokens)."""
    return f >= n


def k6_tile_order(n: int, d: int, f: int, dx_first: bool | None = None
                  ) -> list[tuple[str, int, int, int]]:
    """K6's tiles at (N, D, F) in the order its scheduler hands them out
    (``csrc/gemm_sm90.cuh::proj_tile``): ``(output, row0, col0, k_tiles)``
    with ``output`` ``"dx"`` (rows tokens, columns D, contracting F) or
    ``"dw"`` (rows D, columns F, contracting N), each tile K5_BLOCK_M x
    K5_BLOCK_N (rows or columns past the output's edge masked), k-tiles of
    K5_BLOCK_K. ``dx_first`` defaults to ``k6_dx_first``."""
    bm, bn = K5_BLOCK_M, K5_BLOCK_N
    if dx_first is None:
        dx_first = k6_dx_first(n, f)
    roles = [("dx", _cdiv(n, bm), _cdiv(d, bn), _cdiv(f, K5_BLOCK_K)),
             ("dw", d // bm, _cdiv(f, bn), _cdiv(n, K5_BLOCK_K))]
    if not dx_first:
        roles.reverse()
    return [(name, tm * bm, tn * bn, nk) for name, tiles_m, tiles_n, nk in roles
            for tm, tn in _raster(tiles_m, tiles_n)]


def projection_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6 on x (..., D), w (D, F), g (..., F): ``dx = g .
    w^T`` and ``dw = x^T . g`` with f32 sums, in x's and w's dtypes."""
    d, f = w.shape
    x2, g2 = x.reshape(-1, d).float(), g.reshape(-1, f).float()
    dx = (g2 @ w.float().T).to(x.dtype).reshape(x.shape)
    dw = (x2.T @ g2).to(w.dtype)
    return dx, dw


def projection_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                   blocks=None, dx_first: bool | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``x @ w`` for x (B, S, D), w (D, F) and the output's
    gradient g (B, S, F). Raises ``ValueError`` on shapes ``supports``
    rejects. CUDA tensors launch K6 (bf16, float16 or f32, ``kernel_route``;
    mixed dtypes raise), the bf16 and float16 kernel's tiles in the order
    ``dx_first`` gives (default ``k6_dx_first``; the results are the same
    bits either way); CPU tensors run the plain version."""
    b, s, d = x.shape
    f = w.shape[1]
    n = b * s
    if g.shape != (b, s, f) or w.shape[0] != d:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and g "
                         f"{tuple(g.shape)} must be (B, S, D), (D, F), (B, S, F)")
    if not supports(n, d, f, blocks):
        raise ValueError(f"projection_bwd cannot tile N={n} D={d} F={f} (blocks={blocks})")
    if x.device.type == "cpu":
        return projection_bwd_plain(x, w, g)
    if x.device.type != "cuda":
        raise ValueError(f"projection_bwd runs on cuda or cpu, not {x.device}")
    dx, dw = proj_bwd_rows(_as_rows(x, n, d), w.contiguous(), _as_rows(g, n, f), dx_first)
    return dx.reshape(b, s, d), dw


def proj_bwd_rows(x2: torch.Tensor, w: torch.Tensor, g2: torch.Tensor,
                  dx_first: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 on CUDA tensors x2 (N, D), w (D, F), g2 (N, F) of one dtype
    (``kernel_route``'s): (dx (N, D), dw (D, F)). The dtypes are checked
    first, then the device and the layout; nothing launches on a failed
    check."""
    entry = kernel_route(x2.dtype)
    dev = x2.device
    ld_x, ld_g = _cuda_rows("x", x2, dev, x2.dtype), _cuda_rows("g", g2, dev, x2.dtype)
    _cuda_rows("w", w, dev, x2.dtype)
    _on_card(dev)
    (n, d), f = x2.shape, w.shape[1]
    dx = torch.empty((n, d), dtype=x2.dtype, device=dev)
    dw = torch.empty((d, f), dtype=w.dtype, device=dev)
    f32 = x2.dtype == torch.float32
    if f32:  # dx_first does not apply: the longer contraction per tile goes first
        splits, chunk = f32_proj_splits(n, d, f)
        # scratch: dw's split sums, when it is split
        scratch = torch.empty((splits, d, f) if splits > 1 else (0,), dtype=x2.dtype,
                              device=dev)
        tail = [splits, chunk]
    else:  # scratch: the tile counter
        scratch = torch.zeros(1, dtype=torch.int32, device=dev)
        tail = [int(k6_dx_first(n, f) if dx_first is None else dx_first)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(*entry)(x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                              dw.data_ptr(), scratch.data_ptr(), ld_x, ld_g, n, d, f, *tail,
                              stream)
    if err != 0:
        raise RuntimeError(f"projection_bwd kernel launch failed: CUDA error {err}")
    globals()[_ENTRIES[x2.dtype][2]] += 1
    return dx, dw


class _Projection(torch.autograd.Function):
    """``x @ w`` forward; K6 or the einsum spelling backward (the
    reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, w, bwd_impl, blocks):
        ctx.bwd_impl, ctx.blocks = bwd_impl, blocks
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.bwd_impl == "pallas" and supports(
                x.shape[0] * x.shape[1], x.shape[2], w.shape[1], ctx.blocks):
            # Looked up at call time, so a caller may rebind the wrapper.
            dx, dw = projection_bwd(x, w, g, blocks=ctx.blocks)
        else:
            dx = torch.einsum("bsf,df->bsd", g, w).to(x.dtype)
            dw = torch.einsum("bsd,bsf->df", x, g).to(w.dtype)
        return dx, dw, None, None


def projection(x: torch.Tensor, w: torch.Tensor, *, bwd_impl: str = "xla",
               blocks=None, mesh=None) -> torch.Tensor:
    """``x @ w`` for x (B, S, D), w (D, F) plain float, whose backward is
    dispatched per ``bwd_impl`` (``effective_bwd_impl``)."""
    b, s, d = x.shape
    eff = effective_bwd_impl(bwd_impl, b, s, d, w.shape[1], blocks, mesh)
    return _Projection.apply(x, w, eff, tuple(blocks or ()))
