"""Backward of the fused-gate|up SwiGLU MLP block: the hand-written CUDA
kernels and their plain versions.

Counterpart of the JAX package's ``ops/mlp_bwd.py``. Two kernels in
``csrc/mlp_bwd.cu`` replace its two Pallas passes; the source's header says
how they are laid out for Hopper (persistent grids of 128 x 256 wgmma tiles
fed by TMA, ``csrc/gemm_sm90.cuh``):

- K5a (``ditl_mlp_bwd_dgu_dwdown_bf16``) replaces ``_dgu_dwdown_kernel``:
  ``dinner = g . w_down^T``, SwiGLU computed once from ``gate``/``up``,
  ``dgate`` and ``dup`` written into the two halves of one (N, 2F) ``dgu``
  buffer and ``inner`` into an (N, F) scratch, then ``d_w_down = inner^T .
  g`` from that scratch, in the same launch;
- K5b (``ditl_mlp_bwd_dh_dwgu_bf16``) replaces ``_dh_dwgu_kernel``:
  ``dh = dgu . w_gu^T`` and ``d_w_gu = h^T . dgu`` from that buffer.

On float16 operands the same kernels' float16 instances run (K5a-f16
``ditl_mlp_bwd_dgu_dwdown_f16``, K5b-f16 ``ditl_mlp_bwd_dh_dwgu_f16``, the
same source), counted in ``launches_dgu_f16`` and ``launches_dh_f16``.

``fused_mlp_bwd`` is the wrapper: for CUDA tensors it launches K5a then K5b
(``dgu_dwdown`` and ``dh_dwgu``, one launch each) or raises; only for CPU
tensors does it run ``fused_mlp_bwd_plain``. ``launches_dgu`` and
``launches_dh`` count the launches. ``k5_tile_order`` lists the tiles in the
order the kernels' scheduler hands them out; ``gemm_core`` runs the GEMM core
alone (its card tests).

float32 operands take K5a-f32 and K5b-f32 (``ditl_mlp_bwd_dgu_dwdown_f32``,
``ditl_mlp_bwd_dh_dwgu_f32``) in ``csrc/gemm_f32.cu``, 3xTF32 on the tensor
cores, on the source's one ``wgmma`` core from operands split once into
shared memory, which K6-f32 runs too (the source's header says how);
``kernel_route`` is the one table of dtype -> source and entry points, and
``launches_dgu_f32`` and ``launches_dh_f32`` count their wrapper calls
(K5a-f32 runs two grids a call, the dinner tiles then the d_w_down tiles).
``f32_weight_splits`` is their split-K rule for a weight gradient with few
tiles (K5b-f32's d_w_gu), ``f32_dwdown_splits`` K5a-f32's for d_w_down,
which also splits a grid of more than one wave so that its last wave is
not mostly idle, and ``f32_proj_splits`` K6-f32's for dw, which counts the
dx blocks that share its grid. The f32 kernels take any D and F that are
multiples of 4 (16-byte rows).

``BlockSizes``, ``DEFAULT_BLOCKS``, ``_pick_blocks`` and ``supports`` are the
reference's, copied: they decide which shapes take this backward
(``ops/mlp.py`` takes the einsum spelling for the others), exactly as in the
reference, so both packages run the same implementation for a given
configuration. The CUDA kernels' tiles are their own constants
(``K5_BLOCK_M`` x ``K5_BLOCK_N`` output tiles, k-tiles of ``K5_BLOCK_K``):
they take any N that is a multiple of 16 and D, F multiples of 128, which
every shape ``supports`` admits satisfies.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["fused_mlp_bwd", "fused_mlp_bwd_plain", "dgu_dwdown", "dgu_dwdown_plain",
           "dh_dwgu", "dh_dwgu_plain", "supports", "BlockSizes", "DEFAULT_BLOCKS",
           "launches_dgu", "launches_dh", "launches_dgu_f16", "launches_dh_f16",
           "launches_dgu_f32", "launches_dh_f32", "reset_launches", "kernel_route", "Route",
           "f32_weight_splits", "f32_dwdown_splits", "f32_proj_splits", "K5_BLOCK_M",
           "K5_BLOCK_N", "K5_BLOCK_K", "K5_GROUP", "F32_BLOCK", "F32_BLOCK_K",
           "F32_MAX_SPLITS", "F32_BLOCK_FIXED_K", "k5_tile_order", "gemm_core",
           "gemm_core_plain"]

NUM_LANES = 128
NUM_SUBLANES = 16  # bf16-safe sublane multiple (f32 needs only 8)


class BlockSizes(NamedTuple):
    block_n: int  # token tile (sublane dim of activation tiles)
    block_f: int  # intermediate-dim tile (pass 1)
    block_d: int  # hidden-dim tile (pass 2)


DEFAULT_BLOCKS = BlockSizes(256, 512, 128)

# The kernels' tiles (csrc/gemm_sm90.cuh): output tiles of K5_BLOCK_M rows x
# K5_BLOCK_N columns, k-tiles of K5_BLOCK_K, and column tiles taken
# K5_GROUP at a time by the grouped (L2-friendly) raster.
K5_BLOCK_M = 128
K5_BLOCK_N = 256
K5_BLOCK_K = 64
K5_GROUP = 8

# The f32 kernels' tiles (csrc/gemm_f32.cu): F32_BLOCK x F32_BLOCK output
# tiles, F32_BLOCK_K-deep stages; a weight gradient is split over its tokens
# into at most F32_MAX_SPLITS parts until its tiles cover CARD_SMS.
F32_BLOCK = 128
F32_BLOCK_K = 32
F32_MAX_SPLITS = 16
CARD_SMS = 132  # H100 SXM: a constant, so the split (and the bits) never vary
# K5a-f32's d_w_down over a grid of at least CARD_SMS tiles: at most this
# many splits (each writes and the sum reads an F x D f32 plane).
F32_DWDOWN_MAX_SPLITS = 4
# K6-f32's dw split (f32_proj_splits): a dx block's fill and epilogue,
# counted as this many k-tiles of its products (the value that makes the
# rule pick the fastest counts of ``chip_smoke.py --f32-mm --sweep``).
F32_BLOCK_FIXED_K = 6

# Kernel launches since the last reset_launches(); counted where each kernel
# is launched and nowhere else: K5a, K5b on bf16, on float16, and on f32
# (one count a wrapper call).
launches_dgu = 0
launches_dh = 0
launches_dgu_f16 = 0
launches_dh_f16 = 0
launches_dgu_f32 = 0
launches_dh_f32 = 0
# dtype -> the suffix of its launch counters.
_COUNTER_SFX = {torch.bfloat16: "", torch.float16: "_f16", torch.float32: "_f32"}

_fns: dict[str, ctypes._CFuncPtr] = {}
# Argument types of each entry point of K5 and K6 (ops/projection.py loads
# its own through _kernel too): pointers, strides, ints, the stream.
_ARGS = {
    "ditl_mlp_bwd_dgu_dwdown_bf16": [ctypes.c_void_p] * 7 + [ctypes.c_long] * 3
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "ditl_mlp_bwd_dh_dwgu_bf16": [ctypes.c_void_p] * 6 + [ctypes.c_long]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "ditl_mlp_bwd_dgu_dwdown_f16": [ctypes.c_void_p] * 7 + [ctypes.c_long] * 3
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "ditl_mlp_bwd_dh_dwgu_f16": [ctypes.c_void_p] * 6 + [ctypes.c_long]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "ditl_gemm_sm90_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_long] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "ditl_mlp_bwd_dgu_dwdown_f32": [ctypes.c_void_p] * 7 + [ctypes.c_long] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "ditl_mlp_bwd_dh_dwgu_f32": [ctypes.c_void_p] * 6 + [ctypes.c_long]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "ditl_proj_bwd_bf16": [ctypes.c_void_p] * 6 + [ctypes.c_long] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "ditl_proj_bwd_f16": [ctypes.c_void_p] * 6 + [ctypes.c_long] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "ditl_proj_bwd_f32": [ctypes.c_void_p] * 6 + [ctypes.c_long] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def reset_launches() -> None:
    for sfx in _COUNTER_SFX.values():
        globals()["launches_dgu" + sfx] = globals()["launches_dh" + sfx] = 0


class Route(NamedTuple):
    """The CUDA entry points of one dtype: the source in ``csrc/`` and the
    symbols of K5a and K5b."""
    source: str
    dgu: str
    dh: str


def kernel_route(dtype: torch.dtype) -> Route:
    """Which kernels a CUDA call on ``dtype`` operands runs: bf16 and
    float16 in csrc/mlp_bwd.cu, f32 in csrc/gemm_f32.cu. Another dtype
    raises ``NotImplementedError`` naming ROADMAP.md §2."""
    if dtype == torch.bfloat16:
        return Route("mlp_bwd.cu", "ditl_mlp_bwd_dgu_dwdown_bf16", "ditl_mlp_bwd_dh_dwgu_bf16")
    if dtype == torch.float16:
        return Route("mlp_bwd.cu", "ditl_mlp_bwd_dgu_dwdown_f16", "ditl_mlp_bwd_dh_dwgu_f16")
    if dtype == torch.float32:
        return Route("gemm_f32.cu", "ditl_mlp_bwd_dgu_dwdown_f32", "ditl_mlp_bwd_dh_dwgu_f32")
    raise NotImplementedError(
        f"the CUDA MLP and projection backward kernels take bfloat16, float16 or float32, "
        f"got {dtype}: not ported (ROADMAP.md §2; mlp_bwd_impl/proj_bwd_impl='xla' run it)")


def f32_weight_splits(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, contraction per split) of an f32 weight gradient (M x N,
    contracting over K tokens): as many splits as bring its F32_BLOCK-square
    tiles to CARD_SMS blocks, at most F32_MAX_SPLITS, each a multiple of
    F32_BLOCK_K deep, the last one the rest. (1, K) when the tiles alone
    fill the card."""
    tiles = _cdiv(m, F32_BLOCK) * _cdiv(n, F32_BLOCK)
    want = min(F32_MAX_SPLITS, max(1, _cdiv(CARD_SMS, tiles)))
    chunk = _cdiv(_cdiv(k, want), F32_BLOCK_K) * F32_BLOCK_K
    splits = _cdiv(k, chunk)
    return (1, k) if splits == 1 else (splits, chunk)


def f32_dwdown_splits(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, contraction per split) of K5a-f32's d_w_down (M = F by N = D,
    contracting over K tokens). Fewer tiles than CARD_SMS: as
    ``f32_weight_splits``. Else the count s <= F32_DWDOWN_MAX_SPLITS whose
    blocks waste least of their last wave, the least ceil(s tiles /
    CARD_SMS) / s (waves, in units of an unsplit tile's time), the smaller s
    on a tie: at path 10's 266 tiles, 3 waves unsplit, 2.25 in 4 splits.
    Each split is a multiple of F32_BLOCK_K deep, the last one the rest."""
    tiles = _cdiv(m, F32_BLOCK) * _cdiv(n, F32_BLOCK)
    if tiles < CARD_SMS:
        return f32_weight_splits(m, n, k)
    want = min(range(1, F32_DWDOWN_MAX_SPLITS + 1),
               key=lambda s: (_cdiv(s * tiles, CARD_SMS) / s, s))
    chunk = _cdiv(_cdiv(k, want), F32_BLOCK_K) * F32_BLOCK_K
    splits = _cdiv(k, chunk)
    return (1, k) if splits == 1 else (splits, chunk)


def f32_proj_splits(n: int, d: int, f: int) -> tuple[int, int]:
    """(splits, contraction per split) of K6-f32's dw (D x F, contracting
    over N tokens), whose blocks share one grid with dx's tiles (N x D,
    contracting over F): the least count, at most F32_MAX_SPLITS, whose
    splits are no deeper, in k-tiles, than the dx blocks' work a CARD_SMS
    share, each dx block counted as its k-tiles plus F32_BLOCK_FIXED_K for
    its fill and epilogue. The dw blocks then run beside the dx blocks and
    end about when those do, and no split more than that is made (each
    writes and the sum reads a D x F f32 plane). Path 10: 3 splits of 2752
    tokens at wq/wo (D = F = 896), 8 of 1024 at wk/wv (F = 128; 448 dx
    blocks of 4 k-tiles). Each split a multiple of F32_BLOCK_K deep, the
    last one the rest; (1, N) unsplit."""
    dx_work = _cdiv(n, F32_BLOCK) * _cdiv(d, F32_BLOCK) * (_cdiv(f, F32_BLOCK_K)
                                                          + F32_BLOCK_FIXED_K)
    deepest = dx_work // CARD_SMS  # k-tiles a split may take
    want = min(F32_MAX_SPLITS, _cdiv(n, deepest * F32_BLOCK_K)) if deepest else F32_MAX_SPLITS
    chunk = _cdiv(_cdiv(n, want), F32_BLOCK_K) * F32_BLOCK_K
    splits = _cdiv(n, chunk)
    return (1, n) if splits == 1 else (splits, chunk)


def _pick_blocks(n: int, d: int, f: int, blocks) -> BlockSizes:
    bn, bf, bd = blocks or (0, 0, 0)
    bn, bf, bd = (bn or DEFAULT_BLOCKS.block_n, bf or DEFAULT_BLOCKS.block_f,
                  bd or DEFAULT_BLOCKS.block_d)
    return BlockSizes(min(bn, n), min(bf, f), min(bd, d))


def supports(n: int, d: int, f: int, blocks=None) -> bool:
    """True if the backward takes (N=B*S tokens, D hidden, F intermediate)
    with these reference blocks; callers (ops/mlp.py) take the einsum
    spelling otherwise."""
    bn, bf, bd = _pick_blocks(n, d, f, blocks)
    return (
        n % bn == 0
        and f % bf == 0
        and d % bd == 0
        and bn % NUM_SUBLANES == 0
        and d % NUM_LANES == 0
        and bf % NUM_LANES == 0
        and bd % NUM_LANES == 0
    )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _raster(tiles_m: int, tiles_n: int) -> list[tuple[int, int]]:
    """(tm, tn) of every tile of a tiles_m x tiles_n grid in the kernels'
    grouped order: K5_GROUP columns at a time, the column index fastest
    within the group (``csrc/gemm_sm90.cuh::raster``)."""
    out = []
    for i in range(tiles_m * tiles_n):
        group, j = divmod(i, K5_GROUP * tiles_m)
        first = group * K5_GROUP
        width = min(K5_GROUP, tiles_n - first)
        out.append((j // width, first + j % width))
    return out


def k5_tile_order(n: int, d: int, f: int, kernel: str) -> list[tuple[str, int, int]]:
    """The tiles of K5a (``kernel="K5a"``) or K5b (``"K5b"``) at (N, D, F) in
    the order the scheduler hands them out: ``(output, row0, col0)`` with
    ``output`` one of ``"dinner"`` (K5a's activation-gradient tiles, rows
    tokens, columns F, whose epilogue writes dgu and inner), ``"d_w_down"``
    (rows F, columns D), ``"dh"`` (rows tokens, columns D) and ``"d_w_gu"``
    (rows D, columns 2F). Each tile is K5_BLOCK_M x K5_BLOCK_N; rows or
    columns past the output's edge are masked. K5a hands out every dinner
    tile first (its d_w_down tiles wait for inner); K5b every dh tile
    first."""
    bm, bn = K5_BLOCK_M, K5_BLOCK_N
    if kernel == "K5a":
        roles = [("dinner", _cdiv(n, bm), _cdiv(f, bn)), ("d_w_down", f // bm, _cdiv(d, bn))]
    elif kernel == "K5b":
        roles = [("dh", _cdiv(n, bm), _cdiv(d, bn)), ("d_w_gu", d // bm, 2 * f // bn)]
    else:
        raise ValueError(f"kernel must be 'K5a' or 'K5b', not {kernel!r}")
    return [(name, tm * bm, tn * bn) for name, tiles_m, tiles_n in roles
            for tm, tn in _raster(tiles_m, tiles_n)]


def _kernel(source: str, symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        from ditl_tpu_torch.ops.cuda_build import load_library

        fn = getattr(load_library(source), symbol)
        fn.argtypes = _ARGS[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _cuda_rows(name: str, t: torch.Tensor, device, dtype: torch.dtype) -> int:
    """What the kernels take of a 2-D operand: ``dtype`` (the route's, from
    the first operand; another raises ``ValueError``) on ``device``, unit
    column stride, 16-byte aligned rows (row strides of 8 bf16 or float16,
    or 4 f32 elements). Returns the row stride."""
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the other operands {dtype}: the kernels "
                         "take one dtype")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, not {t.device}")
    if (t.dim() != 2 or t.stride(1) != 1 or t.stride(0) % (16 // t.element_size())
            or t.data_ptr() % 16):
        raise ValueError(f"{name} must be 2-D with unit column stride and 16-byte "
                         f"aligned rows, got strides {t.stride()}")
    return t.stride(0)


def _width_off(x: int, f32: bool) -> bool:
    """Whether a width D or F is one the kernels refuse: the f32 kernels
    take multiples of 4 (16-byte rows, ragged tiles masked), the bf16 and
    float16 ones multiples of 128."""
    return bool(x % (4 if f32 else NUM_LANES))


def _on_card(device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, not {device}")


def _as_rows(t: torch.Tensor, n: int, cols: int) -> torch.Tensor:
    """(..., cols) -> (n, cols): a view where the strides allow it (gate and
    up stay views of gu), else a contiguous copy."""
    t2 = t.reshape(n, cols)
    if t2.stride(1) != 1 or t2.stride(0) % (16 // t2.element_size()) or t2.data_ptr() % 16:
        t2 = t2.contiguous()
    return t2


def dgu_dwdown_plain(g: torch.Tensor, w_down: torch.Tensor, gate: torch.Tensor,
                     up: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5a on (N, D) g, (F, D) w_down, (N, F) gate/up:
    returns (dgu (N, 2F) in g's dtype, d_w_down in w_down's dtype)."""
    dinner = g.float() @ w_down.float().T
    gate, up = gate.float(), up.float()
    sg = torch.sigmoid(gate)
    silu = gate * sg
    dgate = dinner * up * (sg * (1.0 + gate * (1.0 - sg)))
    dup = dinner * silu
    dgu = torch.cat([dgate.to(g.dtype), dup.to(g.dtype)], dim=-1)
    inner = (silu * up).to(g.dtype)
    d_w_down = (inner.float().T @ g.float()).to(w_down.dtype)
    return dgu, d_w_down


def dh_dwgu_plain(h: torch.Tensor, dgu: torch.Tensor, w_gu: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5b on (N, D) h, (N, 2F) dgu, (D, 2F) w_gu: returns
    (dh in h's dtype, d_w_gu in w_gu's dtype)."""
    dh = (dgu.float() @ w_gu.float().T).to(h.dtype)
    d_w_gu = (h.float().T @ dgu.float()).to(w_gu.dtype)
    return dh, d_w_gu


def fused_mlp_bwd_plain(h, w_gu, w_down, gate, up, g):
    """What the two Pallas passes compute, in one pass: ``dinner = g .
    w_down^T`` in f32; SwiGLU recomputed from gate/up in f32; ``dgate``,
    ``dup`` and ``inner`` rounded to g's dtype; ``d_w_down = inner^T . g``,
    ``dh = dgu . w_gu^T`` and ``d_w_gu = h^T . dgu`` with f32 sums, in the
    reference's output dtypes. Returns (dh, d_w_gu, d_w_down)."""
    b, s, d = h.shape
    f = w_down.shape[0]
    n = b * s
    dgu, d_w_down = dgu_dwdown_plain(g.reshape(n, d), w_down, gate.reshape(n, f),
                                     up.reshape(n, f))
    dh, d_w_gu = dh_dwgu_plain(h.reshape(n, d), dgu, w_gu)
    return dh.reshape(b, s, d), d_w_gu, d_w_down


def dgu_dwdown(g: torch.Tensor, w_down: torch.Tensor, gate: torch.Tensor,
               up: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5a on CUDA tensors: (N, D) g, (F, D) w_down, (N, F) gate and up, up
    at a fixed offset from gate with gate's row stride (the halves of the
    forward's gu), all of one dtype (``kernel_route``'s: bf16, float16 or
    f32). Returns (dgu (N, 2F), d_w_down (F, D)). The dtypes are checked
    first, then the device and the layout; nothing launches on a failed
    check."""
    route = kernel_route(g.dtype)
    n, d = g.shape
    f = w_down.shape[0]
    dev = g.device
    ld_g = _cuda_rows("g", g, dev, g.dtype)
    ld_gu = _cuda_rows("gate", gate, dev, g.dtype)
    if (_cuda_rows("up", up, dev, g.dtype) != ld_gu or gate.shape != (n, f)
            or up.shape != (n, f) or (up.data_ptr() - gate.data_ptr()) % 16):
        raise ValueError("gate and up must be (N, F) with one row stride and "
                         "16-byte aligned")
    w_down = w_down.contiguous()
    _cuda_rows("w_down", w_down, dev, g.dtype)
    f32 = g.dtype == torch.float32
    if w_down.shape[1] != d or _width_off(d, f32) or _width_off(f, f32):
        raise ValueError(f"w_down {tuple(w_down.shape)} must be (F, D), both "
                         f"multiples of {4 if f32 else NUM_LANES}")
    _on_card(dev)
    up_off = (up.data_ptr() - gate.data_ptr()) // g.element_size()
    dgu = torch.empty((n, 2 * f), dtype=g.dtype, device=dev)
    d_w_down = torch.empty((f, d), dtype=w_down.dtype, device=dev)
    inner = torch.empty((n, f), dtype=g.dtype, device=dev)
    if f32:  # scratch: d_w_down's split sums, when it is split
        splits, chunk = f32_dwdown_splits(f, d, n)
        scratch = torch.empty((splits, f, d) if splits > 1 else (0,), dtype=g.dtype,
                              device=dev)
    else:  # scratch: [0] the tile counter, [1 + s] the ready count of strip s
        scratch = torch.zeros(1 + _cdiv(f, K5_BLOCK_N), dtype=torch.int32, device=dev)
    args = [g.data_ptr(), w_down.data_ptr(), gate.data_ptr(), dgu.data_ptr(),
            d_w_down.data_ptr(), inner.data_ptr(), scratch.data_ptr(), ld_g, ld_gu, up_off,
            n, d, f] + ([splits, chunk] if f32 else [])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(route.source, route.dgu)(*args, stream)
    if err != 0:
        raise RuntimeError(f"mlp_bwd dgu kernel launch failed: CUDA error {err}")
    globals()["launches_dgu" + _COUNTER_SFX[g.dtype]] += 1
    return dgu, d_w_down


def dh_dwgu(h: torch.Tensor, dgu: torch.Tensor, w_gu: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5b on CUDA tensors: (N, D) h, (N, 2F) dgu, (D, 2F) w_gu, all of one
    dtype (bf16, float16 or f32). Returns (dh (N, D), d_w_gu (D, 2F))."""
    route = kernel_route(h.dtype)
    n, d = h.shape
    f2 = w_gu.shape[1]
    dev = h.device
    ld_h = _cuda_rows("h", h, dev, h.dtype)
    dgu, w_gu = dgu.contiguous(), w_gu.contiguous()
    _cuda_rows("dgu", dgu, dev, h.dtype)
    _cuda_rows("w_gu", w_gu, dev, h.dtype)
    f32 = h.dtype == torch.float32
    if (dgu.shape != (n, f2) or w_gu.shape != (d, f2) or f2 % 2 or _width_off(d, f32)
            or _width_off(f2 // 2, f32)):
        raise ValueError(f"dgu {tuple(dgu.shape)} and w_gu {tuple(w_gu.shape)} must be "
                         f"(N, 2F) and (D, 2F), D and F multiples of "
                         f"{4 if f32 else NUM_LANES}")
    _on_card(dev)
    dh = torch.empty((n, d), dtype=h.dtype, device=dev)
    d_w_gu = torch.empty((d, f2), dtype=w_gu.dtype, device=dev)
    if f32:  # scratch: d_w_gu's split sums, when it is split
        splits, chunk = f32_weight_splits(d, f2, n)
        scratch = torch.empty((splits, d, f2) if splits > 1 else (0,), dtype=h.dtype,
                              device=dev)
    else:  # scratch: the tile counter
        scratch = torch.zeros(1, dtype=torch.int32, device=dev)
    args = [h.data_ptr(), dgu.data_ptr(), w_gu.data_ptr(), dh.data_ptr(), d_w_gu.data_ptr(),
            scratch.data_ptr(), ld_h, n, d, f2 // 2] + ([splits, chunk] if f32 else [])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(route.source, route.dh)(*args, stream)
    if err != 0:
        raise RuntimeError(f"mlp_bwd dh kernel launch failed: CUDA error {err}")
    globals()["launches_dh" + _COUNTER_SFX[h.dtype]] += 1
    return dh, d_w_gu


def gemm_core_plain(a: torch.Tensor, b: torch.Tensor, a_mn: bool, b_mn: bool
                    ) -> torch.Tensor:
    """Plain version of ``gemm_core``: C = A . B in f32, rounded to a's
    dtype, with A = a (M, K) or a^T if ``a_mn`` (a is (K, M)), and B = b^T
    (b is (N, K)) or b if ``b_mn`` (b is (K, N))."""
    am = a.float().T if a_mn else a.float()
    bm = b.float() if b_mn else b.float().T
    return (am @ bm).to(a.dtype)


def gemm_core(a: torch.Tensor, b: torch.Tensor, a_mn: bool, b_mn: bool) -> torch.Tensor:
    """The kernels' GEMM core alone on CUDA tensors (bf16, row strides
    multiples of 8): C (M, N) = A . B with operands as in
    ``gemm_core_plain``, each K-major (``False``) or MN-major (``True``) in
    shared memory. Not on any model path: the card tests hold its four
    operand layouts against ``gemm_core_plain``."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"gemm_core runs on CUDA tensors, not {dev}; "
                         "gemm_core_plain is its plain version")
    lda, ldb = (_cuda_rows("a", a, dev, torch.bfloat16),
                _cuda_rows("b", b, dev, torch.bfloat16))
    k, m = a.shape if a_mn else a.shape[::-1]
    kb, n = b.shape if b_mn else b.shape[::-1]
    if k != kb:
        raise ValueError(f"contractions differ: a {tuple(a.shape)}, b {tuple(b.shape)}")
    c = torch.empty((m, n), dtype=a.dtype, device=dev)
    sched = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel("mlp_bwd.cu", "ditl_gemm_sm90_bf16")(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), sched.data_ptr(), lda, ldb, m, n, k,
            int(a_mn), int(b_mn), stream)
    if err != 0:
        raise RuntimeError(f"gemm core launch failed: CUDA error {err}")
    return c


def fused_mlp_bwd(
    h: torch.Tensor,       # (B, S, D)
    w_gu: torch.Tensor,    # (D, 2F)
    w_down: torch.Tensor,  # (F, D)
    gate: torch.Tensor,    # (B, S, F) forward residual
    up: torch.Tensor,      # (B, S, F) forward residual
    g: torch.Tensor,       # (B, S, D) output cotangent
    *,
    blocks=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused-gate|up MLP block backward: ``(dh, d_w_gu, d_w_down)``.
    Raises ``ValueError`` on shapes ``supports`` rejects, as the reference
    does. CUDA tensors launch K5a then K5b (bf16, float16 or f32,
    ``kernel_route``; operands of mixed dtypes raise); CPU tensors run the
    plain version."""
    b, s, d = h.shape
    f = w_down.shape[0]
    n = b * s
    if not supports(n, d, f, blocks):
        raise ValueError(f"fused_mlp_bwd cannot tile N={n} D={d} F={f} (blocks={blocks})")
    if h.device.type == "cpu":
        return fused_mlp_bwd_plain(h, w_gu, w_down, gate, up, g)
    if h.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd runs on cuda or cpu, not {h.device}")
    dgu, d_w_down = dgu_dwdown(_as_rows(g, n, d), w_down, _as_rows(gate, n, f),
                               _as_rows(up, n, f))
    dh, d_w_gu = dh_dwgu(_as_rows(h, n, d), dgu, w_gu)
    return dh.reshape(b, s, d), d_w_gu, d_w_down
