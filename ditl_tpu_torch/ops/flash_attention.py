"""FlashAttention: the hand-written CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/flash_attention.py``. The kernels
replace the Pallas ones; each source's header says how it is laid out for
Hopper:

- K1 ``csrc/flash_fwd.cu`` replaces ``_fwd_kernel``: ``ditl_flash_fwd_bf16``
  and, on float16 operands, ``ditl_flash_fwd_f16`` (K1-f16, the same
  kernel's float16 instance);
- K2a (``ditl_flash_bwd_dq_bf16``) and K2b (``ditl_flash_bwd_dkv_bf16``) in
  ``csrc/flash_bwd.cu`` replace ``_dq_kernel`` and ``_dkv_kernel``, and on
  float16 operands ``ditl_flash_bwd_dq_f16`` / ``ditl_flash_bwd_dkv_f16``
  (K2a-f16, K2b-f16, the same kernels' float16 instances);
- on float32 operands, K1-f32, K2a-f32 and K2b-f32 in ``csrc/flash_f32.cu``
  (``ditl_flash_fwd_f32``, ``ditl_flash_bwd_dq_f32``,
  ``ditl_flash_bwd_dkv_f32``) replace the same three kernels, which the
  reference runs for any float dtype with f32 sums. All three run their
  products as 3xTF32 on the tensor cores: K1-f32 on wgmma from operands
  split once into shared memory (``f32_fwd_block``, ``f32_fwd_visits``),
  K2a-f32 and K2b-f32 on mma.sync; K2b-f32 splits each KV
  head's (group head, query tile) items into runs when its grid would not
  fill the card (``f32_dkv_splits``; ``ditl_flash_bwd_dkv_split_f32`` over a
  workspace, the runs summed in order by a second kernel).

- ``kernel_route`` is the one rule for which entry point a CUDA call takes,
  from (dtype, head_dim, the forward or one of the backward's two
  kernels): bf16 and float16 at D in ``HEAD_DIMS`` all three, f32 at D in
  ``F32_HEAD_DIMS`` all three; other head dims raise
  ``NotImplementedError`` naming ROADMAP.md §2.
- ``supports`` and ``_pick_blocks`` are the reference's, copied (with its
  ``NUM_LANES``/``NUM_SUBLANES``): the shapes for which the reference's
  ``dot_product_attention(impl="flash")`` runs its kernel at all.
  ``ops/attention.py`` takes the same rule, so both packages send the same
  shapes to the kernels and the rest to plain attention; the kernels
  themselves take more (D = 32, any sequence length) on a direct call.
- ``flash_attention_fwd`` / ``flash_attention_bwd`` are the wrappers: they
  check their inputs and, for CUDA tensors, launch the kernels or raise.
  Only for CPU tensors do they run ``flash_attention_plain`` /
  ``flash_attention_bwd_plain``. ``launches``, ``launches_dq`` and
  ``launches_dkv`` count the bf16 kernels' launches, ``launches_f16``,
  ``launches_dq_f16`` and ``launches_dkv_f16`` the float16 ones',
  ``launches_f32``, ``launches_dq_f32`` and ``launches_dkv_f32`` the f32
  ones'.
- ``flash_attention_plain`` computes what ``_fwd_kernel`` computes, in one
  pass instead of blockwise: q pre-scaled in f32, the q.k product in f32, the
  finite ``NEG_INF`` mask, p cast to v's dtype before the p.v product (f32
  accumulation), rows with a zero normaliser give 0, lse = m + log(l).
- ``flash_attention_bwd_plain`` computes the reference backward's formulas
  (``_bwd_impl``) in one pass, in f32: p = exp(s - lse) from the saved lse,
  delta = rowsum(do * o), ds = p (do.v^T - delta), dq = scale ds.k,
  dk = ds^T.(scale q), dv = p^T.do, GQA summed over the group, p and ds
  kept in f32 as the reference keeps them (the kernels round them to the
  operands' dtype for their tensor-core products); the gradients in the
  operands' dtype. It is not autograd of the plain forward.
- ``f32_dkv_splits`` is K2b-f32's split rule, a pure function of the shapes
  and an SM count (CARD_SMS on every card, so the bits never vary);
  ``f32_dkv_runs`` lists the items each run walks.
- ``tile_schedule`` is the kernels' rule for which (query tile, key tile)
  pairs they visit (causal diagonal and segment-id ranges), as a boolean
  map, at K1's, K2a's or K2b's tiling; the CPU tests hold that it covers
  every admitted pair and that masking the rest changes nothing.
- ``flash_attention`` is differentiable: a ``torch.autograd.Function`` saves
  q, k, v, o and lse from the forward and calls ``flash_attention_bwd``.
  Forward and backward look the wrappers up at call time, so one forward
  launches K1 once and one backward K2a and K2b once each.

Layouts are the JAX package's: q (B, Sq, H, D), k/v (B, Skv, K, D),
segment ids (B, S) int32, o like q, lse (B, H, Sq) f32 (the TPU kernel's
lane-replicated copy without the lanes).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ditl_tpu_torch.ops.attention import NEG_INF
from ditl_tpu_torch.ops.mlp_bwd import CARD_SMS

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain", "tile_schedule",
           "fwd_block_kv", "FWD_BLOCK_Q", "FWD_WARPGROUP_ROWS", "BWD_DQ_BLOCK_Q",
           "bwd_dkv_block_kv", "BWD_DKV_BLOCK_Q", "BWD_DKV_WARPGROUP_KEYS", "HEAD_DIMS",
           "F32_HEAD_DIMS", "F32_BLOCK", "F32_MAX_SEQ", "f32_fwd_block", "f32_fwd_visits",
           "f32_bwd_block", "f32_dkv_splits",
           "f32_dkv_runs", "F32_DKV_MAX_SPLITS", "CARD_SMS", "kernel_route", "supports",
           "BlockSizes", "launches", "launches_dq", "launches_dkv", "launches_f16",
           "launches_dq_f16", "launches_dkv_f16", "launches_f32", "launches_dq_f32",
           "launches_dkv_f32", "reset_launches"]

# The reference's tiling rule (ditl_tpu/ops/flash_attention.py): its kernel
# tiles (block_q, block_kv) blocks of (8, 128)-tiled vregs.
NUM_LANES = 128
NUM_SUBLANES = 8


class BlockSizes(NamedTuple):
    block_q: int
    block_kv: int


def _pick_blocks(s_q: int, s_kv: int, block_q: int, block_kv: int) -> BlockSizes:
    return BlockSizes(min(block_q, s_q), min(block_kv, s_kv))


def supports(s_q: int, s_kv: int, head_dim: int, block_q: int = 512,
             block_kv: int = 512) -> bool:
    """True if the reference's kernel takes these shapes (its callers fall
    back to plain attention otherwise): blocks that tile both sequences,
    key blocks a multiple of 128 and query blocks of 8, and D = 64 or a
    multiple of 128."""
    bq, bkv = _pick_blocks(s_q, s_kv, block_q, block_kv)
    return (
        s_q % bq == 0
        and s_kv % bkv == 0
        and bkv % NUM_LANES == 0
        and bq % NUM_SUBLANES == 0
        and (head_dim == 64 or head_dim % NUM_LANES == 0)
    )


HEAD_DIMS = (32, 64, 128, 256)  # the bf16 and float16 kernels' template instances
# The f32 kernels' instances: the reference's own head dims up to 256
# (``supports``: D = 64 or D % 128 == 0).
F32_HEAD_DIMS = (64, 128, 256)
# K1-f32's tiles (csrc/flash_f32.cu): a block of ``f32_fwd_block(d)[0]``
# query rows marks the F32_BLOCK-key tiles it visits,
# ``tile_schedule(ids, causal, s, s, f32_fwd_block(d)[0], F32_BLOCK)``, at
# most 4096 of them (F32_MAX_SEQ positions), and walks each in sub-tiles of
# ``f32_fwd_block(d)[1]`` keys (``f32_fwd_visits``). K2a-f32 and K2b-f32
# take square tiles of ``f32_bwd_block(head_dim)``: 64 at D = 64 and 128, 32
# at D = 256, so ``tile_schedule(ids, causal, s, s, f32_bwd_block(d),
# f32_bwd_block(d))`` is the map of each (K2b-f32 reads it by columns).
F32_BLOCK = 64
F32_MAX_SEQ = 4096 * F32_BLOCK
# K2b-f32's split: a grid under two waves of CARD_SMS blocks (the H100 SXM's
# SMs, a constant as in K6-f32's split, so the runs and the bits never vary)
# is split into at most F32_DKV_MAX_SPLITS runs.
F32_DKV_MAX_SPLITS = 16
# K1's tiles (csrc/flash_fwd.cu): a block owns FWD_BLOCK_Q query rows, each
# of its two consumer warpgroups FWD_WARPGROUP_ROWS of them, and walks the
# keys in tiles of fwd_block_kv(head_dim).
FWD_BLOCK_Q = 128
FWD_WARPGROUP_ROWS = 64
# K2a's tiles (csrc/flash_bwd.cu) are K1's: BWD_DQ_BLOCK_Q query rows a
# block, FWD_WARPGROUP_ROWS a warpgroup, key tiles of fwd_block_kv(head_dim).
# K2b's block owns bwd_dkv_block_kv(head_dim) keys, each warpgroup
# BWD_DKV_WARPGROUP_KEYS of them (at D = 256 both the block's 64, each on
# half the columns), and walks the query rows in tiles of BWD_DKV_BLOCK_Q:
# ``tile_schedule(ids, causal, s, s, BWD_DKV_BLOCK_Q, bwd_dkv_block_kv(d))``
# is its map, read by columns.
BWD_DQ_BLOCK_Q = 128
BWD_DKV_WARPGROUP_KEYS = 64
BWD_DKV_BLOCK_Q = 64


def fwd_block_kv(head_dim: int) -> int:
    """K1's and K2a's key-tile width at ``head_dim``
    (``Cfg<D>::kBlockN``, ``DqCfg<D>::kBlockN``)."""
    return {32: 128, 256: 32}.get(head_dim, 64)


def bwd_dkv_block_kv(head_dim: int) -> int:
    """K2b's keys a block at ``head_dim`` (``DkvCfg<D>::kBlockN``)."""
    return 64 if head_dim == 256 else 128


def f32_fwd_block(head_dim: int) -> tuple[int, int]:
    """K1-f32's (query rows a block, keys a sub-tile) at ``head_dim``
    (``Fwd<D>::kRows``, ``Fwd<D>::kN``): two warpgroups of 64 rows each over
    64-key sub-tiles at D = 64 and 32-key ones at D = 128; at D = 256, where
    Q's split halves alone fill 128 KB of shared memory at 64 rows, both
    warpgroups take the block's 64 rows, each half of the head dim, over
    16-key sub-tiles."""
    if head_dim not in F32_HEAD_DIMS:
        raise ValueError(f"K1-f32 takes head_dim in {F32_HEAD_DIMS}, got {head_dim}")
    return {64: (128, 64), 128: (128, 32), 256: (64, 16)}[head_dim]


def f32_fwd_visits(segment_ids: torch.Tensor | None, causal: bool, s_q: int, s_kv: int,
                   head_dim: int) -> torch.Tensor:
    """(B, Sq, Skv) boolean map (B = 1 without segment ids) of the (query
    row, key) pairs whose products K1-f32 computes: a block visits the
    F32_BLOCK-key tiles of ``tile_schedule`` at its ``f32_fwd_block`` rows,
    in sub-tiles; each 64-row warpgroup skips, when causal, the sub-tiles
    that start past its last row (they hold no admitted pair)."""
    rows, sub = f32_fwd_block(head_dim)
    tiles = tile_schedule(segment_ids, causal, s_q, s_kv, rows, F32_BLOCK)
    visit = tiles.repeat_interleave(rows, dim=1).repeat_interleave(F32_BLOCK, dim=2)
    visit = visit[:, :s_q, :s_kv]
    if causal:
        device = visit.device
        wg_last = ((torch.arange(s_q, device=device) // 64 + 1) * 64).clamp(max=s_q) - 1
        sub_first = torch.arange(s_kv, device=device) // sub * sub
        visit = visit & (sub_first[None, :] <= wg_last[:, None])[None]
    return visit


def f32_bwd_block(head_dim: int) -> int:
    """K2a-f32's query rows a block and keys a streamed tile, K2b-f32's keys
    a block and query rows a streamed tile, at ``head_dim``
    (``Bwd<D>::kR``)."""
    return 32 if head_dim == 256 else 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def f32_dkv_splits(batch: int, kv_heads: int, groups: int, s_q: int, s_kv: int,
                   head_dim: int, sms: int = CARD_SMS) -> tuple[int, int]:
    """(runs, items a run) of K2b-f32 (``chunk`` in csrc/flash_f32.cu). A
    block owns ``f32_bwd_block(head_dim)`` keys of one KV head and walks the
    head's items, (group head, query tile) in the folded order i = g n_q +
    t. When KV heads x batch x key tiles is under two waves of ``sms``
    blocks, the items are cut into as many runs of equal length as bring
    the grid to two waves, at most F32_DKV_MAX_SPLITS and at most one an
    item; else (1, every item). The wrapper takes ``sms`` = CARD_SMS on
    every card."""
    block = f32_bwd_block(head_dim)
    items = groups * _cdiv(s_q, block)
    blocks = kv_heads * batch * _cdiv(s_kv, block)
    want = min(F32_DKV_MAX_SPLITS, items, _cdiv(2 * sms, blocks))
    if blocks >= 2 * sms or want <= 1:
        return 1, items
    chunk = _cdiv(items, want)
    return _cdiv(items, chunk), chunk


def f32_dkv_runs(splits: int, chunk: int, groups: int, n_q: int) -> list[list[tuple[int, int]]]:
    """The (group head, query tile) items each run of K2b-f32 walks, in its
    order (before tile skipping): run r takes items [r chunk, (r + 1) chunk)
    of the folded order, the last one the rest."""
    items = groups * n_q
    return [[divmod(i, n_q) for i in range(r * chunk, min(items, (r + 1) * chunk))]
            for r in range(splits)]

# Kernel launches since the last reset_launches(); counted where each kernel
# is launched and nowhere else: K1, K2a, K2b on bf16, on float16 and on f32.
launches = 0
launches_dq = 0
launches_dkv = 0
launches_f16 = 0
launches_dq_f16 = 0
launches_dkv_f16 = 0
launches_f32 = 0
launches_dq_f32 = 0
launches_dkv_f32 = 0

_fns: dict[str, ctypes._CFuncPtr] = {}
# Pointer arguments of each kind of entry point; then 7 ints, the scale and
# the stream. K2b-f32's split form takes the workspace as a tenth pointer
# and the runs and their length as two more ints.
_PTRS = {"fwd": 6, "dq": 8, "dkv": 9}
_DKV_SPLIT_F32 = "ditl_flash_bwd_dkv_split_f32"
# (dtype, kind) -> (source in ``csrc/``, symbol, launch counter), and the
# head dims each dtype's kernels take.
_ENTRIES = {
    (torch.bfloat16, "fwd"): ("flash_fwd.cu", "ditl_flash_fwd_bf16", "launches"),
    (torch.bfloat16, "dq"): ("flash_bwd.cu", "ditl_flash_bwd_dq_bf16", "launches_dq"),
    (torch.bfloat16, "dkv"): ("flash_bwd.cu", "ditl_flash_bwd_dkv_bf16", "launches_dkv"),
    (torch.float16, "fwd"): ("flash_fwd.cu", "ditl_flash_fwd_f16", "launches_f16"),
    (torch.float16, "dq"): ("flash_bwd.cu", "ditl_flash_bwd_dq_f16", "launches_dq_f16"),
    (torch.float16, "dkv"): ("flash_bwd.cu", "ditl_flash_bwd_dkv_f16", "launches_dkv_f16"),
    (torch.float32, "fwd"): ("flash_f32.cu", "ditl_flash_fwd_f32", "launches_f32"),
    (torch.float32, "dq"): ("flash_f32.cu", "ditl_flash_bwd_dq_f32", "launches_dq_f32"),
    (torch.float32, "dkv"): ("flash_f32.cu", "ditl_flash_bwd_dkv_f32", "launches_dkv_f32"),
}
_DIMS = {torch.bfloat16: HEAD_DIMS, torch.float16: HEAD_DIMS, torch.float32: F32_HEAD_DIMS}


def reset_launches() -> None:
    for _, _, counter in _ENTRIES.values():
        globals()[counter] = 0


def kernel_route(dtype: torch.dtype, head_dim: int, kind: str = "fwd") -> tuple[str, str]:
    """The entry point a CUDA call of ``kind`` ("fwd": K1; "dq", "dkv": the
    backward's K2a, K2b) on ``dtype`` operands at ``head_dim`` takes, as
    (source in ``csrc/``, symbol): bf16 and float16 at D in ``HEAD_DIMS``
    (csrc/flash_fwd.cu, csrc/flash_bwd.cu), f32 at D in ``F32_HEAD_DIMS``
    (csrc/flash_f32.cu). The rest, which the reference computes where
    ``supports`` holds (D = 384, ...), raises ``NotImplementedError`` naming
    ROADMAP.md §2."""
    if kind not in _PTRS:
        raise ValueError(f"kind must be one of {tuple(_PTRS)}, got {kind!r}")
    if dtype not in _DIMS:
        raise NotImplementedError(
            f"the CUDA flash kernels take bfloat16, float16 or float32, got {dtype}: not "
            "ported (ROADMAP.md §2; attention_impl='xla' runs it)")
    if head_dim not in _DIMS[dtype]:
        raise NotImplementedError(
            f"the CUDA flash kernels take {dtype} at head_dim in {_DIMS[dtype]}, got "
            f"head_dim {head_dim}: not ported yet (ROADMAP.md §2; attention_impl='xla' "
            "runs it)")
    return _ENTRIES[(dtype, kind)][:2]


def _kernel(entry: tuple[str, str], kind: str):
    fn = _fns.get(entry[1])
    if fn is None:
        from ditl_tpu_torch.ops.cuda_build import load_library

        fn = getattr(load_library(entry[0]), entry[1])
        if entry[1] == _DKV_SPLIT_F32:
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * _PTRS[kind] + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[entry[1]] = fn
    return fn


def _run_dkv(entry: tuple[str, str], common: tuple, dk: int, dv: int, sizes: tuple,
             device: torch.device) -> int:
    """K2b, K2b-f16 or K2b-f32 on preallocated dk and dv (pointers) with
    the wrapper's ``common`` pointers and ``sizes``; K2b-f32 over a
    workspace of ``f32_dkv_splits``' runs when it splits. Returns the entry
    point's error code."""
    b, s_q, s_kv, h, kv_heads, d, causal, scale, stream = sizes
    if entry[1] == "ditl_flash_bwd_dkv_f32":
        splits, chunk = f32_dkv_splits(b, kv_heads, h // kv_heads, s_q, s_kv, d)
        if splits > 1:
            work = torch.empty((2, splits, b, s_kv, kv_heads, d), dtype=torch.float32,
                               device=device)
            return _kernel((entry[0], _DKV_SPLIT_F32), "dkv")(
                *common, dk, dv, work.data_ptr(), b, s_q, s_kv, h, kv_heads, d, causal, splits,
                chunk, scale, stream)
    return _kernel(entry, "dkv")(*common, dk, dv, *sizes)


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


def _check_cuda(segment_ids, kinds, **tensors) -> tuple[list, int | None]:
    """What the CUDA kernels of ``kinds`` take: ``kernel_route``'s dtypes and
    head dims (anything else raises ``NotImplementedError``), contiguous,
    16-byte aligned, int32 segment ids; f32 sequences up to
    ``F32_MAX_SEQ``. Returns each kind's entry point and the segment ids'
    pointer (None without them)."""
    q = tensors["q"]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    route = [kernel_route(q.dtype, q.shape[3], kind) for kind in kinds]
    if q.dtype == torch.float32 and max(q.shape[1], tensors["k"].shape[1]) > F32_MAX_SEQ:
        raise ValueError(f"the f32 flash kernels take sequences up to {F32_MAX_SEQ}, "
                         f"got q {tuple(q.shape)} k {tuple(tensors['k'].shape)}")
    for name, t in tensors.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if segment_ids is None:
        return route, None
    if segment_ids.dtype != torch.int32 or not segment_ids.is_contiguous():
        raise ValueError("segment_ids must be contiguous int32")
    return route, segment_ids.data_ptr()


def _mask(s_q, s_kv, causal, segment_ids, device):
    """(B or 1, 1, 1, Sq, Skv) boolean mask (True = attend), or None."""
    mask = None
    if causal:
        mask = torch.ones(s_q, s_kv, dtype=torch.bool, device=device).tril()
        mask = mask[None, None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    return mask


def _id_ranges(ids: torch.Tensor, block: int, n: int):
    """Per tile of ``block`` positions: (min, max) of the ids of its real
    positions, each (B, n)."""
    pad = n * block - ids.shape[1]
    info = torch.iinfo(torch.int32)
    lo = torch.nn.functional.pad(ids, (0, pad), value=info.max).view(-1, n, block)
    hi = torch.nn.functional.pad(ids, (0, pad), value=info.min).view(-1, n, block)
    return lo.amin(-1), hi.amax(-1)


def tile_schedule(
    segment_ids: torch.Tensor | None,
    causal: bool,
    s_q: int,
    s_kv: int,
    block_q: int,
    block_kv: int,
) -> torch.Tensor:
    """(B, n_q_tiles, n_kv_tiles) boolean map of the (query tile, key tile)
    pairs K1 visits (B = 1 without segment ids), under the kernel's rule: a
    pair is visited unless (a) causal and the key tile starts past the query
    tile's last row, or (b) the two tiles' segment-id ranges [min, max] are
    disjoint (then they share no id, so no pair in them is admitted, for
    any ids, sorted or not). Only real positions (< s_q, < s_kv) count.

    ``block_q=FWD_BLOCK_Q`` gives the tiles K1's producer loads;
    ``block_q=FWD_WARPGROUP_ROWS`` the tiles each consumer warpgroup
    computes (it skips the loaded tiles its own rows do not reach)."""
    n_q, n_kv = -(-s_q // block_q), -(-s_kv // block_kv)
    device = segment_ids.device if segment_ids is not None else None
    q_last = (torch.arange(n_q, device=device) * block_q + block_q).clamp(max=s_q) - 1
    k_first = torch.arange(n_kv, device=device) * block_kv
    visit = torch.ones(1, n_q, n_kv, dtype=torch.bool, device=device)
    if causal:
        visit = visit & (k_first[None, :] <= q_last[:, None])[None]
    if segment_ids is not None:
        ids = segment_ids.to(torch.int32)
        q_lo, q_hi = _id_ranges(ids[:, :s_q], block_q, n_q)
        k_lo, k_hi = _id_ranges(ids[:, :s_kv], block_kv, n_kv)
        visit = visit & (k_lo[:, None, :] <= q_hi[:, :, None]) \
            & (k_hi[:, None, :] >= q_lo[:, :, None])
    return visit


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
    mask = _mask(s_q, s_kv, causal, segment_ids, q.device)
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
    """(o, lse). CUDA tensors launch K1, K1-f16 or K1-f32 (``kernel_route``;
    contiguous) or raise; CPU tensors run the plain version. Takes every
    shape the kernels take (``supports`` is the model's rule for calling
    it, not this wrapper's)."""
    _check(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     segment_ids=segment_ids)
    (entry,), seg_ptr = _check_cuda(segment_ids, ["fwd"], q=q, k=k, v=v)
    b, s_q, h, d = q.shape
    s_kv, kv_heads = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(entry, "fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, o.data_ptr(),
            lse.data_ptr(), b, s_q, s_kv, h, kv_heads, d, int(causal),
            d**-0.5, stream,
        )
    _count(q.dtype, "fwd", err)
    return o, lse


def _count(dtype: torch.dtype, kind: str, err: int) -> None:
    """Raise on a refused launch, else count it on its kernel's counter."""
    _, symbol, counter = _ENTRIES[(dtype, kind)]
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    globals()[counter] += 1


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2a and K2b: returns (dq, dk, dv)."""
    b, s_q, h, d = q.shape
    s_kv, kv_heads = k.shape[1], k.shape[2]
    groups = h // kv_heads
    scale = d**-0.5
    qs = q.float().reshape(b, s_q, kv_heads, groups, d) * scale
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, s_q, kv_heads, groups, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, kf)
    mask = _mask(s_q, s_kv, causal, segment_ids, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse.float().reshape(b, kv_heads, groups, s_q)[..., None])
    delta = (dof * o.float().reshape(b, s_q, kv_heads, groups, d)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = scale * torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qs)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dq.reshape(b, s_q, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs, its o and lse, and the
    output's gradient ``do``. CUDA tensors launch K2a then K2b, or their
    float16 or f32 forms (``kernel_route``; contiguous), or raise; float16
    runs them on ``do`` rescaled by an exact power of two (see below). CPU
    tensors run the plain version."""
    _check(q, k, v, segment_ids)
    b, s_q, h, d = q.shape
    s_kv, kv_heads = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s_q):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be "
                         f"like q {tuple(q.shape)}, lse {tuple(lse.shape)} "
                         f"(B, H, Sq)")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         segment_ids=segment_ids)
    (dq_entry, dkv_entry), seg_ptr = _check_cuda(segment_ids, ["dq", "dkv"], q=q, k=k, v=v,
                                                 o=o, do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("lse must be contiguous float32 on q's device")
    unscale = None
    if q.dtype == torch.float16:
        # float16 lacks f32's range: a float16 training step's output
        # gradients lie among its subnormals, where the kernels' float16
        # rounding of dS for their second products (the reference keeps dS
        # in f32) would lose them. An exact power of two brings do's largest
        # magnitude into (2^-5, 2^-4]; every gradient, and delta, is linear
        # in do, so the kernels run on the rescaled do and their outputs are
        # multiplied back in f32 before their rounding to float16.
        peak = do.abs().amax().float().clamp_min(2.0**-24)
        unscale = torch.exp2(torch.ceil(torch.log2(peak)) + 4)
        do = (do.float() / unscale).to(q.dtype)
    # delta = rowsum(do * o) in f32, outside the kernels as in the reference
    # (the product upcasts o itself: one f32 copy fewer, the same values).
    delta = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), seg_ptr)
        sizes = (b, s_q, s_kv, h, kv_heads, d, int(causal), d**-0.5, stream)
        _count(q.dtype, "dq", _kernel(dq_entry, "dq")(*common, dq.data_ptr(), *sizes))
        _count(q.dtype, "dkv", _run_dkv(dkv_entry, common, dk.data_ptr(), dv.data_ptr(), sizes,
                                        q.device))
    if unscale is not None:
        dq, dk, dv = ((t.float() * unscale).to(t.dtype) for t in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2a + K2b backward (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     segment_ids=segment_ids)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, segment_ids=segment_ids)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Differentiable FlashAttention with GQA and segment masks on the
    (B, S, H, D) layout."""
    return _FlashAttention.apply(q, k, v, segment_ids, causal)
