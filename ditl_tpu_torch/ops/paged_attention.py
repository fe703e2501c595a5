"""Paged decode attention: the hand-written CUDA kernels and their plain version.

Counterpart of the JAX package's ``ops/paged_attention.py``. KV lives in a
shared pool of pages; per-slot page tables map logical block -> physical
page. ``csrc/paged_attention.cu`` holds two kernels, one per Pallas kernel:

- **K3** (``ditl_paged_tail_bf16``, replaces ``_paged_tail_kernel``): the
  decode tick's kernel. Positions [0, min(starts, lengths)) come from the
  pages, [starts, lengths) from the tick's contiguous tail buffer.
- **K3 over int8 pools** (``ditl_paged_tail_i8``, replaces
  ``_paged_tail_kernel`` with ``quantized=True``): the same with int8 pools
  and f32 scales ``k_scale``/``v_scale`` of shape (P, K, 1, ps), one per
  (page, KV head, position); the tail stays bf16. K's scale multiplies the
  f32 score of its key after the product; V's scale multiplies p in the
  numerator only (the row sum l adds the unscaled p). The decode tick of
  ``kv_cache_dtype="int8"`` runs it.
- **K4** (``ditl_paged_bf16``, replaces ``_paged_kernel``): the same without
  a tail, positions [0, lengths) from the pages. No serving path calls it
  (as in the JAX package, where only its tests do).

- **K3's multi-query verify** (``ditl_paged_verify_bf16`` and
  ``ditl_paged_verify_i8``, replace ``_paged_tail_kernel`` with
  ``q_groups``): the speculative verify's 4-D q (B, Q, H, D), Q consecutive
  query tokens per slot sharing every page fetch. Row r = qi * G + g of a KV
  head sees the tail columns j with ``starts + j < lengths + qi`` (causal
  within the verify chunk); page columns keep one limit for every row.

All run as split-key flash-decoding: a slot's keys lie on one axis, its
``max_pages * page_size`` page positions then (K3) its ``T`` tail positions,
cut into splits of ``split_keys`` positions (``SPLIT_KEYS``, or 256 for a
bf16 or float16 call of many query rows and an f32 verify of more); one
block per (split, KV head,
slot) walks its split's live ``TILE_KEYS``-key tiles with an online softmax
and writes a partial (m, l, acc) per query row, and a second kernel merges
the partials in split order. The grid comes from shapes alone, so the
wrapper never reads ``lengths`` or ``starts`` back from the card. In bf16
and float16 the single query at up to ``SINGLE_ROWS`` query rows a KV head
takes ``paged_split_kernel``; the verify and any call with more rows take
``paged_rows_kernel`` (one warp per 16-row tile, softmax in registers, all
of a KV head's rows in one block).

Tail masks, as the Pallas kernel's: the tail is read only when ``lengths >
starts`` (its ``_tail`` gate), and then query qi sees tail column j when
``starts + j < lengths + qi``. Single-query, the gate changes nothing; in the
verify form it differs from ``paged_attention_xla`` only for slots with
``0 < lengths <= starts``, which no engine produces (a live slot has
``lengths = pos + 1`` and ``starts <= pos``). The plain version, the split
twin and the kernels all apply it.

- ``paged_attention`` is the wrapper, with the JAX signature: it checks its
  inputs and, for CUDA tensors, launches K3 (with a tail; its int8 form
  with scales; its verify form for 4-D q with Q > 1) or K4 (without) or
  raises. Only for CPU tensors does it run ``paged_attention_plain``.
  ``launches_tail``, ``launches_tail_int8``, ``launches_verify``,
  ``launches_verify_int8`` and ``launches`` count K3, K3 over int8 pools,
  the verify over float and over int8 pools, and K4 launches. A 4-D q with
  Q = 1 runs the single-query kernel (the reference passes no ``q_groups``
  then), so it gives the 3-D call's bits.
- ``paged_attention_plain`` computes what ``paged_attention_xla`` computes:
  gather the pages, append the tail, mask with the finite ``NEG_INF``, f32
  scores and softmax, p cast to v's dtype before the p.v product (f32
  accumulation), zeros for dead slots (length 0), 3-D or 4-D q. Over int8
  pools it computes what the reference kernel's quantized branch computes:
  scores of the exact int8 values times K's scale, p times V's scale in
  f32 for the page columns (no rounding), the tail columns as the float
  branch.
- ``paged_attention_split_plain`` computes the same in the kernels' order:
  each split's partial tile by tile, then the combine (the tests hold it to
  the JAX package; it is on no serving path).

- **On float32 operands** (``csrc/paged_attention_f32.cu``, the same Pallas
  kernels, which the reference runs for any float dtype with f32 sums):
  ``ditl_paged_tail_f32`` (K3-f32), ``ditl_paged_verify_f32`` (its verify)
  and ``ditl_paged_f32`` (K4-f32), counted in ``launches_tail_f32``,
  ``launches_verify_f32`` and ``launches_f32``; over int8 pools (variant
  F) ``ditl_paged_tail_i8_f32`` and ``ditl_paged_verify_i8_f32``
  (``launches_tail_int8_f32``, ``launches_verify_int8_f32``): the int8
  values and their scales in f32, p times V's scale never rounded. All run
  on the tensor cores (3xTF32 ``mma.sync``: an int8 key or V row is exact
  in TF32, so two products where an f32 row takes three), over small int8
  staging tiles or f32 tiles, in m16 row tiles of 16 query rows (the
  verify past 16 rows two a block over int8 pools, up to three over f32
  pools).
- **On float16 operands** (``csrc/paged_attention.cu``, the bf16 template's
  float16 instances): ``ditl_paged_tail_f16``, ``ditl_paged_verify_f16``,
  ``ditl_paged_f16`` and over int8 pools ``ditl_paged_tail_i8_f16``,
  ``ditl_paged_verify_i8_f16``, counted in ``launches_tail_f16``,
  ``launches_verify_f16``, ``launches_f16``, ``launches_tail_int8_f16`` and
  ``launches_verify_int8_f16``.

``kernel_route`` picks the entry point from (q's dtype, head_dim, int8
pools, verify, tail), and ``_SOURCES`` its source; other dtypes and head
dims outside ``HEAD_DIMS`` (every multiple of 16 up to 256) raise
``NotImplementedError`` naming ROADMAP.md §2. Each entry point takes any
head_dim of ``HEAD_DIMS`` on the smallest of its template instances
(``INSTANCE_DIMS``) that holds it, columns past head_dim zero in shared
memory, and any number of query heads per KV head and of verify rows: past
a block's rows (8 single-query, 16 for K3-f32, K4-f32 and K3-int8-f32, 192
in the bf16 and float16 row-tile kernel at D = 128, 32 for
K3-int8-f32-verify, 48 for K3-f32-verify, 32 at D = 256) it
runs blocks of rows side by side, each over the split's keys (the sources'
"Row groups"; each row's arithmetic, and so ``paged_attention_split_plain``,
is the same in any grouping).

Layouts are the JAX package's: q (B, H, D) or (B, Q, H, D); pools (P, K,
ps, D); page table (B, maxp) int32; lengths and starts (B,) int32; tails
(B, K, T, D); output shaped as q.

Not ported yet (ROADMAP.md): the mesh-sharded form.
"""

from __future__ import annotations

import ctypes

import torch

from ditl_tpu_torch.ops.attention import NEG_INF

__all__ = ["paged_attention", "paged_attention_plain", "paged_attention_split_plain",
           "split_count", "split_keys", "kernel_route", "HEAD_DIMS", "INSTANCE_DIMS",
           "SPLIT_KEYS", "SINGLE_ROWS", "LONG_SPLIT", "LONG_SPLIT_ROWS", "LONG_SPLIT_ROWS_F32",
           "TILE_KEYS",
           "launches", "launches_tail", "launches_tail_int8", "launches_verify",
           "launches_verify_int8", "launches_f32", "launches_tail_f32",
           "launches_verify_f32", "launches_tail_int8_f32", "launches_verify_int8_f32",
           "launches_f16", "launches_tail_f16", "launches_verify_f16",
           "launches_tail_int8_f16", "launches_verify_int8_f16", "reset_launches"]

# The head dims every entry point takes: each multiple of 16 up to 256 (a
# row of any dtype is then whole 16-byte chunks), on the smallest template
# instance of INSTANCE_DIMS that holds it.
HEAD_DIMS = tuple(range(16, 257, 16))
INSTANCE_DIMS = (32, 64, 128, 256)
TILE_KEYS = 64  # keys per tile inside a split (csrc kTile)
# Positions per split, a multiple of TILE_KEYS: 128 was the fastest of 128,
# 256 and 512 at the decode tick on the card (PERF.md).
SPLIT_KEYS = 128
# Query rows a KV head that the single-query kernel takes (csrc kSingleRows);
# the bf16 and float16 calls with more, and every verify, take the row-tile
# kernel. Its partials grow with the rows, so a call with at least
# LONG_SPLIT_ROWS query rows in all (B * Q * H: the spec tick of llama3-8b,
# 8 x 9 x 32) takes splits of LONG_SPLIT keys; a smaller call keeps the
# shorter splits that give its grid blocks enough to fill the card (PERF.md
# §6).
SINGLE_ROWS = 8
LONG_SPLIT = 256
LONG_SPLIT_ROWS = 2304
# The f32 verify over f32 pools takes LONG_SPLIT keys from this many query
# rows a call (path 16's 144- and 80-row verifies, 9216 and 5120 rows: 6%
# faster than 128 on the card; path 11's 2304 rows 10% slower, PERF.md §6).
LONG_SPLIT_ROWS_F32 = 4608

# Kernel launches since the last reset_launches(); counted where each kernel
# is launched and nowhere else. ``launches_tail`` is K3 over bf16 pools,
# ``launches_tail_int8`` K3 over int8 pools, ``launches_verify`` and
# ``launches_verify_int8`` its multi-query verify over bf16 and int8 pools,
# ``launches`` K4, all with bf16 q; the same names with ``_f32`` or ``_f16``
# count the kernels of f32 or float16 q.
launches = 0
launches_tail = 0
launches_tail_int8 = 0
launches_verify = 0
launches_verify_int8 = 0
launches_f32 = 0
launches_tail_f32 = 0
launches_verify_f32 = 0
launches_tail_int8_f32 = 0
launches_verify_int8_f32 = 0
launches_f16 = 0
launches_tail_f16 = 0
launches_verify_f16 = 0
launches_tail_int8_f16 = 0
launches_verify_int8_f16 = 0

_fns: dict[str, ctypes._CFuncPtr] = {}
# Entry point suffix of each q dtype over float pools and over int8 pools,
# and the source that holds its kernels.
_DTYPES = {torch.bfloat16: ("_bf16", "_i8", "paged_attention.cu"),
           torch.float16: ("_f16", "_i8_f16", "paged_attention.cu"),
           torch.float32: ("_f32", "_i8_f32", "paged_attention_f32.cu")}


def _entry_points():
    """Entry point -> (pointer arguments, int arguments), then the scale and
    the stream; entry point -> its launch counter; entry point -> its
    source."""
    args, counters, sources = {}, {}, {}
    for float_sfx, int8_sfx, source in _DTYPES.values():
        counter_sfx = "" if float_sfx == "_bf16" else float_sfx
        for name, n_args, counter in (
                ("ditl_paged_tail" + float_sfx, (11, 9), "launches_tail"),
                ("ditl_paged_verify" + float_sfx, (11, 10), "launches_verify"),
                ("ditl_paged" + float_sfx, (8, 8), "launches"),
                ("ditl_paged_tail" + int8_sfx, (13, 9), "launches_tail_int8"),
                ("ditl_paged_verify" + int8_sfx, (13, 10), "launches_verify_int8")):
            args[name] = n_args
            counters[name] = counter + counter_sfx
            sources[name] = source
    return args, counters, sources


_ARGS, _COUNTERS, _SOURCES = _entry_points()


def reset_launches() -> None:
    for name in _COUNTERS.values():
        globals()[name] = 0


def kernel_route(dtype: torch.dtype, head_dim: int, *, int8: bool, verify: bool,
                 tail: bool) -> str:
    """The entry point a CUDA call takes: bf16 or float16 q over pools of
    its dtype or int8 (``csrc/paged_attention.cu``), f32 q over f32 or int8
    pools (``csrc/paged_attention_f32.cu``; ``_SOURCES`` maps each entry
    point to its source); K3 with a tail, its verify for a 4-D q with Q >
    1, K4 without a tail (never over int8 pools); each entry point takes
    every head dim of ``HEAD_DIMS`` (multiples of 16 up to 256). Other
    dtypes and head dims, which the reference computes (its paged kernel
    takes any D), raise ``NotImplementedError`` naming ROADMAP.md §2."""
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"the CUDA paged-attention kernels take bfloat16, float16 or float32, got "
            f"{dtype}: not ported (ROADMAP.md §2)")
    if head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA paged-attention kernels take head_dim a multiple of 16 up to 256, "
            f"got head_dim {head_dim}: not ported yet (ROADMAP.md §2)")
    suffix = _DTYPES[dtype][1 if int8 else 0]
    if not tail:
        if int8 or verify:
            raise ValueError("int8 pools and the multi-query verify need the tail path")
        return "ditl_paged" + suffix
    return ("ditl_paged_verify" if verify else "ditl_paged_tail") + suffix


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ditl_tpu_torch.ops.cuda_build import load_library

        fn = getattr(load_library(_SOURCES[name]), name)
        n_ptr, n_int = _ARGS[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    tail_k: torch.Tensor | None = None,
    tail_v: torch.Tensor | None = None,
    starts: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels (the JAX package's
    ``paged_attention_xla``, with the Pallas kernel's tail gate of the
    module note; over int8 pools with ``k_scale``/``v_scale``, the
    reference kernel's quantized arithmetic): returns q's shape, (B, H, D)
    or (B, Q, H, D), in q's dtype."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, nq, h, d = q.shape
    _, kv_heads, ps, _ = k_pages.shape
    maxp = page_table.shape[1]
    groups = h // kv_heads
    table = page_table.long()
    n_page = maxp * ps
    # (B, maxp, K, ps, D) -> (B, maxp * ps, K, D)
    k = k_pages[table].transpose(2, 3).reshape(b, n_page, kv_heads, d)
    v = v_pages[table].transpose(2, 3).reshape(b, n_page, kv_heads, d)
    quant = k_scale is not None
    if quant:  # int8 values are exact in f32; per-key scales (B, K, n_page)
        k, v = k.float(), v.float()
        ks, vs = (_key_scales(sc, table) for sc in (k_scale, v_scale))
    page_limit = lengths if starts is None else torch.minimum(starts, lengths)
    cols = torch.arange(n_page, device=q.device)
    valid = (cols[None, :] < page_limit[:, None])[:, None].expand(b, nq, n_page)
    if tail_k is not None:
        t = tail_k.shape[2]
        k = torch.cat([k, tail_k.transpose(1, 2).to(k.dtype)], dim=1)
        v = torch.cat([v, tail_v.transpose(1, 2).to(v.dtype)], dim=1)
        valid = torch.cat([valid, _tail_valid(lengths, starts, nq, t)], dim=2)
    qg = q.reshape(b, nq, kv_heads, groups, d)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float()) * d**-0.5
    if quant:  # K's scale on the page columns' f32 scores, after the product
        scores = torch.cat([scores[..., :n_page] * ks[:, None, :, None],
                            scores[..., n_page:]], dim=-1)
    scores = scores.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # Dead slots (length 0) have an all-masked row: zeros, not a uniform mix.
    probs = torch.where((lengths > 0)[:, None, None, None, None], probs, 0.0)
    if quant:
        # Page columns: p times V's scale in f32; tail columns as the float
        # branch (p rounded to the tail's dtype).
        tail_p = probs[..., n_page:]
        if tail_v is not None:
            tail_p = tail_p.to(tail_v.dtype).float()
        pw = torch.cat([probs[..., :n_page] * vs[:, None, :, None], tail_p], dim=-1)
    else:
        pw = probs.to(v.dtype).float()
    out = torch.einsum("bqkgs,bskd->bqkgd", pw, v.float())
    out = out.reshape(b, nq, h, d).to(q.dtype)
    return out[:, 0] if squeeze else out


def _tail_valid(lengths: torch.Tensor, starts: torch.Tensor, nq: int,
                t: int) -> torch.Tensor:
    """(B, Q, T): tail column j is live for query qi when the slot has a tail
    (``lengths > starts``, the Pallas kernel's gate) and ``starts + j <
    lengths + qi``."""
    j = torch.arange(t, device=lengths.device)
    qi = torch.arange(nq, device=lengths.device)
    limit = lengths[:, None] + qi[None, :]  # (B, Q)
    live = starts[:, None, None] + j[None, None, :] < limit[:, :, None]
    return live & (lengths > starts)[:, None, None]


def _key_scales(scale: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, K, 1, ps) scale pool -> (B, K, maxp * ps): each slot's per-key
    scales in the order of its gathered page positions."""
    g = scale[table][:, :, :, 0, :]  # (B, maxp, K, ps)
    b, maxp, kv, ps = g.shape
    return g.permute(0, 2, 1, 3).reshape(b, kv, maxp * ps)


def split_count(max_pages: int, page_size: int, tail_len: int, split: int) -> int:
    """Splits per (slot, KV head): ``max_pages * page_size + tail_len``
    positions (``tail_len`` 0 for K4) in runs of ``split``. Shapes only:
    never lengths or starts."""
    return -(-(max_pages * page_size + tail_len) // split)


def split_keys(q: torch.Tensor, k_pages: torch.Tensor) -> int:
    """Positions per split of a call with q (B, H, D) or (B, Q, H, D) over
    pools (P, K, ps, D): ``LONG_SPLIT`` for bf16 and float16 past
    ``SINGLE_ROWS`` query rows a KV head (Q * G) where the call holds at
    least ``LONG_SPLIT_ROWS`` query rows in all (B * Q * H), and for the f32
    verify over f32 pools from ``LONG_SPLIT_ROWS_F32`` rows; else
    ``SPLIT_KEYS``. Shapes only, so the grid stays free of device-to-host
    syncs; the CUDA wrapper launches with it and
    ``paged_attention_split_plain`` takes it by default."""
    b, h = q.shape[0], q.shape[-2]
    nq = q.shape[1] if q.dim() == 4 else 1
    if q.dtype == torch.float32:
        long = nq > 1 and k_pages.dtype == torch.float32 and b * nq * h >= LONG_SPLIT_ROWS_F32
    else:
        long = nq * (h // k_pages.shape[1]) > SINGLE_ROWS and b * nq * h >= LONG_SPLIT_ROWS
    return LONG_SPLIT if long else SPLIT_KEYS


def paged_attention_split_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    tail_k: torch.Tensor | None = None,
    tail_v: torch.Tensor | None = None,
    starts: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    split: int | None = None,
) -> torch.Tensor:
    """What K3 (with a tail), its verify form (4-D q) and K4 (without)
    compute, in their order: each ``split``-position run of a slot's axis
    (pages, then the tail) gives a partial per query row from its
    ``TILE_KEYS``-key tiles that hold a key live for any row, each an
    online-softmax step (f32 q.k sums scaled in f32, the finite mask value on
    the row's dead columns, p relative to the split's running max and cast
    to v's dtype before p.v, l adding the f32 p), and the partials merge in
    split order, rescaled by exp(m_s - max m) in f32. Page ids clamp into
    the pool. Returns q's shape in q's dtype; a dead slot gives zeros.

    The rule for rows with nothing live in a split (a verify row qi whose
    tail limit ends before a split that later rows reach): the row's m stays
    the mask value, its p is exp(0) = 1 on every column of the split's
    processed tiles, so l and acc hold junk; the merge gives a partial whose
    m is the mask value weight 0, as the kernel's merge does. Every row of a
    live slot has a live key (tail column 0 at least), so its largest m is
    a real score.

    Over int8 pools (``k_scale``/``v_scale``), as ``ditl_paged_tail_i8``:
    the exact int8 values, each page key's f32 score times its K scale,
    and p times its V scale (1 on the tail) cast to the tail's dtype before
    p.v; l adds the unscaled p.

    The kernels' row groups (blocks of rows side by side when a KV head has
    more query rows than a block takes) change no row's arithmetic: each
    row's partials come from the same tiles, live by the union over the
    slot's Q queries, in the same order, so this twin has no row groups.

    ``split`` defaults to the kernels' own length, ``split_keys(q,
    k_pages)``."""
    if split is None:
        split = split_keys(q, k_pages)
    if split % TILE_KEYS or split < TILE_KEYS:
        raise ValueError(f"split must be a positive multiple of {TILE_KEYS}, got {split}")
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, nq, h, d = q.shape
    n_pool, kv, ps, _ = k_pages.shape
    maxp = page_table.shape[1]
    groups = h // kv
    table = page_table.long().clamp(0, n_pool - 1)
    n_page = maxp * ps
    k = k_pages[table].transpose(2, 3).reshape(b, n_page, kv, d)
    v = v_pages[table].transpose(2, 3).reshape(b, n_page, kv, d)
    t_len = 0 if tail_k is None else tail_k.shape[2]
    quant = k_scale is not None
    p_dtype = v.dtype
    if quant:
        k, v = k.float(), v.float()
        p_dtype = q.dtype if tail_v is None else tail_v.dtype
        # per-key scales (B, K, positions), 1 on the tail
        ones = torch.ones((b, kv, t_len), device=q.device)
        ks, vs = (torch.cat([_key_scales(sc, table), ones], dim=-1)
                  for sc in (k_scale, v_scale))
    pos = torch.arange(n_page + t_len, device=q.device)
    page_limit = lengths if starts is None else torch.minimum(starts, lengths)
    # (B, Q, positions). Keys past the table's last page are absent, as in
    # the reference.
    live = (pos[None, :] < page_limit.clamp(max=n_page)[:, None])[:, None]
    live = live.expand(b, nq, pos.numel())
    if tail_k is not None:
        k = torch.cat([k, tail_k.transpose(1, 2).to(k.dtype)], dim=1)
        v = torch.cat([v, tail_v.transpose(1, 2).to(v.dtype)], dim=1)
        live = live | torch.cat([torch.zeros((b, nq, n_page), dtype=torch.bool,
                                             device=q.device),
                                 _tail_valid(lengths, starts, nq, t_len)], dim=2)
    n_split = split_count(maxp, ps, t_len, split)
    pad = n_split * split - pos.numel()
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    live = torch.nn.functional.pad(live, (0, pad))
    tiles = split // TILE_KEYS
    # (B, K, Q, G, split, tile, key) scores; (B, split, tile, key, K, D) values
    qg = q.float().reshape(b, nq, kv, groups, d).transpose(1, 2)
    kt = k.float().reshape(b, n_split, tiles, TILE_KEYS, kv, d)
    vt = v.reshape(b, n_split, tiles, TILE_KEYS, kv, d)
    scores = torch.einsum("bkqgd,bstjkd->bkqgstj", qg, kt) * d**-0.5
    if quant:
        ks, vs = (torch.nn.functional.pad(sc, (0, pad), value=1.0)
                  .reshape(b, kv, 1, 1, n_split, tiles, TILE_KEYS) for sc in (ks, vs))
        scores = scores * ks
    live = live.reshape(b, 1, nq, 1, n_split, tiles, TILE_KEYS)
    scores = scores.masked_fill(~live, NEG_INF)
    m = torch.full((b, kv, nq, groups, n_split), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, nq, groups, n_split, d), device=q.device)
    for t in range(tiles):
        s_t = scores[..., t, :]
        m_new = torch.maximum(m, s_t.amax(-1))
        p = torch.exp(s_t - m_new[..., None])
        alpha = torch.exp(m - m_new)
        p_v = p * vs[..., t, :] if quant else p
        pv = torch.einsum("bkqgsj,bsjkd->bkqgsd", p_v.to(p_dtype).float(),
                          vt[:, :, t].float())
        # the tile holds a key live for some row: processed for every row
        step = live[..., t, :].any(-1).any(2, keepdim=True)
        m = torch.where(step, m_new, m)
        l = torch.where(step, alpha * l + p.sum(-1), l)
        acc = torch.where(step[..., None], alpha[..., None] * acc + pv, acc)
    m_max = m.amax(-1)
    l_all = torch.zeros_like(m_max)
    out = torch.zeros((b, kv, nq, groups, d), device=q.device)
    for s_i in range(n_split):  # split order, as the kernels merge
        m_s = m[..., s_i]
        w = torch.where(m_s == NEG_INF, 0.0, torch.exp(m_s - m_max))
        l_all = l_all + w * l[..., s_i]
        out = out + w[..., None] * acc[..., s_i, :]
    out = out / torch.where(l_all == 0, 1.0, l_all)[..., None]
    out = out.transpose(1, 2).reshape(b, nq, h, d).to(q.dtype)
    return out[:, 0] if squeeze else out


def _check(q, k_pages, v_pages, page_table, lengths, tail_k, tail_v, starts) -> None:
    if q.dim() not in (3, 4) or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_attention wants q (B,H,D) or (B,Q,H,D) and pools "
                         "(P,K,ps,D)")
    if q.dim() == 4 and tail_k is None:
        raise ValueError(
            "multi-query paged_attention requires the tail path (the verify "
            "chunk's own KV lives in the tail buffer)"
        )
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kv_heads = k_pages.shape[1]
    if k_pages.shape[3] != d:
        raise ValueError(f"head_dim mismatch q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)}")
    if h % kv_heads:
        raise ValueError(f"q heads {h} not divisible by kv heads {kv_heads}")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} must be (B, maxp) "
                         f"and lengths {tuple(lengths.shape)} (B,) for B={b}")
    has_tail = (tail_k is not None, tail_v is not None, starts is not None)
    if any(has_tail) and not all(has_tail):
        raise ValueError("tail_k, tail_v and starts go together")
    if tail_k is not None:
        if (tail_k.dim() != 4 or tail_k.shape != tail_v.shape
                or tail_k.shape[:2] != (b, kv_heads) or tail_k.shape[3] != d):
            raise ValueError(f"tails {tuple(tail_k.shape)} must be (B, K, T, D)")
        if starts.shape != (b,):
            raise ValueError(f"starts {tuple(starts.shape)} must be (B,)")
    tensors = [q, k_pages, v_pages, page_table, lengths]
    tensors += [] if tail_k is None else [tail_k, tail_v, starts]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention's tensors must be on one device")


def _check_int8(k_pages, v_pages, tail_k, k_scale, v_scale) -> None:
    """Validate int8 pools and their scales (ValueError on each fault)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if k_scale is None:
        raise ValueError("int8 pools need their scales (k_scale and v_scale)")
    if tail_k is None:
        raise ValueError(
            "paged_attention with k_scale/v_scale requires the tail path "
            "(tail_k/tail_v/starts) — the no-tail kernel would silently "
            "attend over raw int8 values"
        )
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(f"k_scale/v_scale go with int8 pools, got {k_pages.dtype} "
                         f"and {v_pages.dtype}")
    n_pool, kv_heads, ps, _ = k_pages.shape
    want = (n_pool, kv_heads, 1, ps)
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (sc.dtype != torch.float32 or tuple(sc.shape) != want
                or not sc.is_contiguous() or sc.device != k_pages.device):
            raise ValueError(f"{name} must be contiguous float32 of shape {want} on "
                             f"the pools' device, got {sc.dtype} {tuple(sc.shape)} "
                             f"on {sc.device}")


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    tail_k: torch.Tensor | None = None,
    tail_v: torch.Tensor | None = None,
    starts: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """Paged GQA decode attention (see the module note). CUDA tensors launch
    K3 (with a tail; ``ditl_paged_tail_i8`` over int8 pools with
    ``k_scale``/``v_scale``; the verify entry points for a 4-D q with Q > 1)
    or K4 (without): bf16, float16 or f32 q and tails over pools of their
    dtype or int8 (``kernel_route``), f32 scales, int32 table, lengths and
    starts, all contiguous, head_dim in ``HEAD_DIMS``, any number of query
    heads per KV head and of verify rows; anything else raises. CPU tensors
    run the plain version."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded paged attention is not ported to PyTorch yet "
            "(see ROADMAP.md)"
        )
    _check(q, k_pages, v_pages, page_table, lengths, tail_k, tail_v, starts)
    quant = (k_scale is not None or v_scale is not None
             or k_pages.dtype == torch.int8 or v_pages.dtype == torch.int8)
    if quant:
        _check_int8(k_pages, v_pages, tail_k, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                     tail_k, tail_v, starts, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    if q.dim() == 4 and q.shape[1] == 1:
        # One query token: the single-query kernel, as the reference passes no
        # q_groups for Q = 1, so the bits are the 3-D call's.
        return paged_attention(q[:, 0], k_pages, v_pages, page_table, lengths,
                               tail_k=tail_k, tail_v=tail_v, starts=starts,
                               k_scale=k_scale, v_scale=v_scale)[:, None]
    verify = q.dim() == 4
    b, nq, h, d = q.shape if verify else (q.shape[0], 1, *q.shape[1:])
    n_pool, kv_heads, ps, _ = k_pages.shape
    tail = tail_k is not None
    floats = [("q", q)]
    pools = [("k_pages", k_pages), ("v_pages", v_pages)]
    ints = [("page_table", page_table), ("lengths", lengths)]
    if not quant:
        floats += pools
    if tail:
        floats += [("tail_k", tail_k), ("tail_v", tail_v)]
        ints += [("starts", starts)]
    name = kernel_route(q.dtype, d, int8=quant, verify=verify, tail=tail)
    for t_name, t in floats:
        if t.dtype != q.dtype:
            raise ValueError(f"the CUDA paged-attention kernels take q, tails and float "
                             f"pools of one dtype, got q {q.dtype} and {t_name} {t.dtype}")
    for t_name, t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"{t_name} must be int32, got {t.dtype}")
    for t_name, t in floats + (pools if quant else []):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{t_name} must be contiguous and 16-byte aligned")
    for t_name, t in ints:
        if not t.is_contiguous():
            raise ValueError(f"{t_name} must be contiguous")
    rows = nq * (h // kv_heads)  # query rows per KV head
    t_len = tail_k.shape[2] if tail else 0
    split = split_keys(q, k_pages)
    n_split = split_count(page_table.shape[1], ps, t_len, split)
    o = torch.empty_like(q)
    # The split partials (f32 acc; m and l per query row): allocated, never
    # read on the host.
    part_acc = torch.empty((b, kv_heads, n_split, rows, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, kv_heads, n_split, rows, 2), dtype=torch.float32,
                          device=q.device)
    work = [part_acc.data_ptr(), part_ml.data_ptr()]
    shape = [h, kv_heads, d, ps, page_table.shape[1], n_pool]
    batch = [b, nq] if verify else [b]
    pools_ptr = [k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        pools_ptr += [k_scale.data_ptr(), v_scale.data_ptr()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tail:
            err = _kernel(name)(
                q.data_ptr(), *pools_ptr, page_table.data_ptr(), lengths.data_ptr(),
                starts.data_ptr(), tail_k.data_ptr(), tail_v.data_ptr(), o.data_ptr(),
                *work, *batch, *shape, t_len, split, d**-0.5, stream,
            )
        else:
            err = _kernel(name)(
                q.data_ptr(), *pools_ptr, page_table.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), *work, *batch, *shape, split, d**-0.5, stream,
            )
    if err != 0:
        raise RuntimeError(f"paged attention kernel {name} launch failed: CUDA error {err}")
    globals()[_COUNTERS[name]] += 1
    return o
