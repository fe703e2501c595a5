"""Port parity: the flash-attention forward's plain PyTorch version against the
JAX package's Pallas kernel (interpret mode on the CPU), and the port's plain
attention against the JAX package's.

Shapes keep Sq >= 128 and head_dim 64 so that the JAX dispatch really runs
``_fwd_kernel`` (its ``supports()`` sends smaller shapes to XLA). Tolerances:
f32 at 1e-4 (the two sides sum in different orders and the kernel runs
blockwise with an online softmax); bf16 at 2e-2 (the kernel casts p to bf16
against its running max, the plain version against the final max, and the
outputs are rounded to bf16: a few bf16 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from ditl_tpu.ops import flash_attention as jfa  # noqa: E402
from ditl_tpu.ops.attention import _xla_attention as jax_xla_attention  # noqa: E402
from ditl_tpu_torch.ops import attention as tattn  # noqa: E402
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def _to_torch(x, dtype):
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))


def _to_jax(x, dtype):
    return jnp.asarray(x, dtype=dtype)


def _segments(kind, b, s):
    if kind is None:
        return None
    seg = np.ones((b, s), np.int32)
    if kind == "packed":  # two packed documents, then right padding
        seg[:, s // 2:] = 2
        seg[:, s - 16:] = 0
    else:  # "padded": per-row real lengths, pads segment 0
        for i in range(b):
            seg[i, s - 37 * (i + 1):] = 0
    return seg


def _jax_fwd(q, k, v, seg, causal):
    """The JAX package's ``_fwd`` (the function that launches the kernel) in
    interpret mode: returns (o (B,Sq,H,D), lse (B,H,Sq)) from the first
    lane."""
    b, s, h, d = q.shape
    blocks = jfa._pick_blocks(s, k.shape[1], 512, 512)
    o, lse = jfa._fwd(
        jnp.transpose(q, (0, 2, 1, 3)), jnp.transpose(k, (0, 2, 1, 3)),
        jnp.transpose(v, (0, 2, 1, 3)), seg, seg, causal=causal,
        scale=d**-0.5, blocks=blocks, interpret=True,
    )
    return np.asarray(jnp.transpose(o, (0, 2, 1, 3)), np.float32), np.asarray(lse[..., 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_plain_matches_jax_kernel(dtype, causal, groups):
    kv = 2
    q, k, v = _qkv(groups, 1, 128, kv * groups, kv, 64)
    ref = jfa.flash_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                              causal=causal, interpret=True)
    out = tfa.flash_attention(_to_torch(q, dtype), _to_torch(k, dtype),
                              _to_torch(v, dtype), causal=causal)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("segments", ["packed", "padded"])
def test_segment_ids_match_jax_kernel(dtype, segments):
    q, k, v = _qkv(7, 2, 256, 4, 2, 64)
    seg = _segments(segments, 2, 256)
    # 128-blocks: the JAX kernel runs 2 x 2 tiles, so its online softmax
    # carries across KV blocks and skips the block above the diagonal.
    ref = jfa.flash_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                              causal=True, segment_ids=jnp.asarray(seg),
                              block_q=128, block_kv=128, interpret=True)
    out = tfa.flash_attention(_to_torch(q, dtype), _to_torch(k, dtype),
                              _to_torch(v, dtype), causal=True,
                              segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_fwd(causal):
    q, k, v = _qkv(3, 2, 128, 4, 2, 64)
    seg = _segments("padded", 2, 128)
    o_ref, lse_ref = _jax_fwd(_to_jax(q, "float32"), _to_jax(k, "float32"),
                              _to_jax(v, "float32"), jnp.asarray(seg), causal)
    o, lse = tfa.flash_attention_plain(
        _to_torch(q, "float32"), _to_torch(k, "float32"), _to_torch(v, "float32"),
        causal=causal, segment_ids=torch.from_numpy(seg))
    assert lse.shape == (2, 4, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_attention_decode_mask_matches_jax(dtype):
    """The decode path: one query per row against a cache under an explicit
    (B, 1, Smax) validity mask, as the engine builds it."""
    b, smax, h, kv, d = 4, 48, 8, 2, 32
    q, _, _ = _qkv(11, b, 1, h, kv, d)
    _, k, v = _qkv(12, b, smax, h, kv, d)
    lengths = np.array([5, 17, 1, 30])
    slots = np.arange(smax)
    mask = ((slots[None] < lengths[:, None])
            | ((slots[None] >= 32) & (slots[None] <= 34)))[:, None, :]
    ref = jax_xla_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                            causal=False, segment_ids=None, mask=jnp.asarray(mask))
    out = tattn.dot_product_attention(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
        causal=False, mask=torch.from_numpy(mask), impl="flash")
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_xla_attention_causal_segments_matches_jax():
    q, k, v = _qkv(13, 2, 40, 4, 1, 16)
    seg = _segments("packed", 2, 40)
    ref = jax_xla_attention(_to_jax(q, "float32"), _to_jax(k, "float32"),
                            _to_jax(v, "float32"), causal=True,
                            segment_ids=jnp.asarray(seg))
    out = tattn.dot_product_attention(
        _to_torch(q, "float32"), _to_torch(k, "float32"), _to_torch(v, "float32"),
        causal=True, segment_ids=torch.from_numpy(seg), impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    q, k, v = (_to_torch(x, "bfloat16") for x in _qkv(5, 1, 100, 4, 2, 48))
    tfa.reset_launches()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_plain, lse_plain = tfa.flash_attention_plain(q, k, v, causal=True)
    assert tfa.launches == 0
    assert torch.equal(o, o_plain) and torch.equal(lse, lse_plain)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (_to_torch(x, "float32") for x in _qkv(6, 1, 32, 4, 2, 16))
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="segment_ids"):
        tfa.flash_attention(q, k, v, segment_ids=torch.ones(1, 31, dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention(q, k.bfloat16(), v)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tattn.dot_product_attention(q, k, v, impl=impl)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# K1's tile schedule (which (query tile, key tile) pairs the kernel visits)
# ---------------------------------------------------------------------------

# (block_q, block_kv): the kernel's block and warpgroup rows against its key
# tiles at D = 128 (64) and D <= 64 (128).
SCHEDULE_BLOCKS = [(128, 64), (64, 64), (128, 128), (64, 128)]


def _schedule_ids(kind, b, s, seed=0):
    """(B, S) int32 segment ids: ``sorted`` packed documents of uneven
    lengths, ``padded`` right padding (1...1 0...0, the serving prefill),
    ``nonmono`` runs with ids that go up and down, ``mid`` boundaries in the
    middle of 64-row tiles."""
    rng = np.random.default_rng(seed)
    seg = np.empty((b, s), np.int32)
    for i in range(b):
        if kind == "sorted":
            cuts = np.sort(rng.choice(np.arange(1, s), size=min(5, s - 1), replace=False))
            seg[i] = np.searchsorted(cuts, np.arange(s), side="right") + 1
        elif kind == "padded":
            seg[i] = (np.arange(s) < rng.integers(1, s + 1)).astype(np.int32)
        elif kind == "nonmono":
            row = []
            while len(row) < s:
                row += [int(rng.integers(0, 4))] * int(rng.integers(1, 90))
            seg[i] = row[:s]
        else:
            assert kind == "mid", kind
            seg[i] = (np.arange(s) + 32 + 7 * i) // 64
    return seg


def _admitted(seg, causal, s_q, s_kv):
    """(B, Sq, Skv) boolean: the pairs the causal and segment masks admit."""
    ok = np.ones((1 if seg is None else seg.shape[0], s_q, s_kv), bool)
    if causal:
        ok &= np.tril(np.ones((s_q, s_kv), bool))[None]
    if seg is not None:
        ok &= seg[:, :, None] == seg[:, None, :]
    return ok


def _expand(visit, block_q, block_kv, s_q, s_kv):
    """The tile map at element resolution: (B, Sq, Skv)."""
    v = np.asarray(visit).repeat(block_q, axis=1).repeat(block_kv, axis=2)
    return v[:, :s_q, :s_kv]


def _assert_covers(seg, causal, s_q, s_kv, block_q, block_kv):
    visit = tfa.tile_schedule(None if seg is None else torch.from_numpy(seg), causal,
                              s_q, s_kv, block_q, block_kv)
    n_q, n_kv = -(-s_q // block_q), -(-s_kv // block_kv)
    assert visit.dtype == torch.bool and visit.shape[1:] == (n_q, n_kv)
    admitted = _admitted(seg, causal, s_q, s_kv)
    assert not (admitted & ~_expand(visit.numpy(), block_q, block_kv, s_q, s_kv)).any()
    return visit


@pytest.mark.parametrize("block_q,block_kv", SCHEDULE_BLOCKS)
@pytest.mark.parametrize("kind,causal,s", [
    ("sorted", True, 300), ("padded", True, 512), ("nonmono", True, 300),
    ("mid", True, 257), ("nonmono", False, 300), ("padded", False, 200),
])
def test_tile_schedule_covers_admitted_pairs(kind, causal, s, block_q, block_kv):
    seg = _schedule_ids(kind, 3, s, seed=s)
    visit = _assert_covers(seg, causal, s, s, block_q, block_kv)
    assert visit.shape[0] == 3


@pytest.mark.parametrize("block_q,block_kv", SCHEDULE_BLOCKS)
@pytest.mark.parametrize("causal,s_q,s_kv", [(True, 200, 333), (True, 333, 200),
                                             (False, 129, 300)])
def test_tile_schedule_without_ids(causal, s_q, s_kv, block_q, block_kv):
    """Sq != Skv: causal skips only key tiles past the query tile's last
    row; non-causal visits every tile."""
    visit = _assert_covers(None, causal, s_q, s_kv, block_q, block_kv)
    if not causal:
        assert bool(visit.all())
    else:  # the first key tile past the diagonal is skipped
        assert not bool(visit[0, 0, -(-min(block_q, s_q) // block_kv):].any())


def test_tile_schedule_skips_disjoint_tiles():
    """Right-padded rows: a tile of pad queries skips the tiles of real keys
    and a tile of one document skips those of the others."""
    seg = np.repeat(np.array([[1, 2, 3, 0]], np.int32), 128, axis=1)  # S = 512
    visit = tfa.tile_schedule(torch.from_numpy(seg), True, 512, 512, 128, 128)
    assert torch.equal(visit[0], torch.eye(4, dtype=torch.bool))


@pytest.mark.parametrize("block_q,block_kv", SCHEDULE_BLOCKS)
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_tile_schedule_covers_admitted_pairs_hypothesis(block_q, block_kv, data):
    b = data.draw(st.integers(1, 2))
    s = data.draw(st.integers(1, 300))
    causal = data.draw(st.booleans())
    runs = data.draw(st.lists(st.tuples(st.integers(0, 5), st.integers(1, 120)),
                              min_size=1, max_size=12))
    row = [i for i, n in runs for _ in range(n)]
    row = (row * (s // len(row) + 1))[:s]
    seg = np.array([row, row[::-1]][:b], np.int32)
    _assert_covers(seg, causal, s, s, block_q, block_kv)
    _assert_covers(None, causal, s, data.draw(st.integers(1, 300)), block_q, block_kv)


def _plain_on_schedule(q, k, v, causal, seg, block_q, block_kv):
    """``flash_attention_plain``'s arithmetic with every pair outside the
    visited tiles masked as well."""
    b, s_q, h, d = q.shape
    s_kv, kv_heads = k.shape[1], k.shape[2]
    visit = tfa.tile_schedule(seg, causal, s_q, s_kv, block_q, block_kv)
    mask = torch.from_numpy(_expand(visit.numpy(), block_q, block_kv, s_q, s_kv))
    mask = mask & torch.from_numpy(_admitted(None if seg is None else seg.numpy(),
                                             causal, s_q, s_kv))
    qf = q.float().reshape(b, s_q, kv_heads, h // kv_heads, d) * d**-0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    s = s.masked_fill(~mask[:, None, None], tattn.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    o = (pv / torch.where(l == 0.0, torch.ones_like(l), l)).permute(0, 3, 1, 2, 4)
    return o.reshape(b, s_q, h, d).to(q.dtype)


@pytest.mark.parametrize("block_q,block_kv", [(128, 64), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sorted", "padded", "nonmono", "mid"])
def test_schedule_masked_plain_matches_jax_kernel(kind, dtype, block_q, block_kv):
    """Masking everything outside K1's visited tiles changes nothing: the
    result equals the plain version and the JAX kernel in interpret mode
    (as ``test_segment_ids_match_jax_kernel`` runs it, same tolerances)."""
    q, k, v = _qkv(8, 2, 256, 4, 2, 64)
    seg = _schedule_ids(kind, 2, 256, seed=3)
    tq, tk, tv, tseg = (_to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
                        torch.from_numpy(seg))
    out = _plain_on_schedule(tq, tk, tv, True, tseg, block_q, block_kv)
    plain, _ = tfa.flash_attention_plain(tq, tk, tv, causal=True, segment_ids=tseg)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    ref = jfa.flash_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                              causal=True, segment_ids=jnp.asarray(seg),
                              block_q=128, block_kv=128, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# K1-f32 (csrc/flash_f32.cu) visits the F32_BLOCK-key tiles of
# tile_schedule at its block's f32_fwd_block(d)[0] rows, in sub-tiles of
# f32_fwd_block(d)[1] keys, and each 64-row warpgroup skips the sub-tiles
# past its last row: f32_fwd_visits is that map at element resolution.


def test_f32_fwd_block_is_the_kernels_tiling():
    """Two warpgroups (128 rows) over 64-key sub-tiles at D = 64 and 32-key
    ones at D = 128, one warpgroup over 16-key sub-tiles at D = 256: every
    sub-tile divides the 64-key tiles the block marks; other head dims
    raise."""
    assert [tfa.f32_fwd_block(d) for d in tfa.F32_HEAD_DIMS] == [(128, 64), (128, 32),
                                                                 (64, 16)]
    assert all(tfa.F32_BLOCK % tfa.f32_fwd_block(d)[1] == 0 for d in tfa.F32_HEAD_DIMS)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.f32_fwd_block(32)


@pytest.mark.parametrize("d", tfa.F32_HEAD_DIMS)
@pytest.mark.parametrize("kind,causal,s_q,s_kv", [
    ("sorted", True, 300, 300), ("padded", True, 512, 512), ("nonmono", True, 300, 300),
    ("mid", True, 257, 257), ("nonmono", False, 300, 300), (None, True, 200, 333),
    (None, True, 333, 200), (None, False, 129, 300),
])
def test_f32_fwd_visits_cover_admitted_pairs(kind, causal, s_q, s_kv, d):
    """Every pair the masks admit lies in K1-f32's visits; the visits lie in
    the block's marked tiles; without ids and causal, a sub-tile starting
    past the warpgroup's last row is never visited."""
    seg = None if kind is None else _schedule_ids(kind, 3, s_q, seed=s_q)
    tseg = None if seg is None else torch.from_numpy(seg)
    visit = tfa.f32_fwd_visits(tseg, causal, s_q, s_kv, d).numpy()
    assert visit.shape[1:] == (s_q, s_kv)
    assert not (_admitted(seg, causal, s_q, s_kv) & ~visit).any()
    rows, sub = tfa.f32_fwd_block(d)
    tiles = tfa.tile_schedule(tseg, causal, s_q, s_kv, rows, tfa.F32_BLOCK)
    assert not (visit & ~_expand(tiles.numpy(), rows, tfa.F32_BLOCK, s_q, s_kv)).any()
    if causal:
        for r in range(0, s_q, 64):
            last = min(s_q, r + 64) - 1
            first_skipped = (last // sub + 1) * sub
            assert not visit[:, r:r + 64, first_skipped:].any()


@pytest.mark.parametrize("d", tfa.F32_HEAD_DIMS)
@pytest.mark.parametrize("kind", ["sorted", "padded", "nonmono", "mid"])
def test_f32_fwd_visits_masked_plain_matches_jax_kernel(kind, d):
    """Masking every pair outside K1-f32's visits changes nothing in f32:
    the result equals the plain version and the JAX kernel in interpret mode
    at each K1-f32 tiling (f32 tolerance)."""
    q, k, v = _qkv(9, 2, 256, 4, 2, d)
    seg = _schedule_ids(kind, 2, 256, seed=4)
    tq, tk, tv, tseg = (_to_torch(q, "float32"), _to_torch(k, "float32"),
                        _to_torch(v, "float32"), torch.from_numpy(seg))
    mask = tfa.f32_fwd_visits(tseg, True, 256, 256, d) & torch.from_numpy(
        _admitted(seg, True, 256, 256))
    qf = tq.reshape(2, 256, 2, 2, d) * d**-0.5
    sc = torch.einsum("bqkgd,bskd->bkgqs", qf, tk).masked_fill(~mask[:, None, None],
                                                               tattn.NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    out = (torch.einsum("bkgqs,bskd->bkgqd", p, tv) / p.sum(dim=-1, keepdim=True))
    out = out.permute(0, 3, 1, 2, 4).reshape(2, 256, 4, d)
    plain, _ = tfa.flash_attention_plain(tq, tk, tv, causal=True, segment_ids=tseg)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=TOL["float32"],
                               rtol=TOL["float32"])
    ref = jfa.flash_attention(_to_jax(q, "float32"), _to_jax(k, "float32"),
                              _to_jax(v, "float32"), causal=True, segment_ids=jnp.asarray(seg),
                              block_q=128, block_kv=128, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_training_batch_visits_under_half_the_causal_tiles():
    """The training pipeline's first batch (packed documents): K1 visits
    fewer than half of the causal tiles at its D = 128 tiling."""
    from ditl_tpu_torch.config import DataConfig
    from ditl_tpu_torch.data.dataset import synthetic_dataset
    from ditl_tpu_torch.data.loader import DataPipeline
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer

    cfg = DataConfig(batch_size=4, seq_len=2048, synthetic=True)
    pipe = DataPipeline(synthetic_dataset(cfg.synthetic_examples, cfg.seed),
                        ByteTokenizer(), cfg, "cpu")
    seg = torch.from_numpy(next(pipe._host_batches(0))["segment_ids"])
    blocks = (tfa.FWD_BLOCK_Q, tfa.fwd_block_kv(128))
    visited = int(tfa.tile_schedule(seg, True, 2048, 2048, *blocks).sum())
    causal = 4 * int(tfa.tile_schedule(None, True, 2048, 2048, *blocks).sum())
    assert int(seg.max()) >= 2 and visited < causal / 2, (visited, causal)
    _assert_covers(seg.numpy(), True, 2048, 2048, *blocks)
