"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These need a CUDA device and nvcc (a CUDA kernel has no CPU mode), so they
carry the ``torch_port`` marker and skip without a card. The file imports
neither JAX nor the JAX package, so it runs where only the port is
installed (``--noconftest``: ``tests/conftest.py`` imports jax):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m torch_port -q

Tolerances: bf16 outputs at 2e-2 (the kernels round p to bf16 against their
running row max, the plain versions against the final max; a few bf16 ulps),
f32 log-sum-exp at 1e-3 (scaling before or after the q.k product, and the
sums' order). The backward kernels (K2a, K2b) against the plain backward:
each gradient within ``BWD_TOL`` of its own largest magnitude, because they
round p and ds to bf16 for the three second products (p.do, ds.k, ds.q)
that the plain version computes in f32 (about 2^-9 relative per term,
averaging out over the sums), and round the outputs to bf16.
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from ditl_tpu_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

BWD_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, b, s_q, s_kv, h, kv, d, lengths=None, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, s_q, h, d), (b, s_kv, kv, d), (b, s_kv, kv, d)))
    seg = None
    if lengths is not None:
        pos = torch.arange(s_q, device=cuda)
        seg = (pos[None] < torch.tensor(lengths, device=cuda)[:, None]).int().contiguous()
    return q, k, v, seg


def _segment_ids(cuda, kind, b, s, seed=0):
    """(B, S) int32 ids of one kind: ``"train"`` the training pipeline's
    first batch (packed documents), ``"nonmono"`` runs of random length with
    ids that go up and down, ``"edge1"`` a boundary one row past a tile
    edge (ids 1 up to position 129, then 2)."""
    if kind == "train":
        from ditl_tpu_torch.config import DataConfig
        from ditl_tpu_torch.data.dataset import synthetic_dataset
        from ditl_tpu_torch.data.loader import DataPipeline
        from ditl_tpu_torch.data.tokenizer import ByteTokenizer

        cfg = DataConfig(batch_size=b, seq_len=s, synthetic=True)
        pipe = DataPipeline(synthetic_dataset(cfg.synthetic_examples, cfg.seed),
                            ByteTokenizer(), cfg, "cpu")
        ids = torch.from_numpy(next(pipe._host_batches(0))["segment_ids"])
    elif kind == "nonmono":
        g = torch.Generator().manual_seed(seed)
        rows = []
        for _ in range(b):
            row = []
            while len(row) < s:
                n = int(torch.randint(1, 97, (1,), generator=g))
                row += [int(torch.randint(0, 4, (1,), generator=g))] * n
            rows.append(row[:s])
        ids = torch.tensor(rows)
    else:
        assert kind == "edge1", kind
        ids = torch.ones(b, s, dtype=torch.int32)
        ids[:, 129:] = 2
    return ids.to(device=cuda, dtype=torch.int32).contiguous()


@pytest.mark.torch_port
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d,causal,seg", [
    (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97]),  # serving prefill
    (2, 200, 333, 8, 2, 64, False, None),  # ragged, non-causal
    (1, 130, 130, 4, 4, 32, True, None),  # head_dim 32, MHA
    (4, 2048, 2048, 32, 8, 128, True, "train"),  # the training pipeline's batch
    (2, 300, 300, 8, 2, 128, True, "nonmono"),
    (1, 257, 257, 4, 2, 128, True, "edge1"),
    (1, 129, 129, 4, 1, 128, True, None),
    (1, 2064, 2064, 8, 2, 128, True, "nonmono"),
    (2, 300, 300, 4, 2, 32, True, "nonmono"),
    (2, 300, 300, 4, 2, 32, False, "nonmono"),
    (2, 300, 300, 4, 2, 64, True, "nonmono"),
    (2, 300, 300, 4, 2, 64, False, "edge1"),
    (2, 300, 300, 4, 2, 128, False, "nonmono"),
    (2, 300, 300, 4, 2, 128, False, None),
    # head_dim 256: path 15's prefill (8 heads on 1 KV head), ids up and down,
    # a boundary one row past a tile edge, Sq != Skv without a mask
    (4, 512, 512, 8, 1, 256, True, [512, 401, 230, 97]),
    (2, 300, 300, 4, 2, 256, True, "nonmono"),
    (1, 257, 257, 4, 2, 256, True, "edge1"),
    (2, 200, 333, 4, 4, 256, False, None),
    (1, 2048, 2048, 7, 1, 64, True, "train"),
])
def test_flash_fwd_kernel_matches_plain(cuda, b, s_q, s_kv, h, kv, d, causal, seg):
    lengths = seg if isinstance(seg, list) else None
    q, k, v, ids = _inputs(cuda, b, s_q, s_kv, h, kv, d, lengths)
    if isinstance(seg, str):
        ids = _segment_ids(cuda, seg, b, s_q)
    tfa.reset_launches()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=ids)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=causal, segment_ids=ids)
    torch.cuda.synchronize()
    assert tfa.launches == 1
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-3)


@pytest.mark.torch_port
def test_flash_fwd_kernel_raises_instead_of_falling_back(cuda):
    """On CUDA tensors the wrapper launches the kernel or raises: no plain
    fallback for shapes or dtypes the kernel does not take. A head dim the
    port has no kernel for (D = 48) raises NotImplementedError naming
    ROADMAP.md; a float16 forward launches K1-f16, and its backward K2a-f16
    and K2b-f16 (D = 256 in every dtype is held to its plain version in the
    kernel tests)."""
    q, k, v, _ = _inputs(cuda, 1, 64, 64, 4, 2, 128)
    tfa.reset_launches()
    leaves = [t.half().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    assert tfa.launches_f16 == 1
    out.float().sum().backward()
    assert (tfa.launches_dq_f16, tfa.launches_dkv_f16) == (1, 1)
    with pytest.raises(ValueError, match="dtype mismatch"):  # mixed dtypes
        tfa.flash_attention(q.half(), k, v)
    q48, k48, v48, _ = _inputs(cuda, 1, 64, 64, 4, 2, 48)
    with pytest.raises(NotImplementedError, match="head_dim.*ROADMAP"):
        tfa.flash_attention(q48, k48, v48)
    q48, k48, v48, _ = _inputs(cuda, 1, 64, 64, 4, 2, 48, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="head_dim.*ROADMAP"):  # f32 at D = 48
        tfa.flash_attention(q48, k48, v48)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert tfa.launches == tfa.launches_f32 == tfa.launches_dq == 0
    assert tfa.launches_f16 == 1


def _paged_inputs(cuda, b, h, kv, d, ps, n_pool, tail_len, lengths, starts, seed=0,
                  nq=None, maxp=None, dtype=torch.bfloat16):
    """Pools, tails and a table giving each slot its own pages for
    ceil(min(starts, lengths) / ps) blocks in ``maxp`` columns (default:
    the most any slot needs); rows 1 and 2 share their first physical page
    where there are three rows. ``nq``: a verify's (B, Q, H, D) q."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q = rnd(b, h, d) if nq is None else rnd(b, nq, h, d)
    kp, vp = rnd(n_pool, kv, ps, d), rnd(n_pool, kv, ps, d)
    tk, tv = rnd(b, kv, tail_len, d), rnd(b, kv, tail_len, d)
    maxp = maxp or max(1, max(-(-max(x, y) // ps) for x, y in zip(lengths, starts)))
    table = torch.zeros((b, maxp), dtype=torch.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-min(lengths[row], starts[row]) // ps)):
            table[row, i] = pid
            pid += 1
    if b > 2:
        table[2, 0] = table[1, 0]
    assert pid <= n_pool
    as_int = lambda x: torch.tensor(x, dtype=torch.int32, device=cuda)  # noqa: E731
    return q, kp, vp, table.to(cuda), as_int(lengths), as_int(starts), tk, tv


# K3/K4 cases: (b, h, kv, d, ps, tail_len, lengths, starts)
PAGED_CASES = [
    # the serving tick: dead slot, partial page, exact boundary, no tail
    (8, 32, 8, 128, 256, 16, [0, 700, 512, 1500, 9, 256, 1030, 300],
     [0, 690, 512, 1490, 0, 256, 1030, 300]),
    (4, 8, 4, 64, 16, 8, [0, 5, 38, 50], [0, 0, 32, 45]),  # head_dim 64, page 16
    (3, 8, 8, 64, 16, 8, [17, 40, 33], [16, 33, 33]),  # MHA
    # split edges (splits of 128 or 256 keys): keys ending one past a split,
    # on a split boundary, a tile across the last page and the tail
    (4, 32, 8, 128, 16, 16, [257, 256, 513, 140], [257, 250, 500, 128]),
    (3, 16, 2, 64, 48, 8, [300, 1, 40], [297, 0, 33]),
] + [case[1:] for case in chip_smoke.HD_PAGED_CASES]  # head_dim 32 and 256, G = 1, 2, 8


@pytest.mark.torch_port
@pytest.mark.parametrize("b,h,kv,d,ps,tail_len,lengths,starts", PAGED_CASES)
def test_paged_kernels_match_plain(cuda, b, h, kv, d, ps, tail_len, lengths, starts):
    """K3 and K4 against the plain version, and against the plain twin of
    their split rule (``paged_attention_split_plain``), which rounds p at
    the same running max; a dead slot gives zeros."""
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, b, h, kv, d, ps, 128, tail_len, lengths, starts)
    tpa.reset_launches()
    o3 = tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st)
    o4 = tpa.paged_attention(q, kp, vp, table, torch.minimum(st, lens).contiguous())
    r3 = tpa.paged_attention_plain(q, kp, vp, table, lens, tk, tv, st)
    r4 = tpa.paged_attention_plain(q, kp, vp, table, torch.minimum(st, lens))
    s3 = tpa.paged_attention_split_plain(q, kp, vp, table, lens, tk, tv, st)
    s4 = tpa.paged_attention_split_plain(q, kp, vp, table, torch.minimum(st, lens))
    torch.cuda.synchronize()
    assert (tpa.launches_tail, tpa.launches) == (1, 1)
    for o, r, s_ in ((o3, r3, s3), (o4, r4, s4)):
        torch.testing.assert_close(o.float(), r.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(o.float(), s_.float(), atol=2e-2, rtol=2e-2)
    dead = [i for i, n in enumerate(lengths) if n == 0]
    assert all(bool((o3[i] == 0).all()) for i in dead)


@pytest.mark.torch_port
@pytest.mark.parametrize("case", [0, 3, 4])
def test_paged_kernels_are_bitwise_repeatable(cuda, case):
    """The merge kernel sums a slot's partials in split order: three calls
    give the same bits."""
    b, h, kv, d, ps, tail_len, lengths, starts = PAGED_CASES[case]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, b, h, kv, d, ps, 128, tail_len, lengths, starts)
    runs = [(tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st),
             tpa.paged_attention(q, kp, vp, table, lens)) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert torch.equal(run[0], runs[0][0]) and torch.equal(run[1], runs[0][1])


@pytest.mark.torch_port
def test_paged_wrapper_never_syncs(cuda):
    """The grid comes from shapes alone: under ``set_sync_debug_mode("error")``
    (which raises on a device-to-host sync) K3 and K4 launch, and a CUDA
    graph captures them."""
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(cuda, *PAGED_CASES[0][:4], 256, 128,
                                                       *PAGED_CASES[0][5:])
    tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st)
    torch.cuda.synchronize()  # built and loaded
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st)
        tpa.paged_attention(q, kp, vp, table, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st)
    graph.replay()
    torch.cuda.synchronize()
    want = tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st)
    assert torch.equal(o, want)


@pytest.mark.torch_port
def test_paged_kernels_raise_instead_of_falling_back(cuda):
    """On CUDA tensors the wrapper launches a kernel or raises: no plain
    fallback for dtypes, shapes or variants the kernels do not take."""
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, 4, 8, 4, 64, 16, 64, 8, [0, 5, 38, 50], [0, 0, 32, 45])
    tpa.reset_launches()
    with pytest.raises(NotImplementedError, match="float64.*ROADMAP"):
        tpa.paged_attention(q.double(), kp.double(), vp.double(), table, lens)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    with pytest.raises(ValueError, match="one dtype"):  # f32 q, bf16 tails, int8 pools
        tpa.paged_attention(q.float(), kq, vq, table, lens, tail_k=tk, tail_v=tv, starts=st,
                            k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="one dtype"):  # f32 q over bf16 pools
        tpa.paged_attention(q.float(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="one dtype"):  # float16 q over bf16 pools
        tpa.paged_attention(q.half(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="multi-query"):  # a verify without a tail
        tpa.paged_attention(q[:, None].expand(-1, 3, -1, -1).contiguous(), kp, vp, table,
                            lens)
    scale = torch.ones((64, 4, 1, 16), device=cuda)
    with pytest.raises(ValueError, match="int8 pools"):  # scales with float pools
        tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st,
                            k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="tail path"):  # scales without a tail
        tpa.paged_attention(q, kp.to(torch.int8), vp.to(torch.int8), table, lens,
                            k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(NotImplementedError, match="head_dim 40.*ROADMAP"):
        tpa.paged_attention(q[..., :40].contiguous(), kp[..., :40].contiguous(),
                            vp[..., :40].contiguous(), table, lens)
    assert all(getattr(tpa, n) == 0 for n in tpa._COUNTERS.values())
    # 41 x 2 query rows, which the verify once refused: one launch in two row
    # groups of the 80-row instance, against the plain version.
    q41 = q[:, None].expand(-1, 41, -1, -1).contiguous()
    o = tpa.paged_attention(q41, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st)
    torch.cuda.synchronize()
    assert tpa.launches_verify == 1
    torch.testing.assert_close(o.float(), tpa.paged_attention_plain(
        q41, kp, vp, table, lens, tk, tv, st).float(), atol=2e-2, rtol=2e-2)


def _int8_pools(kp, vp):
    """bf16 pools -> int8 pools and their (P, K, 1, ps) f32 scales, by the
    caches' own quantization (absmax per position over D)."""
    from ditl_tpu_torch.infer.cache import _quantize

    (kq, ks), (vq, vs) = _quantize(kp), _quantize(vp)
    return kq, vq, ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()


# Single-query cases past PAGED_CASES' head dims and groups: Phi-3-mini's D
# = 96 at G = 4 (page 16, three pages: the axis's tail starts at 48, so the
# first tile mixes page, dead and tail rows) and at G = 1 over the split
# edges; G = 16 and G = 20 (past the single-query form's 8 rows; the f32
# kernel's groups of 16, the second partial) at D = 128 and 32.
EXTRA_SINGLE_CASES = [
    (3, 8, 2, 96, 16, 8, [17, 40, 33], [16, 33, 33]),
    (4, 4, 4, 96, 16, 16, [257, 256, 513, 140], [257, 250, 500, 128]),
    (3, 32, 2, 128, 16, 8, [17, 40, 33], [16, 33, 33]),
    (3, 40, 2, 32, 48, 8, [300, 1, 40], [297, 0, 33]),
]

# K3 over int8 pools: the K3 cases (the decode tick, with a dead slot, a
# tail-only slot, starts == lengths; head_dim 64; MHA; the split edges; D =
# 32 and 256 at G = 1, 2 and 8, a tile mixing page and tail rows), then D =
# 96 and G = 16 and 20.
INT8_CASES = PAGED_CASES + EXTRA_SINGLE_CASES


@pytest.mark.torch_port
@pytest.mark.parametrize("b,h,kv,d,ps,tail_len,lengths,starts", INT8_CASES)
def test_paged_int8_kernel_matches_plain(cuda, b, h, kv, d, ps, tail_len, lengths, starts):
    """ditl_paged_tail_i8 against the plain version's int8 branch and against
    the split twin at bf16 tolerance (2e-2: the kernel rounds p * vs to bf16
    against its running max, the plain version keeps it in f32); three calls
    give the same bits, each one launch of K3-int8 and no other; a dead
    slot gives zeros."""
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, b, h, kv, d, ps, 128, tail_len, lengths, starts)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kq, vq, table, lens, tail_k=tk, tail_v=tv, starts=st,
                                k_scale=ks, v_scale=vs) for _ in range(3)]
    r = tpa.paged_attention_plain(q, kq, vq, table, lens, tk, tv, st, ks, vs)
    s_ = tpa.paged_attention_split_plain(q, kq, vq, table, lens, tk, tv, st, ks, vs)
    torch.cuda.synchronize()
    assert {n: getattr(tpa, n) for n in tpa._COUNTERS.values() if getattr(tpa, n)} == {
        "launches_tail_int8": 3}
    o = runs[0]
    assert all(torch.equal(run, o) for run in runs[1:])
    torch.testing.assert_close(o.float(), r.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), s_.float(), atol=2e-2, rtol=2e-2)
    dead = [i for i, n in enumerate(lengths) if n == 0]
    assert all(bool((o[i] == 0).all()) for i in dead)


@pytest.mark.torch_port
@pytest.mark.parametrize("case", [0, 3, 4])
def test_paged_int8_kernel_is_bitwise_repeatable(cuda, case):
    """Three calls of K3 over int8 pools give the same bits."""
    b, h, kv, d, ps, tail_len, lengths, starts = INT8_CASES[case]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, b, h, kv, d, ps, 128, tail_len, lengths, starts)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    runs = [tpa.paged_attention(q, kq, vq, table, lens, tail_k=tk, tail_v=tv, starts=st,
                                k_scale=ks, v_scale=vs) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(run, runs[0]) for run in runs[1:])


@pytest.mark.torch_port
def test_paged_int8_wrapper_never_syncs(cuda):
    """K3 over int8 pools launches under ``set_sync_debug_mode("error")`` and
    a CUDA graph captures it."""
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(cuda, *INT8_CASES[0][:4], 256, 128,
                                                       *INT8_CASES[0][5:])
    kq, vq, ks, vs = _int8_pools(kp, vp)
    kw = dict(tail_k=tk, tail_v=tv, starts=st, k_scale=ks, v_scale=vs)
    tpa.paged_attention(q, kq, vq, table, lens, **kw)
    torch.cuda.synchronize()  # built and loaded
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.paged_attention(q, kq, vq, table, lens, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = tpa.paged_attention(q, kq, vq, table, lens, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o, tpa.paged_attention(q, kq, vq, table, lens, **kw))


@pytest.mark.torch_port
def test_paged_int8_invalid_inputs_raise_and_launch_nothing(cuda):
    """Invalid int8 inputs raise ValueError before any launch: int8 pools
    without scales, scales without the tail, f32 tails, f64 or
    non-contiguous or misshapen scales, one scale alone."""
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, 4, 8, 4, 64, 16, 64, 8, [0, 5, 38, 50], [0, 0, 32, 45])
    kq, vq, ks, vs = _int8_pools(kp, vp)
    tail = dict(tail_k=tk, tail_v=tv, starts=st)
    tpa.reset_launches()
    bad = [
        ("their scales", (q, kq, vq, table, lens), tail),
        ("tail path", (q, kq, vq, table, lens), dict(k_scale=ks, v_scale=vs)),
        ("bfloat16", (q, kq, vq, table, lens),
         dict(tail_k=tk.float(), tail_v=tv.float(), starts=st, k_scale=ks, v_scale=vs)),
        ("float32", (q, kq, vq, table, lens), dict(**tail, k_scale=ks.double(), v_scale=vs)),
        ("contiguous", (q, kq, vq, table, lens),
         dict(**tail, k_scale=ks.transpose(0, 1).contiguous().transpose(0, 1), v_scale=vs)),
        ("shape", (q, kq, vq, table, lens), dict(**tail, k_scale=ks[:, :, :, :8],
                                                 v_scale=vs[:, :, :, :8])),
        ("go together", (q, kq, vq, table, lens), dict(**tail, k_scale=ks)),
    ]
    for match, args, kw in bad:
        with pytest.raises(ValueError, match=match):
            tpa.paged_attention(*args, **kw)
    assert (tpa.launches_tail_int8, tpa.launches_tail, tpa.launches) == (0, 0, 0)


# K3's multi-query verify: chip_smoke.py's verify cases, (label, b, Q, h, kv,
# d, ps, tail_len, lengths, starts, maxp): the spec tick of llama3-8b (a dead
# slot, a page boundary, a tail reaching its last column), head_dim 64 at
# page 16, a tail longer than 128 columns (query 0's limit before the split
# at tail column 128, query 8's past it) with a tail-only slot, G = 8 at 72
# query rows, Q = 2 (one row tile with padding rows), G = 20 at Q = 3 (60
# rows, a partial row tile), 272 rows (two row groups), 144 rows at head_dim
# 256 (int8 staged in place), a tile mixing page, dead and tail rows; then
# head_dim 32 and 256 (chip_smoke.HD_VERIFY_CASES: the spec ticks of paths 14
# and 15, 80 rows at G = 8, G = 1 with a long tail, 40 rows).
BASE_VERIFY_CASES = [case[1:] for case in chip_smoke._verify_cases()]
VERIFY_CASES = BASE_VERIFY_CASES + [case[1:] for case in chip_smoke.HD_VERIFY_CASES]


@pytest.mark.torch_port
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", range(len(VERIFY_CASES)))
def test_paged_verify_kernels_match_plain(cuda, case, int8):
    """K3-verify (float and int8 pools) against the plain version's 4-D
    branch and the split twin at 2e-2; three calls give the same bits; a 4-D
    q with Q = 1 gives the 3-D call's bits; a dead slot gives zeros; each
    call counts one verify launch."""
    b, nq, h, kv, d, ps, tail_len, lengths, starts, maxp = VERIFY_CASES[case]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=case, nq=nq, maxp=maxp)
    scales = {}
    if int8:
        kp, vp, ks, vs = _int8_pools(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tail = dict(tail_k=tk, tail_v=tv, starts=st)
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kp, vp, table, lens, **tail, **scales) for _ in range(3)]
    assert (tpa.launches_verify_int8 if int8 else tpa.launches_verify) == 3
    r = tpa.paged_attention_plain(q, kp, vp, table, lens, tk, tv, st, **scales)
    sp = tpa.paged_attention_split_plain(q, kp, vp, table, lens, tk, tv, st, **scales)
    o41 = tpa.paged_attention(q[:, :1].contiguous(), kp, vp, table, lens, **tail, **scales)
    o3 = tpa.paged_attention(q[:, 0].contiguous(), kp, vp, table, lens, **tail, **scales)
    torch.cuda.synchronize()
    o = runs[0]
    assert o.shape == q.shape
    torch.testing.assert_close(o.float(), r.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), sp.float(), atol=2e-2, rtol=2e-2)
    assert all(torch.equal(run, o) for run in runs[1:])
    assert torch.equal(o41[:, 0], o3)
    dead = [i for i, n in enumerate(lengths) if n == 0]
    assert all(bool((o[i] == 0).all()) for i in dead)


@pytest.mark.torch_port
@pytest.mark.parametrize("case", [VERIFY_CASES[0], chip_smoke.SHAPE_VERIFY_CASES[0][1:]],
                         ids=["spec tick", "144 rows"])
def test_paged_verify_wrapper_never_syncs(cuda, case):
    """The verify's grid and split length come from shapes alone: no
    device-to-host sync, and a CUDA graph captures it (the spec tick, and
    path 16's 144 rows a KV head)."""
    b, nq, h, kv, d, ps, tail_len, lengths, starts, maxp = case
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, b, h, kv, d, ps, 128, tail_len, lengths, starts, nq=nq, maxp=maxp)
    kw = dict(tail_k=tk, tail_v=tv, starts=st)
    want = tpa.paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.paged_attention(q, kp, vp, table, lens, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = tpa.paged_attention(q, kp, vp, table, lens, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o, want)


# One query past the single-query form's 8 rows a KV head, on the row-tile
# kernel: (b, h, kv, d, ps, tail_len, lengths, starts) at G = 12 and G = 16,
# the split edges with a dead slot.
ROWS_SINGLE_CASES = [(4, 48, 4, 128, 16, 16, [257, 256, 0, 140], [257, 250, 0, 128]),
                     (4, 64, 4, 64, 16, 16, [257, 256, 0, 140], [257, 250, 0, 128])]


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", ROWS_SINGLE_CASES, ids=["G=12", "G=16"])
def test_paged_single_query_past_eight_rows_matches_plain(cuda, case, int8, dtype):
    """K3 (float and int8 pools) with one query at G = 12 and 16, on the
    row-tile kernel: against the plain version and the split twin at 2e-2;
    three calls the same bits; a 4-D q with Q = 1 the 3-D call's bits; a
    dead slot zeros; one launch a call on its own counter."""
    b, h, kv, d, ps, tail_len, lengths, starts = case
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        cuda, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=7, dtype=dtype)
    scales = {}
    if int8:
        kp, vp, ks, vs = _int8_pools(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tail = dict(tail_k=tk, tail_v=tv, starts=st, **scales)
    counter = "launches_tail" + ("_int8" if int8 else "") + (
        "_f16" if dtype == torch.float16 else "")
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kp, vp, table, lens, **tail) for _ in range(3)]
    assert getattr(tpa, counter) == 3
    assert sum(getattr(tpa, n) for n in tpa._COUNTERS.values()) == 3
    args = (q, kp, vp, table, lens, tk, tv, st, *scales.values())
    r = tpa.paged_attention_plain(*args)
    sp = tpa.paged_attention_split_plain(*args)
    o4 = tpa.paged_attention(q[:, None].contiguous(), kp, vp, table, lens, **tail)
    torch.cuda.synchronize()
    o = runs[0]
    assert o.shape == q.shape and o.dtype == dtype
    torch.testing.assert_close(o.float(), r.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), sp.float(), atol=2e-2, rtol=2e-2)
    assert all(torch.equal(run, o) for run in runs[1:])
    assert torch.equal(o4[:, 0], o)
    assert all(bool((o[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)


@pytest.mark.torch_port
def test_paged_single_query_kernels_keep_their_digests(cuda):
    """K3, K3 over int8 pools and K4 in their single-query form give, on
    fixed integer-made inputs, the bits of the build before the verify form
    joined their template (chip_smoke.py's ``K3_DIGESTS``)."""
    assert chip_smoke._k3_digests(tpa) == chip_smoke.K3_DIGESTS


@pytest.mark.torch_port
def test_paged_row_tile_kernel_keeps_its_digests(cuda):
    """The row-tile kernel's forms (K3-verify and K3-int8-verify in bf16 and
    float16 at the spec tick, head_dim 64 and 144 rows; K3, K3-int8 and K4
    at G = 16) give the bits recorded in chip_smoke.py's ``ROWS_DIGESTS``."""
    assert chip_smoke._rows_digests(tpa) == chip_smoke.ROWS_DIGESTS


def _bwd_inputs(cuda, b, s_q, s_kv, h, kv, d, causal, seg, seed=0, dtype=torch.bfloat16):
    """Forward through K1 (its o and lse), then a random upstream gradient."""
    q, k, v, _ = _inputs(cuda, b, s_q, s_kv, h, kv, d, seed=seed, dtype=dtype)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    return q, k, v, o, lse, do


def _packed_segments(cuda, b, s, n_docs):
    """Rows of ``n_docs`` packed documents of uneven lengths, 1-based."""
    seg = torch.ones(b, s, dtype=torch.int32)
    for row in range(b):
        cuts = torch.linspace(0, s, n_docs + 1)[1:-1].long() + 7 * row
        for c in cuts:
            seg[row, int(c):] += 1
    return seg.to(cuda).contiguous()


def _bwd_segments(cuda, seg, b, s):
    """A backward case's ids: ``n`` documents packed per row (0: none),
    K1's id kinds by name, or right-padded real lengths."""
    if isinstance(seg, str):
        return _segment_ids(cuda, seg, b, s)
    if isinstance(seg, list):
        return _inputs(cuda, b, s, s, 1, 1, 32, seg)[3]
    return _packed_segments(cuda, b, s, seg) if seg else None


# K1's cases for the backward: every head dim causal and not, the training
# batch, ids that go up and down, a boundary one row past a tile edge, right
# padding, ragged lengths (S = 129, 333, 2064) and Sq != Skv both ways.
BWD_CASES = [
    (1, 2048, 2048, 32, 8, 128, True, 4),  # a training row, packed documents
    (2, 333, 333, 8, 2, 64, True, 3),  # S not a multiple of 64, head_dim 64
    (2, 200, 333, 8, 8, 128, False, 0),  # MHA, non-causal, Sq != Skv
    (1, 130, 130, 4, 4, 32, True, 0),  # head_dim 32
    (4, 2048, 2048, 32, 8, 128, True, "train"),  # the training pipeline's batch
    (2, 300, 300, 8, 2, 128, True, "nonmono"),
    (1, 257, 257, 4, 2, 128, True, "edge1"),
    (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97]),  # right padding
    (1, 2064, 2064, 8, 2, 128, True, "nonmono"),
    (2, 300, 300, 4, 2, 32, True, "nonmono"),
    (2, 300, 300, 4, 2, 32, False, "nonmono"),
    (2, 300, 300, 4, 2, 64, True, "nonmono"),
    (2, 300, 300, 4, 2, 64, False, "edge1"),
    (2, 300, 300, 4, 2, 128, False, "nonmono"),
    (1, 129, 129, 4, 1, 128, True, 0),
    (2, 200, 333, 8, 2, 64, True, 0),  # causal, Sq < Skv
    (2, 333, 200, 8, 2, 128, True, 0),  # causal, Sq > Skv
    # head_dim 256: a training row of path 15 (8 heads on 1 KV head, packed
    # documents), ids up and down, a boundary past a tile edge, Sq != Skv
    (1, 2048, 2048, 8, 1, 256, True, 4),
    (2, 300, 300, 4, 2, 256, True, "nonmono"),
    (1, 257, 257, 4, 2, 256, True, "edge1"),
    (2, 200, 333, 4, 4, 256, False, 0),
]


@pytest.mark.torch_port
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d,causal,seg", BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, b, s_q, s_kv, h, kv, d, causal, seg):
    ids = _bwd_segments(cuda, seg, b, s_q)
    q, k, v, o, lse, do = _bwd_inputs(cuda, b, s_q, s_kv, h, kv, d, causal, ids)
    tfa.reset_launches()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=ids)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         segment_ids=ids)
    torch.cuda.synchronize()
    assert (tfa.launches_dq, tfa.launches_dkv, tfa.launches) == (1, 1, 0)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == ref.shape and x.dtype == torch.bfloat16
        assert bool(torch.isfinite(x.float()).all()), name
        scale = float(ref.float().abs().max())
        torch.testing.assert_close(x.float(), ref.float(), rtol=0, atol=BWD_TOL * scale,
                                   msg=name)


@pytest.mark.torch_port
@pytest.mark.parametrize("seg", ["train", None])
def test_flash_bwd_kernels_are_bitwise_repeatable(cuda, seg):
    """K2a owns query rows and K2b owns keys: no atomics, every sum in one
    fixed order, so two calls give the same bits."""
    ids = _bwd_segments(cuda, seg, 4, 2048) if seg else None
    q, k, v, o, lse, do = _bwd_inputs(cuda, 4, 2048, 2048, 32, 8, 128, True, ids)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, segment_ids=ids)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, segment_ids=ids)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.torch_port
def test_flash_attention_autograd_launches_k1_k2(cuda):
    """One forward and backward through ``flash_attention``: one K1, one K2a,
    one K2b, and the gradients of the plain attention's autograd."""
    q, k, v, _ = _inputs(cuda, 2, 256, 256, 8, 2, 64)
    seg = _packed_segments(cuda, 2, 256, 2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention(*leaves, causal=True, segment_ids=seg)
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == (1, 1, 1)
    ref_leaves = [t.clone().float().requires_grad_() for t in (q, k, v)]
    ref_out, _ = tfa.flash_attention_plain(*ref_leaves, causal=True, segment_ids=seg)
    ref = torch.autograd.grad(ref_out.square().sum(), ref_leaves)
    for name, x, r in zip(("dq", "dk", "dv"), grads, ref):
        scale = float(r.abs().max())
        torch.testing.assert_close(x.float(), r, rtol=0, atol=3 * BWD_TOL * scale, msg=name)


@pytest.mark.torch_port
def test_flash_bwd_raises_instead_of_falling_back(cuda):
    """An unported dtype (float64) or head dim (48), a bad lse or a strided
    gradient raise on the card, and nothing launches."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, 1, 64, 64, 4, 2, 128, True, None)
    tfa.reset_launches()
    with pytest.raises(NotImplementedError, match="float64.*ROADMAP"):
        tfa.flash_attention_bwd(q.double(), k.double(), v.double(), o.double(), lse,
                                do.double())
    q48, k48, v48, _ = _inputs(cuda, 1, 64, 64, 4, 2, 48, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="head_dim.*ROADMAP"):
        tfa.flash_attention_bwd(q48, k48, v48, q48, lse, q48)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, k, v, o, lse.bfloat16(), do)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd(q, k, v, o, lse, do.transpose(1, 2).contiguous().transpose(1, 2))
    assert (tfa.launches_dq, tfa.launches_dkv, tfa.launches_dq_f16, tfa.launches_dkv_f16,
            tfa.launches_dq_f32, tfa.launches_dkv_f32) == (0,) * 6


# ---------------------------------------------------------------------------
# K5a/K5b (MLP backward) and K6 (projection backward)
# ---------------------------------------------------------------------------

# Each output within MM_TOL of its own largest magnitude: the kernels and the
# plain versions take the same bf16 operands with f32 sums in other orders,
# and round dgate, dup and inner to bf16 at the same places; a sum rounded
# to bf16 on one side can land one ulp off (2^-8 relative) on the other.
MM_TOL = 1e-2


def _rnd(cuda, *shape, seed, scale=1.0, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)


def _assert_scaled(name, got, want, tol=MM_TOL):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert bool(torch.isfinite(got.float()).all()), name
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale,
                               msg=name)


@pytest.mark.torch_port
@pytest.mark.parametrize("a_mn,b_mn", [(False, False), (False, True), (True, False),
                                       (True, True)], ids=["KK", "KM", "MK", "MM"])
def test_gemm_core_layouts_match_plain(cuda, a_mn, b_mn):
    """The K5 kernels' GEMM core alone (csrc/gemm_sm90.cuh) in its four
    operand layouts, each operand K-major or MN-major, against the plain
    product: M = 320 and N = 384 overhang the 128 x 256 tiles, K = 2064 = 16
    x 129 the 64-deep k-tiles (TMA fills the rest with zeros)."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    m, n, k = 320, 384, 2064
    a = _rnd(cuda, *((k, m) if a_mn else (m, k)), seed=20)
    b = _rnd(cuda, *((k, n) if b_mn else (n, k)), seed=21)
    c = tmb.gemm_core(a, b, a_mn, b_mn)
    torch.cuda.synchronize()
    _assert_scaled("c", c, tmb.gemm_core_plain(a, b, a_mn, b_mn))


def _mlp_inputs(cuda, n, d, f, seed=1, dtype=torch.bfloat16):
    """h, w_gu, w_down, g and the forward's gate/up as the halves of one gu
    buffer (row stride 2F), as the op saves them, in ``dtype``."""
    h = _rnd(cuda, n, d, seed=seed, dtype=dtype)
    w_gu = _rnd(cuda, d, 2 * f, seed=seed + 1, scale=d**-0.5, dtype=dtype)
    w_down = _rnd(cuda, f, d, seed=seed + 2, scale=f**-0.5, dtype=dtype)
    g = _rnd(cuda, n, d, seed=seed + 3, dtype=dtype)
    gu = (h.float() @ w_gu.float()).to(dtype)
    gate, up = gu.chunk(2, dim=-1)
    return h, w_gu, w_down, g, gate, up


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f", [(1024, 512, 768), (2064, 256, 384), (2064, 384, 384),
                                   (16, 384, 384), (16, 256, 128)])
def test_mlp_bwd_kernels_match_plain(cuda, n, d, f):
    """K5a and K5b against their plain versions, gate/up as the strided
    halves of one gu buffer and K5b fed the same dgu as its plain version:
    a ragged token edge (N = 2064 = 16 x 129), the least N (16), and D or F
    odd multiples of 128 (384), which 256-wide tiles overhang."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    h, w_gu, w_down, g, gate, up = _mlp_inputs(cuda, n, d, f)
    tmb.reset_launches()
    dgu, d_w_down = tmb.dgu_dwdown(g, w_down, gate, up)
    dgu_ref, d_w_down_ref = tmb.dgu_dwdown_plain(g, w_down, gate, up)
    dh, d_w_gu = tmb.dh_dwgu(h, dgu, w_gu)
    dh_ref, d_w_gu_ref = tmb.dh_dwgu_plain(h, dgu, w_gu)
    torch.cuda.synchronize()
    assert (tmb.launches_dgu, tmb.launches_dh) == (1, 1)
    for name, x, r in (("dgu", dgu, dgu_ref), ("d_w_down", d_w_down, d_w_down_ref),
                       ("dh", dh, dh_ref), ("d_w_gu", d_w_gu, d_w_gu_ref)):
        _assert_scaled(name, x, r)


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f", [(2064, 384, 384), (4096, 1024, 2816)])
def test_mlp_bwd_kernels_are_bitwise_repeatable(cuda, n, d, f):
    """Three calls of K5a and K5b give the same bits: no atomics in any sum,
    and K5a's d_w_down tiles read the inner that its dinner tiles wrote in
    the same launch only after it is complete (a missing proxy fence or
    acquire would show as a stale tile in some call)."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    h, w_gu, w_down, g, gate, up = _mlp_inputs(cuda, n, d, f, seed=30)
    runs = []
    for _ in range(3):
        dgu, d_w_down = tmb.dgu_dwdown(g, w_down, gate, up)
        runs.append((dgu, d_w_down, *tmb.dh_dwgu(h, dgu, w_gu)))
    torch.cuda.synchronize()
    for run in runs[1:]:
        for name, x, r in zip(("dgu", "d_w_down", "dh", "d_w_gu"), run, runs[0]):
            assert torch.equal(x, r), name
    _assert_scaled("d_w_down", runs[0][1], tmb.dgu_dwdown_plain(g, w_down, gate, up)[1])


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f,strided", [(1024, 512, 256, False), (2064, 256, 384, True)])
def test_proj_bwd_kernel_matches_plain(cuda, n, d, f, strided):
    """K6 against its plain version; with ``strided`` the incoming gradient
    is a column slice of a wider one (row stride > F), as the grad of a fused
    projection's split."""
    from ditl_tpu_torch.ops import projection as tpr

    x = _rnd(cuda, 1, n, d, seed=5)
    w = _rnd(cuda, d, f, seed=6, scale=d**-0.5)
    g = _rnd(cuda, 1, n, f + 128 if strided else f, seed=7)[..., :f]
    tpr.reset_launches()
    dx, dw = tpr.projection_bwd(x, w, g, blocks=(16, 128))  # admits N = 2064
    dx_ref, dw_ref = tpr.projection_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    assert tpr.launches == 1
    _assert_scaled("dx", dx, dx_ref)
    _assert_scaled("dw", dw, dw_ref)


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f,ld", [(4096, 1024, 256, 0), (2064, 256, 384, 512)],
                         ids=["wk/wv-like", "strided g"])
def test_proj_bwd_kernel_is_bitwise_repeatable_in_both_orders(cuda, n, d, f, ld):
    """K6 with dx tiles first, dw tiles first and the default order: each
    output tile is summed by one block in one order, so every call gives the
    same bits, within MM_TOL of the plain version."""
    from ditl_tpu_torch.ops import projection as tpr

    x = _rnd(cuda, 1, n, d, seed=40)
    w = _rnd(cuda, d, f, seed=41, scale=d**-0.5)
    g = _rnd(cuda, 1, n, ld or f, seed=42)[..., :f]
    runs = [tpr.projection_bwd(x, w, g, blocks=(16, 128), dx_first=order)
            for order in (None, True, False, None)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert torch.equal(run[0], runs[0][0]) and torch.equal(run[1], runs[0][1])
    dx_ref, dw_ref = tpr.projection_bwd_plain(x, w, g)
    _assert_scaled("dx", runs[0][0], dx_ref)
    _assert_scaled("dw", runs[0][1], dw_ref)


@pytest.mark.torch_port
def test_k5_kernels_keep_the_bits_of_their_first_core_build(cuda):
    """K5a and K5b on fixed integer-made inputs give the bytes the kernels
    built from commit 7db4668 gave (``chip_smoke.K5_DIGESTS``): moving K5b
    onto the kernel it shares with K6 changed no bit."""
    import pathlib
    import sys

    from ditl_tpu_torch.ops import mlp_bwd as tmb

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke._k5_digests(tmb) == chip_smoke.K5_DIGESTS


@pytest.mark.torch_port
def test_mlp_and_projection_autograd_launch_k5_k6(cuda):
    """One forward and backward through ``mlp_gu`` and ``projection`` with
    ``"pallas"``: one K5a, one K5b and one K6 launch, and the gradients of the
    einsum spelling."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb
    from ditl_tpu_torch.ops import projection as tpr
    from ditl_tpu_torch.ops.mlp import mlp_gu

    h = _rnd(cuda, 2, 256, 256, seed=8)
    w_gu = _rnd(cuda, 256, 512, seed=9, scale=1 / 16)
    w_down = _rnd(cuda, 256, 256, seed=10, scale=1 / 16)
    w = _rnd(cuda, 256, 256, seed=11, scale=1 / 16)
    grads = {}
    for impl in ("pallas", "xla"):
        leaves = [t.clone().requires_grad_() for t in (h, w_gu, w_down, w)]
        tmb.reset_launches()
        tpr.reset_launches()
        out = mlp_gu(*leaves[:3], impl, (64, 128, 128))
        out = tpr.projection(out, leaves[3], bwd_impl=impl, blocks=(64, 128))
        grads[impl] = torch.autograd.grad(out.float().square().sum(), leaves)
        torch.cuda.synchronize()
        want = (1, 1, 1) if impl == "pallas" else (0, 0, 0)
        assert (tmb.launches_dgu, tmb.launches_dh, tpr.launches) == want
    for name, x, r in zip(("dh", "d_w_gu", "d_w_down", "dw"), grads["pallas"],
                          grads["xla"]):
        scale = float(r.float().abs().max())
        torch.testing.assert_close(x.float(), r.float(), rtol=0, atol=3 * MM_TOL * scale,
                                   msg=name)


@pytest.mark.torch_port
def test_mlp_and_projection_bwd_raise_instead_of_falling_back(cuda):
    """An unported dtype (float64: ROADMAP.md §2), operands of mixed dtypes
    and shapes ``supports`` rejects raise on the card, and nothing
    launches."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb
    from ditl_tpu_torch.ops import projection as tpr

    h = _rnd(cuda, 1, 64, 256, seed=12)
    w_gu, w_down = _rnd(cuda, 256, 256, seed=13), _rnd(cuda, 128, 256, seed=14)
    gate, up = _rnd(cuda, 1, 64, 256, seed=15).chunk(2, dim=-1)
    tmb.reset_launches()
    tpr.reset_launches()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmb.fused_mlp_bwd(h.double(), w_gu.double(), w_down.double(), gate.double(),
                          up.double(), h.double())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpr.projection_bwd(h.double(), w_gu.double(), h.double())
    with pytest.raises(ValueError, match="one dtype"):  # an f32 g, the rest bf16
        tmb.fused_mlp_bwd(h, w_gu, w_down, gate, up, h.float())
    with pytest.raises(ValueError, match="one dtype"):
        tpr.projection_bwd(h.float(), w_gu, h.float())
    with pytest.raises(ValueError, match="tile"):
        tpr.projection_bwd(h[:, :50], w_gu, h[:, :50])
    assert (tmb.launches_dgu, tmb.launches_dh, tpr.launches, tmb.launches_dgu_f16,
            tmb.launches_dh_f16, tpr.launches_f16, tmb.launches_dgu_f32,
            tmb.launches_dh_f32, tpr.launches_f32) == (0,) * 9


# ---------------------------------------------------------------------------
# The f32 kernels: K1-f32, K2a-f32, K2b-f32 (csrc/flash_f32.cu) and K3-f32,
# its verify and K4-f32 (csrc/paged_attention_f32.cu)
# ---------------------------------------------------------------------------

# f32 tolerances: the kernels and the plain versions take the same f32
# operands with f32 sums in other orders (FFMA chains in the paged
# kernels, 3xTF32 products, each good to about 2^-21, in K1-f32, K2a-f32 and
# K2b-f32, against cuBLAS's f32 GEMMs, TF32 off) and the same exponent, so
# they differ by f32 round-off:
# o and lse within F32_TOL, each gradient within F32_TOL of its own largest
# magnitude, paged attention within PAGED_F32_TOL (the reference's own f32
# tolerance, tests/test_torch_paged.py).
F32_TOL = 1e-4
PAGED_F32_TOL = 2e-5

# (b, s_q, s_kv, h, kv, d, causal, seg): the serving prefill (right-padded,
# G = 4), the training pipeline's packed rows at qwen2-0.5b's heads (G = 7,
# D = 64), G = 7 with ids that go up and down, non-causal Sq < Skv, causal
# Sq > Skv, a boundary one row past a tile edge, MQA; then D = 256 (path
# 15's heads, 8 on 1: its prefill and a packed training row; ids up and
# down; non-causal Sq != Skv); then G = 7 on one KV head at D = 64, B = 1,
# S = 2048, packed, where K2b-f32 splits its items into 9 runs of 25, a
# count that does not divide the group (``f32_dkv_splits``); then D = 256
# with a boundary one row past a tile edge, Sq = 257 (K1-f32's 16-key
# sub-tiles across both), and G = 16, path 16's prefill widths (128 heads on
# 8, D = 128), right-padded.
F32_FLASH_CASES = [
    (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97]),
    (4, 2048, 2048, 14, 2, 64, True, "train"),
    (2, 300, 300, 14, 2, 64, True, "nonmono"),
    (2, 200, 333, 8, 2, 64, False, None),
    (2, 333, 200, 8, 2, 128, True, None),
    (1, 257, 257, 4, 2, 128, True, "edge1"),
    (1, 129, 129, 4, 1, 128, True, None),
    (2, 300, 300, 4, 2, 64, False, "edge1"),
    (4, 512, 512, 8, 1, 256, True, [512, 401, 230, 97]),
    (1, 2048, 2048, 8, 1, 256, True, "train"),
    (2, 300, 300, 4, 2, 256, True, "nonmono"),
    (2, 200, 333, 4, 4, 256, False, None),
    (1, 2048, 2048, 7, 1, 64, True, "train"),
    (1, 257, 257, 4, 2, 256, True, "edge1"),
    (2, 256, 256, 128, 8, 128, True, [256, 131]),
]


@pytest.fixture
def no_tf32(cuda):
    """The plain versions' f32 products in full f32."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = before


def _f32_case(cuda, b, s_q, s_kv, h, kv, d, seg, seed=0):
    lengths = seg if isinstance(seg, list) else None
    q, k, v, ids = _inputs(cuda, b, s_q, s_kv, h, kv, d, lengths, seed=seed,
                           dtype=torch.float32)
    if isinstance(seg, str):
        ids = _segment_ids(cuda, seg, b, s_q)
    return q, k, v, ids


@pytest.mark.torch_port
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d,causal,seg", F32_FLASH_CASES)
def test_flash_f32_fwd_kernel_matches_plain(no_tf32, b, s_q, s_kv, h, kv, d, causal, seg):
    q, k, v, ids = _f32_case(no_tf32, b, s_q, s_kv, h, kv, d, seg)
    tfa.reset_launches()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=ids)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=causal, segment_ids=ids)
    torch.cuda.synchronize()
    assert (tfa.launches_f32, tfa.launches) == (1, 0)
    assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
    torch.testing.assert_close(o, o_ref, atol=F32_TOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=F32_TOL, rtol=0)


@pytest.mark.torch_port
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d,causal,seg", F32_FLASH_CASES)
def test_flash_f32_bwd_kernels_match_plain(no_tf32, b, s_q, s_kv, h, kv, d, causal, seg):
    q, k, v, ids = _f32_case(no_tf32, b, s_q, s_kv, h, kv, d, seg)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=ids)
    do = torch.randn(o.shape, generator=torch.Generator(device=no_tf32).manual_seed(1),
                     device=no_tf32)
    tfa.reset_launches()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=ids)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         segment_ids=ids)
    torch.cuda.synchronize()
    assert (tfa.launches_dq_f32, tfa.launches_dkv_f32, tfa.launches_dq) == (1, 1, 0)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == ref.shape and x.dtype == torch.float32, name
        assert bool(torch.isfinite(x).all()), name
        scale = float(ref.abs().max())
        torch.testing.assert_close(x, ref, rtol=0, atol=F32_TOL * scale, msg=name)


@pytest.mark.torch_port
@pytest.mark.parametrize("case", [0, 1, 9, 13, 14])
def test_flash_f32_kernels_are_bitwise_repeatable(no_tf32, case):
    """Every f32 block owns its outputs and sums in one fixed order, and
    K2b-f32's runs are summed in order by a second kernel (path 15's packed
    row, case 9, takes 5 runs): two calls of each kernel give the same
    bits. K1-f32 at each of its instances: D = 128 with two warpgroups and
    32-key sub-tiles (cases 0, 14), D = 64 with 64-key sub-tiles (1), D =
    256 with the warpgroups on the two halves of the head dim and 16-key
    sub-tiles (9, 13)."""
    b, s_q, s_kv, h, kv, d, causal, seg = F32_FLASH_CASES[case]
    q, k, v, ids = _f32_case(no_tf32, b, s_q, s_kv, h, kv, d, seg)
    fwd = [tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=ids) for _ in range(2)]
    o, lse = fwd[0]
    do = torch.randn_like(o)
    bwd = [tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=ids)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*fwd))
    assert all(torch.equal(x, y) for x, y in zip(*bwd))


@pytest.mark.torch_port
def test_flash_attention_f32_autograd_launches_k1_k2(no_tf32):
    """One forward and backward through ``flash_attention`` in f32 at G = 7:
    one K1-f32, one K2a-f32, one K2b-f32, no bf16 kernel, and the gradients
    of the plain attention's autograd."""
    q, k, v, _ = _inputs(no_tf32, 2, 256, 256, 14, 2, 64, dtype=torch.float32)
    seg = _packed_segments(no_tf32, 2, 256, 2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention(*leaves, causal=True, segment_ids=seg)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    torch.cuda.synchronize()
    assert (tfa.launches_f32, tfa.launches_dq_f32, tfa.launches_dkv_f32) == (1, 1, 1)
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == (0, 0, 0)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out, _ = tfa.flash_attention_plain(*ref_leaves, causal=True, segment_ids=seg)
    ref = torch.autograd.grad(ref_out.square().sum(), ref_leaves)
    for name, x, r in zip(("dq", "dk", "dv"), grads, ref):
        scale = float(r.abs().max())
        torch.testing.assert_close(x, r, rtol=0, atol=F32_TOL * scale, msg=name)


@pytest.mark.torch_port
@pytest.mark.parametrize("b,h,kv,d,ps,tail_len,lengths,starts",
                         PAGED_CASES + EXTRA_SINGLE_CASES)
def test_paged_f32_kernels_match_plain(no_tf32, b, h, kv, d, ps, tail_len, lengths, starts):
    """K3-f32 and K4-f32 (both on the tensor-core kernel: G = 1, 2, 4, 8, 16
    and 20, D = 32, 64, 96, 128 and 256) against the plain version and the
    split twin; three calls give the same bits, each one launch on its own
    counter; a dead slot gives zeros."""
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, dtype=torch.float32)
    low = torch.minimum(st, lens).contiguous()
    tpa.reset_launches()
    o3 = [tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st)
          for _ in range(3)]
    o4 = [tpa.paged_attention(q, kp, vp, table, low) for _ in range(3)]
    r3 = tpa.paged_attention_plain(q, kp, vp, table, lens, tk, tv, st)
    r4 = tpa.paged_attention_plain(q, kp, vp, table, low)
    s3 = tpa.paged_attention_split_plain(q, kp, vp, table, lens, tk, tv, st)
    s4 = tpa.paged_attention_split_plain(q, kp, vp, table, low)
    torch.cuda.synchronize()
    assert {n: getattr(tpa, n) for n in tpa._COUNTERS.values() if getattr(tpa, n)} == {
        "launches_tail_f32": 3, "launches_f32": 3}
    for o, r, s_ in ((o3, r3, s3), (o4, r4, s4)):
        assert o[0].dtype == torch.float32 and all(torch.equal(o[0], x) for x in o[1:])
        torch.testing.assert_close(o[0], r, atol=PAGED_F32_TOL, rtol=0)
        torch.testing.assert_close(o[0], s_, atol=PAGED_F32_TOL, rtol=0)
    dead = [i for i, n in enumerate(lengths) if n == 0]
    assert all(bool((o3[0][i] == 0).all()) for i in dead)


# The f32 verify's row-tile boundaries (b, Q, h, kv, d, ps, tail_len,
# lengths, starts, maxp): 16 rows a KV head (one row tile: G = 4, Q = 4), 17
# (G = 1, Q = 17), 32 (G = 16, Q = 2) and 33 (G = 3, Q = 11), each with a
# dead slot and the page 16 axis whose tail starts mid-tile.
F32_VERIFY_ROW_CASES = [
    (3, 4, 8, 2, 128, 16, 24, [0, 40, 21], [0, 33, 20], 3),
    (3, 17, 4, 4, 64, 16, 40, [0, 40, 21], [0, 33, 20], 3),
    (3, 2, 32, 2, 128, 16, 24, [0, 40, 21], [0, 33, 20], 3),
    (3, 11, 6, 2, 96, 16, 32, [0, 40, 21], [0, 33, 20], 3),
]


@pytest.mark.torch_port
@pytest.mark.parametrize("case", range(len(VERIFY_CASES) + len(F32_VERIFY_ROW_CASES)))
def test_paged_f32_verify_kernel_matches_plain(no_tf32, case):
    """K3-f32's verify (the tensor-core kernel, at every row-tile count)
    against the plain version's 4-D branch and the split twin, on the verify
    cases (144 rows at D = 256, a tile mixing page, dead and tail rows
    among them) and at 16, 17, 32 and 33 rows a KV head; three calls give
    the same bits; a 4-D q with Q = 1 gives the 3-D call's bits; each call
    counts one f32 verify launch and no other."""
    b, nq, h, kv, d, ps, tail_len, lengths, starts, maxp = (
        VERIFY_CASES + F32_VERIFY_ROW_CASES)[case]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=case, nq=nq,
        maxp=maxp, dtype=torch.float32)
    tail = dict(tail_k=tk, tail_v=tv, starts=st)
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kp, vp, table, lens, **tail) for _ in range(3)]
    assert {n: getattr(tpa, n) for n in tpa._COUNTERS.values() if getattr(tpa, n)} == {
        "launches_verify_f32": 3}
    r = tpa.paged_attention_plain(q, kp, vp, table, lens, tk, tv, st)
    sp = tpa.paged_attention_split_plain(q, kp, vp, table, lens, tk, tv, st)
    o41 = tpa.paged_attention(q[:, :1].contiguous(), kp, vp, table, lens, **tail)
    o3 = tpa.paged_attention(q[:, 0].contiguous(), kp, vp, table, lens, **tail)
    torch.cuda.synchronize()
    o = runs[0]
    assert o.shape == q.shape and all(torch.equal(x, o) for x in runs[1:])
    torch.testing.assert_close(o, r, atol=PAGED_F32_TOL, rtol=0)
    torch.testing.assert_close(o, sp, atol=PAGED_F32_TOL, rtol=0)
    assert torch.equal(o41[:, 0], o3)
    dead = [i for i, n in enumerate(lengths) if n == 0]
    assert all(bool((o[i] == 0).all()) for i in dead)


# ---------------------------------------------------------------------------
# The f32 MLP and projection backward kernels: K5a-f32, K5b-f32 and K6-f32
# (csrc/gemm_f32.cu)
# ---------------------------------------------------------------------------

# 3xTF32 products (each good to about 2^-21) summed in f32 in another order
# than the plain versions' SGEMMs (TF32 off): each output within MM_F32_TOL
# of its own largest magnitude (chip_smoke.F32_MM_TOL).
MM_F32_TOL = chip_smoke.F32_MM_TOL


F32 = torch.float32


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f", [(8192, 896, 4864), (2064, 384, 384), (16, 384, 384),
                                   (2064, 256, 128), (2000, 384, 640), (2000, 384, 600)])
def test_mlp_bwd_f32_kernels_match_plain(no_tf32, n, d, f):
    """K5a-f32 and K5b-f32 against their plain versions: qwen2-0.5b's
    training step (N = 8192, D = 896, F = 4864; d_w_down split in 4 by
    f32_dwdown_splits), a ragged token edge (N = 2064), the least N, D and F
    odd multiples of 128; gate/up as the strided halves of gu, K5b-f32 fed
    the same dgu as its plain version. N = 2064 splits d_w_down over the
    tokens (f32_weight_splits). N = 2000 is no multiple of the 128-row tiles
    nor of the 32-token k-tiles, and 2F = 1280 takes ten 128-column tiles
    beside D = 384's three; F = 600 is no multiple of 128 either, so K5a's
    dinner tiles, its SwiGLU epilogue and its d_w_down rows and K5b's d_w_gu
    columns end mid-tile."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    h, w_gu, w_down, g, gate, up = _mlp_inputs(no_tf32, n, d, f, dtype=F32)
    tmb.reset_launches()
    dgu, d_w_down = tmb.dgu_dwdown(g, w_down, gate, up)
    dgu_ref, d_w_down_ref = tmb.dgu_dwdown_plain(g, w_down, gate, up)
    dh, d_w_gu = tmb.dh_dwgu(h, dgu, w_gu)
    dh_ref, d_w_gu_ref = tmb.dh_dwgu_plain(h, dgu, w_gu)
    torch.cuda.synchronize()
    assert (tmb.launches_dgu_f32, tmb.launches_dh_f32, tmb.launches_dgu,
            tmb.launches_dh) == (1, 1, 0, 0)
    for name, x, r in (("dgu", dgu, dgu_ref), ("d_w_down", d_w_down, d_w_down_ref),
                       ("dh", dh, dh_ref), ("d_w_gu", d_w_gu, d_w_gu_ref)):
        _assert_scaled(name, x, r, MM_F32_TOL)


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f,ld", [(8192, 896, 896, 0), (8192, 896, 128, 0),
                                      (2064, 256, 384, 512), (16, 384, 128, 0),
                                      (2000, 384, 640, 0), (2000, 384, 600, 0),
                                      (2000, 384, 36, 0), (512, 256, 4096, 0)],
                         ids=["wq/wo", "wk/wv", "ragged, strided g", "N=16", "N=2000",
                              "F=600", "F=36", "dx longer"])
def test_proj_bwd_f32_kernel_matches_plain(no_tf32, n, d, f, ld):
    """K6-f32 against its plain version at qwen2-0.5b's wq/wo (dw split in
    3 over the tokens) and wk/wv (dw split in 8), a ragged token edge with
    the gradient a column slice of a wider one, the least N, N = 2000 (a
    multiple of neither the 128-row tiles nor the 32-token k-tiles), F = 600
    (dx's contraction and dw's columns end mid-tile) and F = 36 (dx's
    contraction one partial k-tile), both through ``proj_bwd_rows`` since
    the reference's ``supports`` wants F a multiple of 128, and a shape
    whose dx contracts over more than dw's split does, so dx's tiles go
    first."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb
    from ditl_tpu_torch.ops import projection as tpr

    if (n, f) == (512, 4096):
        assert tmb.f32_proj_splits(n, d, f)[1] < f
    x = _rnd(no_tf32, 1, n, d, seed=5, dtype=F32)
    w = _rnd(no_tf32, d, f, seed=6, scale=d**-0.5, dtype=F32)
    g = _rnd(no_tf32, 1, n, ld or f, seed=7, dtype=F32)[..., :f]
    tpr.reset_launches()
    if tpr.supports(n, d, f, (16, 128)):
        dx, dw = tpr.projection_bwd(x, w, g, blocks=(16, 128))
    else:
        dx, dw = tpr.proj_bwd_rows(x.reshape(n, d), w, g.reshape(n, f))
        dx = dx.reshape(1, n, d)
    dx_ref, dw_ref = tpr.projection_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    assert (tpr.launches_f32, tpr.launches) == (1, 0)
    _assert_scaled("dx", dx, dx_ref, MM_F32_TOL)
    _assert_scaled("dw", dw, dw_ref, MM_F32_TOL)


@pytest.mark.torch_port
def test_mlp_proj_f32_kernels_are_bitwise_repeatable(no_tf32):
    """Three calls of K5a-f32, K5b-f32 and K6-f32 give the same bits: one
    block sums each output tile (or split), the splits are added in a fixed
    order, and K5a-f32's d_w_down grid reads inner only after the dinner
    grid wrote it (stream order). K6-f32 at qwen2-0.5b's wk/wv (dw split in
    8) and wq/wo (dw split in 3)."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb
    from ditl_tpu_torch.ops import projection as tpr

    h, w_gu, w_down, g, gate, up = _mlp_inputs(no_tf32, 2064, 384, 384, seed=30, dtype=F32)
    x = _rnd(no_tf32, 1, 8192, 896, seed=31, dtype=F32)
    w = _rnd(no_tf32, 896, 128, seed=32, scale=896**-0.5, dtype=F32)
    gp = _rnd(no_tf32, 1, 8192, 128, seed=33, dtype=F32)
    wq = _rnd(no_tf32, 896, 896, seed=34, scale=896**-0.5, dtype=F32)
    gq = _rnd(no_tf32, 1, 8192, 896, seed=35, dtype=F32)
    assert tmb.f32_proj_splits(8192, 896, 896)[0] > 1
    runs = []
    for _ in range(3):
        dgu, d_w_down = tmb.dgu_dwdown(g, w_down, gate, up)
        runs.append((dgu, d_w_down, *tmb.dh_dwgu(h, dgu, w_gu),
                     *tpr.projection_bwd(x, w, gp, blocks=(16, 128)),
                     *tpr.projection_bwd(x, wq, gq, blocks=(16, 128))))
    torch.cuda.synchronize()
    names = ("dgu", "d_w_down", "dh", "d_w_gu", "dx", "dw", "dx wq/wo", "dw wq/wo")
    for run in runs[1:]:
        for name, a, b in zip(names, run, runs[0]):
            assert torch.equal(a, b), name


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f,splits", [(2064, 384, 384, 8), (8192, 896, 4864, 1)],
                         ids=["d_w_gu split", "no split"])
def test_mlp_dh_f32_kernel_is_bitwise_repeatable(no_tf32, n, d, f, splits):
    """Two calls of K5b-f32 give the same bits, with d_w_gu split over the
    tokens (f32_weight_splits: eight splits summed in order by
    splitk_sum_f32_kernel) and without (path 10's shapes): one block owns
    each output tile or split and sums its k-tiles in one order, no
    atomics."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    assert tmb.f32_weight_splits(d, 2 * f, n)[0] == splits
    h, w_gu, w_down, g, gate, up = _mlp_inputs(no_tf32, n, d, f, seed=40, dtype=F32)
    dgu, _ = tmb.dgu_dwdown(g, w_down, gate, up)
    tmb.reset_launches()
    runs = [tmb.dh_dwgu(h, dgu, w_gu) for _ in range(2)]
    torch.cuda.synchronize()
    assert tmb.launches_dh_f32 == 2
    for name, a, b in zip(("dh", "d_w_gu"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f,splits", [(8192, 896, 4864, 4), (2064, 384, 384, 13),
                                          (512, 1536, 1408, 1)],
                         ids=["path 10, d_w_down split 4", "split 13", "no split"])
def test_mlp_dgu_f32_kernel_is_bitwise_repeatable(no_tf32, n, d, f, splits):
    """Two calls of K5a-f32 give the same bits, with d_w_down split over the
    tokens (f32_dwdown_splits: path 10's 266 tiles in four splits, or
    f32_weight_splits' count for a grid of nine tiles, summed in order by
    splitk_sum_f32_kernel) and unsplit (132 tiles, one wave): one block owns
    each output tile or split and sums its k-tiles in one order, and the
    d_w_down grid reads inner only after the dinner grid wrote it."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    assert tmb.f32_dwdown_splits(f, d, n)[0] == splits
    h, w_gu, w_down, g, gate, up = _mlp_inputs(no_tf32, n, d, f, seed=41, dtype=F32)
    tmb.reset_launches()
    runs = [tmb.dgu_dwdown(g, w_down, gate, up) for _ in range(2)]
    torch.cuda.synchronize()
    assert tmb.launches_dgu_f32 == 2
    for name, a, b in zip(("dgu", "d_w_down"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.torch_port
def test_mlp_and_projection_f32_autograd_launch_k5_k6(no_tf32):
    """One f32 forward and backward through ``mlp_gu`` and ``projection``
    with ``"pallas"``: one K5a-f32, one K5b-f32 and one K6-f32 launch, no
    bf16 launch, and the einsum spelling's gradients within MM_F32_TOL."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb
    from ditl_tpu_torch.ops import projection as tpr
    from ditl_tpu_torch.ops.mlp import mlp_gu

    h = _rnd(no_tf32, 2, 256, 256, seed=8, dtype=F32)
    w_gu = _rnd(no_tf32, 256, 512, seed=9, scale=1 / 16, dtype=F32)
    w_down = _rnd(no_tf32, 256, 256, seed=10, scale=1 / 16, dtype=F32)
    w = _rnd(no_tf32, 256, 256, seed=11, scale=1 / 16, dtype=F32)
    grads = {}
    for impl in ("pallas", "xla"):
        leaves = [t.clone().requires_grad_() for t in (h, w_gu, w_down, w)]
        tmb.reset_launches()
        tpr.reset_launches()
        out = mlp_gu(*leaves[:3], impl, (64, 128, 128))
        out = tpr.projection(out, leaves[3], bwd_impl=impl, blocks=(64, 128))
        grads[impl] = torch.autograd.grad(out.square().sum(), leaves)
        torch.cuda.synchronize()
        want = (1, 1, 1) if impl == "pallas" else (0, 0, 0)
        assert (tmb.launches_dgu_f32, tmb.launches_dh_f32, tpr.launches_f32) == want
        assert (tmb.launches_dgu, tmb.launches_dh, tpr.launches) == (0, 0, 0)
    for name, x, r in zip(("dh", "d_w_gu", "d_w_down", "dw"), grads["pallas"],
                          grads["xla"]):
        _assert_scaled(name, x, r, MM_F32_TOL)


# ---------------------------------------------------------------------------
# float16: K1-f16 (csrc/flash_fwd.cu), K3-f16, its verify, K4-f16 and the
# int8-pool forms (csrc/paged_attention.cu); an f32 q over int8 pools:
# K3-int8-f32 and its verify (csrc/paged_attention_f32.cu)
# ---------------------------------------------------------------------------

# float16 outputs at bf16's tolerance (2e-2: p and o rounded to float16,
# whose ulp is 8x finer than bf16's); f32 over int8 pools within
# PAGED_F32_TOL of the output's largest magnitude (FFMA in another order).
F16 = torch.float16


@pytest.mark.torch_port
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d,causal,seg", [
    (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97]),  # serving prefill
    (4, 2048, 2048, 32, 8, 128, True, "train"),  # the training batch, forward only
    (2, 300, 300, 8, 2, 64, True, "nonmono"),
    (2, 200, 333, 8, 4, 32, False, None),
    (1, 257, 257, 4, 2, 32, True, "edge1"),
    (2, 300, 300, 4, 2, 128, False, "nonmono"),
    (4, 512, 512, 8, 1, 256, True, [512, 401, 230, 97]),  # path 15's prefill
    (2, 300, 300, 4, 2, 256, True, "nonmono"),
    (2, 200, 333, 4, 4, 256, False, None),
    (1, 2048, 2048, 7, 1, 64, True, "train"),
])
def test_flash_f16_fwd_kernel_matches_plain(cuda, b, s_q, s_kv, h, kv, d, causal, seg):
    """K1-f16 against the plain forward in float16; two calls give the same
    bits; each call counts one K1-f16 launch and no other."""
    lengths = seg if isinstance(seg, list) else None
    q, k, v, ids = _inputs(cuda, b, s_q, s_kv, h, kv, d, lengths, dtype=F16)
    if isinstance(seg, str):
        ids = _segment_ids(cuda, seg, b, s_q)
    tfa.reset_launches()
    runs = [tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=ids) for _ in range(2)]
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=causal, segment_ids=ids)
    torch.cuda.synchronize()
    assert (tfa.launches_f16, tfa.launches, tfa.launches_f32) == (2, 0, 0)
    o, lse = runs[0]
    assert o.dtype == F16 and torch.equal(o, runs[1][0]) and torch.equal(lse, runs[1][1])
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-3)


def _close(o, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(o, ref, rtol=0, atol=PAGED_F32_TOL * float(ref.abs().max()))
    else:
        torch.testing.assert_close(o.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype,int8", [(F16, False), (F16, True), (torch.float32, True)])
@pytest.mark.parametrize("case", range(len(INT8_CASES)))
def test_paged_f16_and_f32_int8_kernels_match_plain(no_tf32, dtype, int8, case):
    """K3-f16 and K4-f16 (float16 pools), K3-int8-f16 (float16 q over int8
    pools) and K3-int8-f32 (f32 q over int8 pools) against the plain version
    and the split twin, on ``INT8_CASES`` (G = 1, 2, 4, 8, 16 and 20; D =
    32, 64, 96, 128 and 256; tiles mixing page and tail rows; dead slots);
    three calls give the same bits; each call counts on its own counter and
    on no other."""
    b, h, kv, d, ps, tail_len, lengths, starts = INT8_CASES[case]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=case, dtype=dtype)
    sfx = "_f16" if dtype == F16 else "_f32"
    scales = {}
    if int8:
        kp, vp, ks, vs = _int8_pools(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tpa.reset_launches()
    o3 = [tpa.paged_attention(q, kp, vp, table, lens, tail_k=tk, tail_v=tv, starts=st,
                              **scales) for _ in range(3)]
    args = (q, kp, vp, table, lens, tk, tv, st, *scales.values())
    checks = [(o3, tpa.paged_attention_plain(*args), tpa.paged_attention_split_plain(*args))]
    want = {"launches_tail" + ("_int8" if int8 else "") + sfx: 3}
    if not int8:
        low = torch.minimum(st, lens).contiguous()
        o4 = [tpa.paged_attention(q, kp, vp, table, low) for _ in range(3)]
        checks.append((o4, tpa.paged_attention_plain(q, kp, vp, table, low),
                       tpa.paged_attention_split_plain(q, kp, vp, table, low)))
        want["launches" + sfx] = 3
    torch.cuda.synchronize()
    assert {n: getattr(tpa, n) for n in tpa._COUNTERS.values() if getattr(tpa, n)} == want
    for o, r, s_ in checks:
        assert o[0].dtype == dtype and all(torch.equal(o[0], x) for x in o[1:])
        _close(o[0], r, dtype)
        _close(o[0], s_, dtype)
    dead = [i for i, n in enumerate(lengths) if n == 0]
    assert all(bool((o3[0][i] == 0).all()) for i in dead)


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, True), (F16, True),
                                        (torch.float32, True), (torch.float32, False)])
@pytest.mark.parametrize("case", [0, len(PAGED_CASES)])
def test_paged_single_query_clamps_out_of_range_page_ids(no_tf32, dtype, int8, case):
    """The single query (K3-int8 in bf16 and float16, K3-int8-f32, K3-f32 and
    K4-f32) with live page ids past the pool and below 0, at the decode tick
    and at D = 96 with a tile mixing page and tail rows: the ids clamp into
    the pool, as JAX's gather does (the split twin clamps; the plain version
    gets the clamped table); three calls give the same bits, one launch
    each."""
    b, h, kv, d, ps, tail_len, lengths, starts = INT8_CASES[case]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=case, dtype=dtype)
    scales = {}
    if int8:
        kp, vp, ks, vs = _int8_pools(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    bad = table.clone()
    bad[1, 0], bad[-1, 0] = kp.shape[0] + 7, -3
    clamped = bad.clamp(0, kp.shape[0] - 1)
    forms = [(dict(tail_k=tk, tail_v=tv, starts=st, **scales), lens, (tk, tv, st)),]
    if not int8:
        forms.append(({}, torch.minimum(st, lens).contiguous(), ()))
    for kw, ln, tail in forms:
        tpa.reset_launches()
        runs = [tpa.paged_attention(q, kp, vp, bad, ln, **kw) for _ in range(3)]
        r = tpa.paged_attention_plain(q, kp, vp, clamped, ln, *tail, *scales.values())
        sp = tpa.paged_attention_split_plain(q, kp, vp, bad, ln, *tail, *scales.values())
        torch.cuda.synchronize()
        assert sum(getattr(tpa, n) for n in tpa._COUNTERS.values()) == 3
        assert all(torch.equal(x, runs[0]) for x in runs[1:])
        _close(runs[0], r, dtype)
        _close(runs[0], sp, dtype)


@pytest.mark.torch_port
@pytest.mark.parametrize("form", ["verify", "no_tail"])
def test_paged_f32_tensor_core_forms_never_sync(no_tf32, form):
    """K3-f32's verify at 144 rows a KV head (G = 16, Q = 9) and K4-f32 at G
    = 16, both at D = 256 on the tensor-core kernel, launch under
    ``set_sync_debug_mode("error")`` and a CUDA graph captures them."""
    b, nq, h, kv, d, ps, tail_len, lengths, starts, maxp = BASE_VERIFY_CASES[-2]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts,
        nq=nq if form == "verify" else None, maxp=maxp, dtype=torch.float32)
    if form == "verify":
        kw, ln = dict(tail_k=tk, tail_v=tv, starts=st), lens
    else:
        kw, ln = {}, torch.minimum(st, lens).contiguous()
    tpa.paged_attention(q, kp, vp, table, ln, **kw)
    torch.cuda.synchronize()  # built and loaded
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.paged_attention(q, kp, vp, table, ln, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o = tpa.paged_attention(q, kp, vp, table, ln, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o, tpa.paged_attention(q, kp, vp, table, ln, **kw))


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype,int8", [(F16, False), (F16, True), (torch.float32, True)])
@pytest.mark.parametrize("case", range(len(VERIFY_CASES) + 1))
def test_paged_f16_and_f32_int8_verify_kernels_match_plain(no_tf32, dtype, int8, case):
    """The verify forms (K3-f16-verify, K3-int8-f16-verify, K3-int8-f32-verify)
    on the verify cases and at 80 query rows against the plain version's
    4-D branch and the split twin; two calls give the same bits; a 4-D q
    with Q = 1 gives the 3-D call's bits."""
    cases = (BASE_VERIFY_CASES + [chip_smoke.VERIFY_80[1:]]
             + VERIFY_CASES[len(BASE_VERIFY_CASES):])
    b, nq, h, kv, d, ps, tail_len, lengths, starts, maxp = cases[case]
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=case, nq=nq,
        maxp=maxp, dtype=dtype)
    scales = {}
    if int8:
        kp, vp, ks, vs = _int8_pools(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tail = dict(tail_k=tk, tail_v=tv, starts=st, **scales)
    counter = "launches_verify" + ("_int8" if int8 else "") + (
        "_f16" if dtype == F16 else "_f32")
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kp, vp, table, lens, **tail) for _ in range(2)]
    assert getattr(tpa, counter) == 2
    assert sum(getattr(tpa, n) for n in tpa._COUNTERS.values()) == 2
    args = (q, kp, vp, table, lens, tk, tv, st, *scales.values())
    r = tpa.paged_attention_plain(*args)
    sp = tpa.paged_attention_split_plain(*args)
    o41 = tpa.paged_attention(q[:, :1].contiguous(), kp, vp, table, lens, **tail)
    o3 = tpa.paged_attention(q[:, 0].contiguous(), kp, vp, table, lens, **tail)
    torch.cuda.synchronize()
    o = runs[0]
    assert o.shape == q.shape and o.dtype == dtype and torch.equal(runs[1], o)
    _close(o, r, dtype)
    _close(o, sp, dtype)
    assert torch.equal(o41[:, 0], o3)
    dead = [i for i, n in enumerate(lengths) if n == 0]
    assert all(bool((o[i] == 0).all()) for i in dead)


# K3-int8-f32's tensor-core kernel (paged_i8_mma_f32_kernel): (b, h, kv, d,
# ps, tail_len, lengths, starts, maxp) at path 16's G = 16, path 17's D = 96
# and D = 32 and 256 (the decode tick's ragged state: a dead slot, a partial
# page, an exact page boundary, starts == lengths); G = 20, two row groups
# of 16 and 4, at the split edges; and page 16 with five pages a slot, so
# the axis's tail starts at 80: the tile at 64 mixes page rows, dead rows
# and tail rows, a 100-column tail spans two more tiles and a split
# boundary, with a tail-only slot and a dead slot.
INT8_F32_MMA_CASES = [
    ("G=16", 8, 128, 8, 128, 256, 16, PAGED_CASES[0][6], PAGED_CASES[0][7], None),
    ("D=96", 8, 32, 32, 96, 256, 16, PAGED_CASES[0][6], PAGED_CASES[0][7], None),
    ("D=32", 8, 8, 4, 32, 256, 16, PAGED_CASES[0][6], PAGED_CASES[0][7], None),
    ("D=256", 8, 8, 1, 256, 256, 16, PAGED_CASES[0][6], PAGED_CASES[0][7], None),
    ("G=20", 3, 40, 2, 128, 16, 16, [257, 256, 140], [257, 250, 128], None),
    ("mixed tile", 5, 8, 2, 64, 16, 100, [100, 80, 175, 3, 0], [80, 70, 80, 0, 0], 5),
]


@pytest.mark.torch_port
@pytest.mark.parametrize("case", INT8_F32_MMA_CASES, ids=[c[0] for c in INT8_F32_MMA_CASES])
def test_paged_int8_f32_tensor_core_kernel_matches_plain(no_tf32, case):
    """K3-int8-f32 (f32 q over int8 pools, one query) on the tensor cores
    against the plain version and the split twin within PAGED_F32_TOL of the
    largest magnitude, at each group count, head dim and tile kind it
    takes; two calls give the same bits, a 4-D q with Q = 1 the 3-D call's,
    a dead slot zeros; each call counts one K3-int8-f32 launch."""
    _, b, h, kv, d, ps, tail_len, lengths, starts, maxp = case
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=d + h, maxp=maxp,
        dtype=torch.float32)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    tail = dict(tail_k=tk, tail_v=tv, starts=st, k_scale=ks, v_scale=vs)
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kq, vq, table, lens, **tail) for _ in range(2)]
    o4 = tpa.paged_attention(q[:, None].contiguous(), kq, vq, table, lens, **tail)
    assert {n: getattr(tpa, n) for n in tpa._COUNTERS.values() if getattr(tpa, n)} == {
        "launches_tail_int8_f32": 3}
    args = (q, kq, vq, table, lens, tk, tv, st, ks, vs)
    r, sp = tpa.paged_attention_plain(*args), tpa.paged_attention_split_plain(*args)
    torch.cuda.synchronize()
    o = runs[0]
    assert o.shape == q.shape and o.dtype == torch.float32
    assert torch.equal(runs[1], o) and torch.equal(o4[:, 0], o)
    _close(o, r, torch.float32)
    _close(o, sp, torch.float32)
    assert all(bool((o[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)


@pytest.mark.torch_port
@pytest.mark.parametrize("case", INT8_F32_MMA_CASES, ids=[c[0] for c in INT8_F32_MMA_CASES])
def test_paged_f32_tensor_core_kernel_matches_plain(no_tf32, case):
    """K3-f32 (f32 q over f32 pools, one query) on the tensor-core kernel's
    f32-pool instance against the plain version and the split twin within
    PAGED_F32_TOL of the largest magnitude, at G = 16 and 20, D = 32, 96 and
    256 and a tile that mixes page, dead and tail rows; two calls give the
    same bits, a 4-D q with Q = 1 the 3-D call's, a dead slot zeros; each
    call counts one K3-f32 launch."""
    _, b, h, kv, d, ps, tail_len, lengths, starts, maxp = case
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=d + h + 1, maxp=maxp,
        dtype=torch.float32)
    tail = dict(tail_k=tk, tail_v=tv, starts=st)
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kp, vp, table, lens, **tail) for _ in range(2)]
    o4 = tpa.paged_attention(q[:, None].contiguous(), kp, vp, table, lens, **tail)
    assert {n: getattr(tpa, n) for n in tpa._COUNTERS.values() if getattr(tpa, n)} == {
        "launches_tail_f32": 3}
    args = (q, kp, vp, table, lens, tk, tv, st)
    r, sp = tpa.paged_attention_plain(*args), tpa.paged_attention_split_plain(*args)
    torch.cuda.synchronize()
    o = runs[0]
    assert o.shape == q.shape and o.dtype == torch.float32
    assert torch.equal(runs[1], o) and torch.equal(o4[:, 0], o)
    _close(o, r, torch.float32)
    _close(o, sp, torch.float32)
    assert all(bool((o[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)


# K3-int8-f32-verify on the tensor-core kernel's row tiles: (label, b, nq, h,
# kv, d, ps, tail_len, lengths, starts, maxp), blocks of at most two row
# tiles. Path 11's spec tick (Q = 9, G = 4: 36 rows, three row tiles in two
# blocks, the second with one), path 16's 144 rows (G = 16: nine row tiles
# in five blocks), G = 20 at Q = 3 (60 rows, a partial row tile), D = 32 (G
# = 2: 18 rows), D = 96 (G = 4) and D = 256 (G = 8: 72 rows) at the spec
# tick's ragged
# state; page 16 with five pages a slot, so the axis's tail starts at 80 and
# the tile at 64 mixes page, dead and tail rows; and a tail whose split
# boundary (tail column 128) lies between query 0's limit (125) and query
# 8's (133), with a tail-only slot.
SPEC = chip_smoke.SPEC_MAIN
SPEC_STARTS, SPEC_LENGTHS = chip_smoke._spec_main_case()
INT8_F32_VERIFY_MMA_CASES = [
    ("spec tick", 8, 9, 32, 8, 128, 256, 54, SPEC_LENGTHS, SPEC_STARTS, 8),
    ("144 rows", 8, 9, 128, 8, 128, 256, 54, SPEC_LENGTHS, SPEC_STARTS, 8),
    ("G=20", 3, 3, 40, 2, 128, 16, 16, [257, 256, 140], [254, 250, 128], None),
    ("D=32", 8, 9, 8, 4, 32, 256, 54, SPEC_LENGTHS, SPEC_STARTS, 8),
    ("D=96", 8, 9, 32, 8, 96, 256, 54, SPEC_LENGTHS, SPEC_STARTS, 8),
    ("D=256", 8, 9, 8, 1, 256, 256, 54, SPEC_LENGTHS, SPEC_STARTS, 8),
    ("mixed tile", 5, 3, 16, 2, 64, 16, 100, [100, 80, 175, 3, 0], [80, 70, 80, 0, 0], 5),
    ("split-crossing tail", 3, 9, 32, 8, 128, 16, 200, [381, 60, 30], [256, 30, 0], 16),
]


@pytest.mark.torch_port
@pytest.mark.parametrize("case", INT8_F32_VERIFY_MMA_CASES,
                         ids=[c[0] for c in INT8_F32_VERIFY_MMA_CASES])
def test_paged_int8_f32_verify_tensor_core_kernel_matches_plain(no_tf32, case):
    """K3-int8-f32-verify (f32 q over int8 pools, Q > 1) on the tensor-core
    kernel with several m16 row tiles a block against the plain version's
    4-D branch and the split twin within PAGED_F32_TOL of the largest
    magnitude; two calls give the same bits, a 4-D q with Q = 1 the 3-D
    call's, a dead slot zeros; each verify call counts one
    K3-int8-f32-verify launch and nothing else."""
    _, b, nq, h, kv, d, ps, tail_len, lengths, starts, maxp = case
    q, kp, vp, table, lens, st, tk, tv = _paged_inputs(
        no_tf32, b, h, kv, d, ps, 128, tail_len, lengths, starts, seed=d + h + nq, nq=nq,
        maxp=maxp, dtype=torch.float32)
    kq, vq, ks, vs = _int8_pools(kp, vp)
    tail = dict(tail_k=tk, tail_v=tv, starts=st, k_scale=ks, v_scale=vs)
    tpa.reset_launches()
    runs = [tpa.paged_attention(q, kq, vq, table, lens, **tail) for _ in range(2)]
    assert {n: getattr(tpa, n) for n in tpa._COUNTERS.values() if getattr(tpa, n)} == {
        "launches_verify_int8_f32": 2}
    args = (q, kq, vq, table, lens, tk, tv, st, ks, vs)
    r, sp = tpa.paged_attention_plain(*args), tpa.paged_attention_split_plain(*args)
    o41 = tpa.paged_attention(q[:, :1].contiguous(), kq, vq, table, lens, **tail)
    o3 = tpa.paged_attention(q[:, 0].contiguous(), kq, vq, table, lens, **tail)
    torch.cuda.synchronize()
    o = runs[0]
    assert o.shape == q.shape and o.dtype == torch.float32
    assert torch.equal(runs[1], o) and torch.equal(o41[:, 0], o3)
    _close(o, r, torch.float32)
    _close(o, sp, torch.float32)
    assert all(bool((o[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)


# ---------------------------------------------------------------------------
# The float16 backward: K2a-f16, K2b-f16 (csrc/flash_bwd.cu), K5a-f16,
# K5b-f16 (csrc/mlp_bwd.cu) and K6-f16 (csrc/projection_bwd.cu), the bf16
# kernels' float16 instances
# ---------------------------------------------------------------------------

# (b, s_q, s_kv, h, kv, d, causal, seg): the llama3-8b training batch (packed
# rows) and one document per row, path 13's qwen2-0.5b heads (14/2, D = 64)
# on packed rows, D = 32, ragged S = 129 and 300 (ids up and down), causal
# Sq > Skv.
F16_BWD_CASES = [
    (4, 2048, 2048, 32, 8, 128, True, "train"),
    (2, 2048, 2048, 32, 8, 128, True, 0),
    (4, 2048, 2048, 14, 2, 64, True, "train"),
    (2, 300, 300, 8, 2, 32, True, "nonmono"),
    (1, 129, 129, 4, 1, 128, True, 0),
    (2, 300, 300, 14, 2, 64, True, "nonmono"),
    (2, 333, 200, 8, 2, 128, True, 0),
    (1, 2048, 2048, 8, 1, 256, True, 4),  # a training row of path 15
    (2, 300, 300, 4, 2, 256, True, "nonmono"),
]


@pytest.mark.torch_port
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d,causal,seg", F16_BWD_CASES)
def test_flash_f16_bwd_kernels_match_plain(cuda, b, s_q, s_kv, h, kv, d, causal, seg):
    """K2a-f16 and K2b-f16 against the plain backward in float16: each
    gradient within BWD_TOL of its largest magnitude (the kernels round p
    and ds to float16 for the second products, which the plain version
    keeps in f32, as the reference does), one launch of each, no bf16 or f32
    backward launch."""
    ids = _bwd_segments(cuda, seg, b, s_q)
    q, k, v, o, lse, do = _bwd_inputs(cuda, b, s_q, s_kv, h, kv, d, causal, ids,
                                      dtype=torch.float16)
    tfa.reset_launches()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, segment_ids=ids)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         segment_ids=ids)
    torch.cuda.synchronize()
    assert (tfa.launches_dq_f16, tfa.launches_dkv_f16, tfa.launches_dq, tfa.launches_dkv,
            tfa.launches_dq_f32, tfa.launches_dkv_f32) == (1, 1, 0, 0, 0, 0)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == ref.shape and x.dtype == torch.float16
        assert bool(torch.isfinite(x.float()).all()), name
        scale = float(ref.float().abs().max())
        torch.testing.assert_close(x.float(), ref.float(), rtol=0, atol=BWD_TOL * scale,
                                   msg=name)


@pytest.mark.torch_port
@pytest.mark.parametrize("do_scale", [2.0**-21, 2.0**-14, 2.0**6])
def test_flash_f16_bwd_holds_training_scale_gradients(cuda, do_scale):
    """A float16 training step's output gradients lie among float16's
    subnormals (2^-21: path 13's flash backward); the wrapper rescales do by
    an exact power of two around K2a-f16 and K2b-f16, so the kernels' float16
    rounding of dS loses nothing the plain backward (dS in f32, as the
    reference) keeps: each gradient within BWD_TOL of its largest magnitude
    at every scale, plus two float16 subnormal steps (2^-24 each: the
    rescaled output's rounding, then the unscaled one's) where the outputs
    are subnormal, and finite at a large scale."""
    ids = _bwd_segments(cuda, "train", 4, 2048)
    q, k, v, o, lse, do = _bwd_inputs(cuda, 4, 2048, 2048, 14, 2, 64, True, ids,
                                      dtype=torch.float16)
    do = (do.float() * do_scale).half()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, segment_ids=ids)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, segment_ids=ids)
    torch.cuda.synchronize()
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(x.float()).all()), name
        scale = float(ref.float().abs().max())
        torch.testing.assert_close(x.float(), ref.float(), rtol=0,
                                   atol=BWD_TOL * scale + 2.0**-23, msg=name)


@pytest.mark.torch_port
@pytest.mark.parametrize("seg", ["train", None])
def test_flash_f16_bwd_kernels_are_bitwise_repeatable(cuda, seg):
    """K2a-f16 and K2b-f16 keep the bf16 kernels' ownership (no atomics), so
    two calls give the same bits."""
    ids = _bwd_segments(cuda, seg, 4, 2048) if seg else None
    q, k, v, o, lse, do = _bwd_inputs(cuda, 4, 2048, 2048, 32, 8, 128, True, ids,
                                      dtype=torch.float16)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, segment_ids=ids)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, segment_ids=ids)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.torch_port
def test_flash_attention_f16_autograd_launches_k1_k2(cuda):
    """One float16 forward and backward through ``flash_attention``: one
    K1-f16, one K2a-f16, one K2b-f16 (no other flash kernel), and the
    gradients of the plain attention's autograd."""
    q, k, v, _ = _inputs(cuda, 2, 256, 256, 8, 2, 64, dtype=torch.float16)
    seg = _packed_segments(cuda, 2, 256, 2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention(*leaves, causal=True, segment_ids=seg)
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    torch.cuda.synchronize()
    assert (tfa.launches_f16, tfa.launches_dq_f16, tfa.launches_dkv_f16) == (1, 1, 1)
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv, tfa.launches_f32) == (0,) * 4
    ref_leaves = [t.clone().float().requires_grad_() for t in (q, k, v)]
    ref_out, _ = tfa.flash_attention_plain(*ref_leaves, causal=True, segment_ids=seg)
    ref = torch.autograd.grad(ref_out.square().sum(), ref_leaves)
    for name, x, r in zip(("dq", "dk", "dv"), grads, ref):
        scale = float(r.abs().max())
        torch.testing.assert_close(x.float(), r, rtol=0, atol=3 * BWD_TOL * scale, msg=name)


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f", [(8192, 896, 4864), (2064, 384, 384), (16, 256, 128),
                                   (1024, 512, 768)])
def test_mlp_bwd_f16_kernels_match_plain(cuda, n, d, f):
    """K5a-f16 and K5b-f16 against their plain versions in float16, within
    MM_TOL of each output's largest magnitude: path 13's widths (D = 896 and
    F = 4864 overhang the 256-wide tiles), a ragged token edge, the least N;
    the SwiGLU epilogue reads float16 gate and up (not bf16 bit shifts)."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    h, w_gu, w_down, g, gate, up = _mlp_inputs(cuda, n, d, f, seed=50, dtype=torch.float16)
    tmb.reset_launches()
    dgu, d_w_down = tmb.dgu_dwdown(g, w_down, gate, up)
    dgu_ref, d_w_down_ref = tmb.dgu_dwdown_plain(g, w_down, gate, up)
    dh, d_w_gu = tmb.dh_dwgu(h, dgu, w_gu)
    dh_ref, d_w_gu_ref = tmb.dh_dwgu_plain(h, dgu, w_gu)
    torch.cuda.synchronize()
    assert (tmb.launches_dgu_f16, tmb.launches_dh_f16, tmb.launches_dgu,
            tmb.launches_dh) == (1, 1, 0, 0)
    for name, x, r in (("dgu", dgu, dgu_ref), ("d_w_down", d_w_down, d_w_down_ref),
                       ("dh", dh, dh_ref), ("d_w_gu", d_w_gu, d_w_gu_ref)):
        _assert_scaled(name, x, r)


@pytest.mark.torch_port
@pytest.mark.parametrize("n,d,f,ld", [(8192, 896, 896, 0), (8192, 896, 128, 0),
                                      (2064, 256, 384, 512)],
                         ids=["wq/wo", "wk/wv", "strided g"])
def test_proj_bwd_f16_kernel_matches_plain(cuda, n, d, f, ld):
    """K6-f16 against its plain version in float16 at path 13's projections
    (qwen2-0.5b's 896 x 896 and 896 x 128, which the 256-wide tiles
    overhang) and a strided gradient, within MM_TOL; both tile orders give
    the same bits."""
    from ditl_tpu_torch.ops import projection as tpr

    x = _rnd(cuda, 1, n, d, seed=60, dtype=torch.float16)
    w = _rnd(cuda, d, f, seed=61, scale=d**-0.5, dtype=torch.float16)
    g = _rnd(cuda, 1, n, ld or f, seed=62, dtype=torch.float16)[..., :f]
    tpr.reset_launches()
    runs = [tpr.projection_bwd(x, w, g, blocks=(16, 128), dx_first=order)
            for order in (None, True, False)]
    dx_ref, dw_ref = tpr.projection_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    assert (tpr.launches_f16, tpr.launches) == (3, 0)
    for run in runs[1:]:
        assert torch.equal(run[0], runs[0][0]) and torch.equal(run[1], runs[0][1])
    _assert_scaled("dx", runs[0][0], dx_ref)
    _assert_scaled("dw", runs[0][1], dw_ref)


@pytest.mark.torch_port
def test_mlp_bwd_f16_kernels_are_bitwise_repeatable(cuda):
    """Three calls of K5a-f16 and K5b-f16 give the same bits."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb

    h, w_gu, w_down, g, gate, up = _mlp_inputs(cuda, 4096, 1024, 2816, seed=70,
                                               dtype=torch.float16)
    runs = []
    for _ in range(3):
        dgu, d_w_down = tmb.dgu_dwdown(g, w_down, gate, up)
        runs.append((dgu, d_w_down, *tmb.dh_dwgu(h, dgu, w_gu)))
    torch.cuda.synchronize()
    for run in runs[1:]:
        for name, x, r in zip(("dgu", "d_w_down", "dh", "d_w_gu"), run, runs[0]):
            assert torch.equal(x, r), name


@pytest.mark.torch_port
def test_mlp_and_projection_f16_autograd_launch_k5_k6(cuda):
    """One float16 forward and backward through ``mlp_gu`` and
    ``projection`` with ``"pallas"``: one K5a-f16, one K5b-f16 and one
    K6-f16, and the gradients of the einsum spelling."""
    from ditl_tpu_torch.ops import mlp_bwd as tmb
    from ditl_tpu_torch.ops import projection as tpr
    from ditl_tpu_torch.ops.mlp import mlp_gu

    f16 = torch.float16
    h = _rnd(cuda, 2, 256, 256, seed=80, dtype=f16)
    w_gu = _rnd(cuda, 256, 512, seed=81, scale=1 / 16, dtype=f16)
    w_down = _rnd(cuda, 256, 256, seed=82, scale=1 / 16, dtype=f16)
    w = _rnd(cuda, 256, 256, seed=83, scale=1 / 16, dtype=f16)
    grads = {}
    for impl in ("pallas", "xla"):
        leaves = [t.clone().requires_grad_() for t in (h, w_gu, w_down, w)]
        tmb.reset_launches()
        tpr.reset_launches()
        out = mlp_gu(*leaves[:3], impl, (64, 128, 128))
        out = tpr.projection(out, leaves[3], bwd_impl=impl, blocks=(64, 128))
        grads[impl] = torch.autograd.grad(out.float().square().sum(), leaves)
        torch.cuda.synchronize()
        want = (1, 1, 1) if impl == "pallas" else (0, 0, 0)
        assert (tmb.launches_dgu_f16, tmb.launches_dh_f16, tpr.launches_f16) == want
    for name, x, r in zip(("h", "w_gu", "w_down", "w"), grads["pallas"], grads["xla"]):
        scale = float(r.float().abs().max())
        torch.testing.assert_close(x.float(), r.float(), rtol=0, atol=3 * MM_TOL * scale,
                                   msg=name)


@pytest.mark.torch_port
def test_k2_kernels_keep_the_bits_of_their_bf16_build(cuda):
    """The bf16 K2a and K2b on fixed integer-made inputs give the bytes the
    kernels built before their element type became a template parameter
    gave (``chip_smoke.K2_DIGESTS``)."""
    assert chip_smoke._k2_digests(tfa) == chip_smoke.K2_DIGESTS


@pytest.mark.torch_port
def test_tiny_llama_f32_train_step_with_flash_follows_the_reference(cuda):
    """tiny-llama (head_dim 32) in f32 with ``attention_impl=flash``: the
    reference's dispatch sends D = 32 to plain attention, so one train step
    on the card is finite and launches no flash kernel of any dtype (there
    is no f32 kernel at D = 32, which the step reached, and raised on,
    before the port followed the reference's dispatch)."""
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.train.trainer import train

    config, device = build_config([
        "--preset", "tiny-llama", "model.dtype=float32", "model.param_dtype=float32",
        "model.attention_impl=flash", "data.synthetic=true", "data.batch_size=2",
        "data.seq_len=256", "train.total_steps=1", "train.log_every=1"])
    assert (config.model.head_dim, device) == (32, "cuda")
    tfa.reset_launches()
    summary = train(config, device=device)
    counts = [getattr(tfa, c) for _, _, c in tfa._ENTRIES.values()]
    assert summary["steps"] == 1 and all(torch.isfinite(torch.tensor(summary["losses"])))
    assert counts == [0] * len(counts), counts


# Any group count, verify-row count and head dim up to 256 that is a multiple
# of 16: every paged entry point (chip_smoke.HD_PAGED: K3, K4, K3-verify and
# their int8 forms in bf16, float16 and f32) on chip_smoke.py's shape cases,
# the decode and spec ticks of paths 16 (G = 16: 16 single-query rows, a
# 144-row verify in two row groups) and 17 (D = 96 on the 128 instance),
# G = 12 at D = 80 (108 rows) and D = 16 at G = 16.
SHAPE_ENTRIES = [(entry, i) for entry in chip_smoke.HD_PAGED
                 for i in range(len(chip_smoke.SHAPE_PAGED_CASES))]


@pytest.mark.torch_port
@pytest.mark.parametrize("entry,case", SHAPE_ENTRIES,
                         ids=[f"{e[0]}-{i}" for e, i in SHAPE_ENTRIES])
def test_paged_kernels_at_any_groups_rows_and_head_dim(no_tf32, entry, case):
    """Each entry point against the plain version and the split twin (bf16
    and float16 at 2e-2, f32 within ``F32_PAGED_TOL`` of the largest
    magnitude: ``chip_smoke._close``); two calls the same bits; each call
    counts one launch of its own kernel and none of another; a dead slot
    gives zeros."""
    name, dtype_name, int8, form = entry
    dtype = getattr(torch, dtype_name)
    cases = chip_smoke.SHAPE_VERIFY_CASES if form == "verify" else chip_smoke.SHAPE_PAGED_CASES
    args, kw, plain_args, lens = chip_smoke._paged_case_inputs(cases[case], form, dtype, int8,
                                                               seed=2500 + case)
    tpa.reset_launches()
    o, o2 = (tpa.paged_attention(*args, **kw) for _ in range(2))
    r = tpa.paged_attention_plain(*plain_args)
    s_ = tpa.paged_attention_split_plain(*plain_args)
    torch.cuda.synchronize()
    counter = chip_smoke._counter(name)
    assert getattr(tpa, counter) == 2
    assert sum(getattr(tpa, c) for c in tpa._COUNTERS.values()) == 2
    assert o.dtype == dtype and o.shape == args[0].shape and torch.equal(o, o2)
    chip_smoke._close(name, dtype, o, r)
    chip_smoke._close(name, dtype, o, s_)
    assert all(bool((o[j] == 0).all()) for j, n in enumerate(lens) if n == 0)


# Draft-model speculation and chunked prefill at tiny width on the card: the
# continuous engine's verify goes through K3-verify and its decode steps
# through K3, every cold prefill and first chunk through K1 (D = 64, buckets
# of 256 and 512 tokens, where ``supports`` holds), counted launch by launch.
TINY_CARD = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=1024,
                 attention_impl="flash")
DRAFT_CARD = dict(TINY_CARD, hidden_size=128, intermediate_size=256, num_layers=1,
                  num_heads=2, num_kv_heads=1)
CARD_PROMPTS = [[1] + [3 + (7 * i + j) % 200 for j in range(n)]
                for i, n in enumerate([600, 300, 40])]


def _card_engine(dtype: str, **kw):
    from ditl_tpu_torch.config import ModelConfig
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer
    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.models import llama

    cfg = ModelConfig(**TINY_CARD, dtype=dtype)
    if kw.pop("drafter", False):
        dcfg = ModelConfig(**DRAFT_CARD, dtype=dtype)
        kw.update(speculative=True, draft_params=llama.init_params(dcfg, seed=5, device="cuda"),
                  draft_cfg=dcfg)
    return ContinuousEngine(llama.init_params(cfg, seed=4, device="cuda"), cfg,
                            ByteTokenizer(), n_slots=2, decode_chunk=8, cache_mode="paged",
                            page_size=256, device="cuda", **kw)


def _card_run(eng, max_new: int = 24):
    rids = [eng.submit(p, max_new_tokens=max_new, temperature=0.0) for p in CARD_PROMPTS]
    seen = 0
    while eng.pending:
        eng.step()
        seen = max(seen, eng.stats()["slots_prefilling"])
    out = {rid: req.tokens for rid, req in eng._completed.items()}
    eng._completed.clear()
    return [out[r] for r in rids], seen


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_draft_model_speculation_runs_k3_verify_on_the_card(no_tf32, dtype):
    """A one-layer drafter: every verify round of every layer launches
    K3-verify once, the single-query K3 never; the drafter takes k + 1
    steps a round; K1 runs each cold prefill. f32: the greedy tokens are
    the plain engine's on the card."""
    sfx = "_f32" if dtype == "float32" else ""
    eng = _card_engine(dtype, drafter=True, spec_k=4, spec_rounds=2)
    tfa.reset_launches()
    tpa.reset_launches()
    toks, _ = _card_run(eng)
    torch.cuda.synchronize()
    st = eng.stats()
    spec = st["speculative"]
    assert spec["drafter"] == "model" and spec["spec_ticks"] == spec["ticks"] > 0
    assert getattr(tpa, "launches_verify" + sfx) == 2 * spec["verify_rounds"] > 0
    assert getattr(tpa, "launches_tail" + sfx) == 0
    assert spec["draft_steps"] == 5 * spec["verify_rounds"]
    # the drafter's one layer runs K1 on each draft prefill that tiles
    buckets = [min(1 << (len(p) - 1).bit_length(), eng.smax) for p in CARD_PROMPTS]
    draft_k1 = sum(tfa.supports(b, b, 64) for b in buckets)
    assert getattr(tfa, "launches" + sfx) == 2 * st["prefills_cold"] + draft_k1 > 0
    assert all(len(t) == 24 for t in toks)
    if dtype == "float32":
        assert toks == _card_run(_card_engine(dtype))[0]


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunked_prefill_under_a_budget_on_the_card(no_tf32, dtype):
    """``prefill_chunk=256, token_budget=2 x 8 + 256``: the 601-token prompt
    prefills in three chunks, the 301-token one in two; K1 runs each first
    chunk and cold prefill, K3 every decode step; a slot is seen
    prefilling; no tick spends more than max(256, budget - decode_ready x
    8). f32: the unchunked engine's greedy tokens."""
    sfx = "_f32" if dtype == "float32" else ""
    eng = _card_engine(dtype, prefill_chunk=256, token_budget=2 * 8 + 256)
    tfa.reset_launches()
    tpa.reset_launches()
    toks, seen = _card_run(eng)
    torch.cuda.synchronize()
    st = eng.stats()
    assert seen > 0 and st["slots_prefilling"] == 0
    assert st["prefills_cold"] == 3 and st["prefills_prefix_hit"] == 3  # 2 + 1 later chunks
    assert getattr(tfa, "launches" + sfx) == 2 * st["prefills_cold"]
    assert getattr(tpa, "launches_tail" + sfx) == 2 * st["decode_steps"] > 0
    assert 0 < st["max_tick_prefill_tokens"] <= 256 + 16
    assert all(len(t) == 24 for t in toks)
    if dtype == "float32":
        assert toks == _card_run(_card_engine(dtype))[0]


# Optimistic admission, logprobs and deadlines at tiny width on the card. Two
# 500-token prompts with 300-token budgets: 4 pages each at worst, 2 with one
# tick of headroom, so 4 usable pages hold both only optimistically; after
# their first tick both need a third page and the younger is preempted,
# then resumed once the older finishes.
RESUME_PROMPTS = [[1] + [3 + (11 * i + j) % 200 for j in range(499)] for i in range(2)]


def _resume_runs(dtype: str, **submit_kw):
    """(uncontended, contended) requests of ``RESUME_PROMPTS``, and the
    contended engine, its K3 launches counted over the run."""
    runs = []
    for kw in (dict(n_pages=9), dict(n_pages=5, admission="optimistic")):
        eng = _card_engine(dtype, **kw)
        # Zero the head's pad and EOS columns: a greedy request then never
        # ends early (its logit 0 against the largest of 510 others), so the
        # pool's pressure does not depend on the weights the card draws.
        tok = eng.tokenizer
        eng.params["lm_head"]["kernel"][:, [tok.pad_id, tok.eos_id]] = 0
        tpa.reset_launches()
        rids = [eng.submit(p, max_new_tokens=300, **submit_kw) for p in RESUME_PROMPTS]
        done = {}
        while eng.pending:
            eng.step()
            done.update({r.req_id: r for r in eng.take_finished()})
        torch.cuda.synchronize()
        runs.append([done[r] for r in rids])
    return runs[0], runs[1], eng


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preemption_and_exact_resume_on_the_card(no_tf32, dtype):
    """The younger request is preempted and resumed; K3 runs every decode
    step, the ticks after the resume included. f32: greedy and sampled
    tokens identical to the uncontended run (the sampled leg takes the first
    seed whose requests outlive their first tick, so that one is
    preempted). bf16: greedy tokens identical, or diverging first at a
    near-tie of the uncontended run's logits (``chip_smoke.SPEC_TIE_TOL``;
    the resume's re-prefill rounds its K/V in bf16 apart from the decode
    steps that first wrote them)."""
    from ditl_tpu_torch.infer.engine import Generator

    sfx = "_f32" if dtype == "float32" else ""
    ref, got, eng = _resume_runs(dtype, temperature=0.0)
    st = eng.stats()
    assert eng.preemptions >= 1 and st["resume_prefill_tokens"] > 0
    assert sum(r.preempt_count for r in got) == eng.preemptions
    assert getattr(tpa, "launches_tail" + sfx) == 2 * st["decode_steps"] > 0
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]
    if dtype == "float32":
        assert [r.tokens for r in got] == [r.tokens for r in ref]
        for seed in range(3, 13):
            ref_s, got_s, eng_s = _resume_runs(dtype, temperature=0.9, top_p=0.95, seed=seed)
            if eng_s.preemptions:
                break
        assert eng_s.preemptions >= 1
        assert [r.tokens for r in got_s] == [r.tokens for r in ref_s]
        return
    gen = Generator(eng.params, eng.cfg, eng.tokenizer, device="cuda")
    for p, r, g in zip(RESUME_PROMPTS, ref, got):
        chip_smoke._tie_check(gen, eng.cfg, p, g.tokens, r.tokens)


@pytest.mark.torch_port
@pytest.mark.parametrize("spec", [False, True])
def test_logprobs_on_plain_and_spec_ticks_on_the_card(no_tf32, spec):
    """f32 logprobs of the continuous engine's plain ticks and lookup
    speculative rounds against the lock-step Generator's on the card:
    identical greedy tokens and top ids, logprobs within 1e-4."""
    from ditl_tpu_torch.infer.engine import GenerateConfig, Generator

    kw = dict(speculative=True, spec_k=4, spec_threshold=0.0) if spec else {}
    eng = _card_engine("float32", logprobs_k=3, **kw)
    gen = Generator(eng.params, eng.cfg, eng.tokenizer, device="cuda")
    for p in CARD_PROMPTS[1:]:
        rid = eng.submit(p, max_new_tokens=24, temperature=0.0, logprobs=3)
        while eng.pending:
            eng.step()
        req = eng._completed.pop(rid)
        outs, lps = gen.generate_tokens_with_logprobs(
            [p], GenerateConfig(max_new_tokens=24, logprobs=3))
        assert req.tokens == outs[0] and req.lp_top_ids == lps[0]["top_ids"]
        torch.testing.assert_close(torch.tensor(req.lp_token),
                                   torch.tensor(lps[0]["token_logprobs"]), atol=1e-4, rtol=0)
    if spec:
        assert eng.stats()["speculative"]["spec_ticks"] > 0


@pytest.mark.torch_port
def test_deadline_eviction_frees_pages_on_the_card(no_tf32):
    """A decoding request past its deadline is evicted at the next step:
    its tokens so far kept, every page back to free or cached."""
    eng = _card_engine("bfloat16")
    rid = eng.submit(CARD_PROMPTS[0], max_new_tokens=200, temperature=0.0, deadline_s=600.0)
    eng.step()
    eng.step()
    req = next(r for r in eng._slots if r is not None)
    assert req.req_id == rid and len(req.tokens) == 16
    req.deadline = 0.0
    eng.step()
    done = eng._completed.pop(rid)
    st = eng.stats()
    assert done.expired and len(done.tokens) == 16 and int(eng.metrics.deadline_expired.value) == 1
    assert not eng.pending
    assert st["pages_free"] + st["pages_cached_evictable"] == st["pages_total"]


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guided_decoding_on_the_card(no_tf32, dtype):
    """Grammar-constrained decoding at tiny width on the card: the two
    unconstrained requests give the guided-off engine's tokens bit for bit
    while a guided one shares their ticks; the guided completion walks its
    grammar's byte DFA (a full match when it ended at EOS); K3 runs every
    decode step and K1 every cold prefill; f32: prompt-lookup speculative
    guided ticks give the plain guided tokens (K3-verify every round)."""
    from ditl_tpu_torch.infer import grammar as G

    sfx = "_f32" if dtype == "float32" else ""
    eng = _card_engine(dtype, fsm_capacity=256)
    tok = eng.tokenizer
    g = G.compile_regex(r"[a-z ]{4,40}\.", tok)
    reqs = [(p, {"grammar": g if i == 1 else None}) for i, p in enumerate(CARD_PROMPTS)]

    def run(engine, requests):
        tfa.reset_launches()
        tpa.reset_launches()
        rids = [engine.submit(p, max_new_tokens=32, temperature=0.0, **kw) for p, kw in requests]
        done = {}
        while engine.pending:
            engine.step()
            done.update({r.req_id: r for r in engine.take_finished()})
        torch.cuda.synchronize()
        return [done[r].tokens for r in rids]

    got = run(eng, reqs)
    st = eng.stats()
    assert getattr(tpa, "launches_tail" + sfx) == 2 * st["decode_steps"] > 0
    assert getattr(tfa, "launches" + sfx) == 2 * st["prefills_cold"] > 0
    assert st["guided"]["grammars_registered"] == 1
    off = run(_card_engine(dtype), [(p, {}) for p, _ in reqs])
    assert [got[0], got[2]] == [off[0], off[2]]
    text = tok.decode(got[1])
    s = 0
    for b in text.encode():
        s = int(g.byte_next[s, b])
        assert s >= 0, text
    assert g.accept[s] or len(got[1]) == 32, text
    if dtype == "float32":
        spec = _card_engine(dtype, fsm_capacity=256, speculative=True, spec_k=4,
                            spec_threshold=0.0)
        assert run(spec, reqs) == got
        assert tpa.launches_verify_f32 == 2 * spec.stats()["speculative"]["verify_rounds"] > 0


@pytest.mark.torch_port
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_contiguous_cache_runs_k1_on_cold_prefills_only(no_tf32, dtype):
    """The contiguous cache (the engine's default): K1 runs every cold
    prefill whose bucket tiles (the 601- and 301-token prompts; the 41-token
    one's bucket of 64 takes plain attention), no paged kernel ever; a
    registered prefix's hit launches no K1 and, in f32, gives the cold
    tokens, which are also the paged engine's."""
    from ditl_tpu_torch.config import ModelConfig
    from ditl_tpu_torch.data.tokenizer import ByteTokenizer
    from ditl_tpu_torch.infer.continuous import ContinuousEngine
    from ditl_tpu_torch.models import llama

    sfx = "_f32" if dtype == "float32" else ""
    cfg = ModelConfig(**TINY_CARD, dtype=dtype)
    params = llama.init_params(cfg, seed=4, device="cuda")
    eng = ContinuousEngine(params, cfg, ByteTokenizer(), n_slots=2, decode_chunk=8,
                           device="cuda")
    assert eng.cache_mode == "contiguous"
    tfa.reset_launches()
    tpa.reset_launches()
    toks, _ = _card_run(eng)
    torch.cuda.synchronize()
    st = eng.stats()
    assert st["prefills_cold"] == 3 and getattr(tfa, "launches" + sfx) == 2 * 2
    assert sum(getattr(tpa, c) for c in tpa._COUNTERS.values()) == 0
    assert all(len(t) == 24 for t in toks)
    eng.register_prefix(CARD_PROMPTS[0][:500])
    tfa.reset_launches()
    hit, _ = _card_run(eng)
    torch.cuda.synchronize()
    assert eng.stats()["prefix_cache"]["hit_tokens"] == 500
    assert getattr(tfa, "launches" + sfx) == 2 * 1  # the 301-token prompt's cold prefill
    if dtype == "float32":
        assert hit == toks == _card_run(_card_engine(dtype))[0]
