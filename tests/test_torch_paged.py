"""Port parity for the paged KV cache.

- Kernel level: the port's ``paged_attention_plain`` and its CPU wrapper
  ``paged_attention`` against the JAX package's gather reference
  ``paged_attention_xla`` and its Pallas kernels (``_paged_tail_kernel``
  with a tail, ``_paged_kernel`` without) in interpret mode, on the same
  numpy inputs. f32 at atol 2e-5, the reference's own tolerance
  (``tests/test_paged.py``). Over int8 pools with scales (the reference's
  ``test_paged_int8_kernel_matches_reference`` shapes): the plain version's
  int8 branch and the CPU wrapper against the Pallas kernel's quantized
  branch in interpret mode and the gather reference in f32 at 2e-5, and in
  bf16 (q and tails) against the gather reference at 2e-2, because that
  reference rounds the dequantized keys and values to bf16 and the kernel's
  arithmetic keeps the exact int8 values and f32 scales.
- Allocator: one seeded operation sequence on both ``PageAllocator``s gives
  the same pages, refcounts, matches, evictions and ``n_evictable``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.infer import paged_cache as jpc  # noqa: E402
from ditl_tpu.ops import paged_attention as jpa  # noqa: E402
from ditl_tpu_torch.infer import paged_cache as tpc  # noqa: E402
from ditl_tpu_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

ATOL = 2e-5

# (lengths, starts or None for no tail, rows 1 and 2 share their first page)
CASES = {
    # K4: dead slot, partial page, exact page boundary, many pages
    "no_tail": ([0, 7, 16, 90], None, False),
    # K4 with two rows whose tables share a physical page
    "no_tail_shared": ([3, 20, 33, 90], None, True),
    # K3: dead slot, tail only, page-aligned start + tail, mid-page start + tail
    "tail": ([0, 5, 38, 50], [0, 0, 32, 45], False),
    # K3: starts == lengths (no live tail) on rows 2 and 3, a shared page
    "tail_shared_starts_eq_lengths": ([25, 40, 33, 90], [20, 33, 33, 90], True),
}


@functools.lru_cache(maxsize=None)
def _case(name: str, groups: int):
    lengths, starts, shared = CASES[name]
    rng = np.random.default_rng(groups)
    kv, d, ps, maxp, pool, tail = 4, 64, 16, 6, 32, 8
    b, h = len(lengths), kv * groups
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(pool, kv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(pool, kv, ps, d)).astype(np.float32)
    tk = rng.normal(size=(b, kv, tail, d)).astype(np.float32)
    tv = rng.normal(size=(b, kv, tail, d)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    resident = lengths if starts is None else np.minimum(starts, lengths)
    table = np.zeros((b, maxp), np.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-int(resident[row]) // ps)):
            table[row, i] = pid
            pid += 1
    if shared:
        table[2, 0] = table[1, 0]
    arrays = {"q": q, "k_pages": kp, "v_pages": vp, "page_table": table,
              "lengths": lengths}
    if starts is not None:
        arrays.update(tail_k=tk, tail_v=tv, starts=np.asarray(starts, np.int32))
    return arrays


@functools.lru_cache(maxsize=None)
def _jax_out(name: str, groups: int, impl: str) -> np.ndarray:
    a = {k: jnp.asarray(v) for k, v in _case(name, groups).items()}
    pos = [a.pop(k) for k in ("q", "k_pages", "v_pages", "page_table", "lengths")]
    if impl == "xla":
        return np.asarray(jpa.paged_attention_xla(*pos, **a))
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True))


def _torch_args(name: str, groups: int):
    a = {k: torch.from_numpy(v) for k, v in _case(name, groups).items()}
    pos = [a.pop(k) for k in ("q", "k_pages", "v_pages", "page_table", "lengths")]
    return pos, a


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("groups", [1, 4])
def test_plain_matches_jax_xla_reference(name, groups):
    pos, kw = _torch_args(name, groups)
    out = tpa.paged_attention_plain(*pos, **kw)
    np.testing.assert_allclose(out.numpy(), _jax_out(name, groups, "xla"), atol=ATOL)
    dead = np.flatnonzero(_case(name, groups)["lengths"] == 0)
    assert np.all(out.numpy()[dead] == 0), "a dead slot must give zeros"


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("groups", [1, 4])
def test_cpu_wrapper_matches_jax_pallas_interpret(name, groups):
    """On CPU tensors the wrapper runs the plain version, never a kernel; it
    agrees with the Pallas kernel the JAX package runs for the same call
    (K3 with a tail, K4 without)."""
    pos, kw = _torch_args(name, groups)
    tpa.reset_launches()
    out = tpa.paged_attention(*pos, **kw)
    assert (tpa.launches, tpa.launches_tail) == (0, 0)
    np.testing.assert_allclose(out.numpy(), _jax_out(name, groups, "pallas"), atol=ATOL)


def test_wrapper_raises_for_unported_variants():
    pos, kw = _torch_args("tail", 4)
    scale = torch.ones((32, 4, 1, 16))
    with pytest.raises(ValueError, match="tail path"):  # scales without a tail
        tpa.paged_attention(*pos[:3], pos[3], pos[4], k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="int8 pools"):  # scales with float pools
        tpa.paged_attention(*pos, **kw, k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="multi-query"):  # 4-D q without a tail
        tpa.paged_attention(pos[0][:, None], *pos[1:])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpa.paged_attention(*pos, **kw, mesh=object())
    with pytest.raises(ValueError, match="go together"):
        tpa.paged_attention(*pos, tail_k=kw["tail_k"])


# -- int8 pools -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _int8_case():
    """The reference's ``test_paged_int8_kernel_matches_reference`` inputs:
    int8 pools quantized per position with f32 scales, f32 q and tails; a
    dead slot, a tail-only slot, page-aligned and mid-page starts."""
    rng = np.random.default_rng(5)
    kv_heads, d, ps, maxp, pool, tail = 4, 64, 16, 6, 32, 8
    b, h = 4, 8
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kf = rng.normal(size=(pool, kv_heads, ps, d))
    vf = rng.normal(size=(pool, kv_heads, ps, d))
    ks = np.abs(kf).max(-1) / 127.0
    vs = np.abs(vf).max(-1) / 127.0
    ks[ks == 0] = 1.0
    vs[vs == 0] = 1.0
    ki = np.clip(np.round(kf / ks[..., None]), -127, 127).astype(np.int8)
    vi = np.clip(np.round(vf / vs[..., None]), -127, 127).astype(np.int8)
    starts = np.asarray([0, 0, 32, 45], np.int32)
    lengths = np.asarray([0, 5, 38, 50], np.int32)
    table = np.zeros((b, maxp), np.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-int(starts[row]) // ps)):
            table[row, i] = pid
            pid += 1
    return {"q": q, "k_pages": ki, "v_pages": vi, "page_table": table, "lengths": lengths,
            "tail_k": rng.normal(size=(b, kv_heads, tail, d)).astype(np.float32),
            "tail_v": rng.normal(size=(b, kv_heads, tail, d)).astype(np.float32),
            "starts": starts,
            "k_scale": ks[:, :, None, :].astype(np.float32),
            "v_scale": vs[:, :, None, :].astype(np.float32)}


POSITIONAL = ("q", "k_pages", "v_pages", "page_table", "lengths")


@functools.lru_cache(maxsize=None)
def _jax_int8(impl: str, bf16: bool = False) -> np.ndarray:
    a = {k: jnp.asarray(v) for k, v in _int8_case().items()}
    if bf16:
        a.update({k: a[k].astype(jnp.bfloat16) for k in ("q", "tail_k", "tail_v")})
    pos = [a.pop(k) for k in POSITIONAL]
    if impl == "xla":
        return np.asarray(jpa.paged_attention_xla(*pos, **a).astype(jnp.float32))
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True))


def _torch_int8(bf16: bool = False):
    a = {k: torch.from_numpy(v) for k, v in _int8_case().items()}
    if bf16:
        a.update({k: a[k].to(torch.bfloat16) for k in ("q", "tail_k", "tail_v")})
    return [a.pop(k) for k in POSITIONAL], a


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_int8_plain_matches_jax(impl):
    """The plain version's int8 branch (K's scale on the f32 scores, p times
    V's scale in f32 for the page columns, l adding the unscaled p) against
    the Pallas kernel's quantized branch in interpret mode and against the
    dequantizing gather reference, f32 at 2e-5."""
    pos, kw = _torch_int8()
    out = tpa.paged_attention_plain(*pos, **kw).numpy()
    np.testing.assert_allclose(out, _jax_int8(impl), atol=ATOL)
    assert np.all(out[0] == 0), "a dead slot must give zeros"


def test_int8_cpu_wrapper_matches_jax_pallas_interpret():
    pos, kw = _torch_int8()
    tpa.reset_launches()
    out = tpa.paged_attention(*pos, **kw)
    assert (tpa.launches, tpa.launches_tail, tpa.launches_tail_int8) == (0, 0, 0)
    np.testing.assert_allclose(out.numpy(), _jax_int8("pallas"), atol=ATOL)


def test_int8_bf16_plain_matches_jax_xla_reference():
    """bf16 q and tails: the gather reference dequantizes the pages to bf16
    before the products, the plain version keeps exact int8 values and f32
    scales, so they agree to bf16 tolerance (2e-2)."""
    pos, kw = _torch_int8(bf16=True)
    out = tpa.paged_attention(*pos, **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _jax_int8("xla", bf16=True), atol=2e-2,
                               rtol=2e-2)


def test_int8_wrapper_validates_its_inputs():
    """Each fault raises ValueError: int8 pools without scales, one scale
    alone, scales of the wrong dtype, shape or layout."""
    pos, kw = _torch_int8()
    ks, vs = kw.pop("k_scale"), kw.pop("v_scale")
    with pytest.raises(ValueError, match="their scales"):
        tpa.paged_attention(*pos, **kw)
    with pytest.raises(ValueError, match="go together"):
        tpa.paged_attention(*pos, **kw, k_scale=ks)
    with pytest.raises(ValueError, match="float32"):
        tpa.paged_attention(*pos, **kw, k_scale=ks.double(), v_scale=vs)
    with pytest.raises(ValueError, match="shape"):
        tpa.paged_attention(*pos, **kw, k_scale=ks[:, :, :, :8], v_scale=vs[:, :, :, :8])
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attention(*pos, **kw, k_scale=ks.transpose(0, 1).contiguous()
                            .transpose(0, 1), v_scale=vs)


# -- allocator -----------------------------------------------------------------


def _drive_allocator(mod, seed: int, n_ops: int = 400) -> list:
    """Admissions (match, alloc, publish), completions (publish the longer
    sequence, release), retains and purges, with everything observable
    logged after each operation."""
    rng = np.random.default_rng(seed)
    ps = 4
    evicted: list = []
    a = mod.PageAllocator(14, on_evict=evicted.append)
    owners: list[tuple[list[int], list[int]]] = []  # (tokens, pages)
    log: list = []
    for _ in range(n_ops):
        op = int(rng.integers(0, 10))
        if op < 5:
            toks = [int(t) for t in rng.integers(0, 3, size=int(rng.integers(3, 22)))]
            matched = a.match_prefix(toks, ps)
            need = -(-len(toks) // ps) - len(matched)
            try:
                fresh = a.alloc(need)
            except MemoryError:
                for p in matched:
                    a.release(p)
                log.append(("oom", matched))
                continue
            pages = matched + fresh
            n_full = len(toks) // ps
            a.publish_chain(toks[: n_full * ps], ps, pages[:n_full])
            owners.append((toks, pages))
            log.append(("admit", matched, fresh))
        elif op < 8 and owners:
            toks, pages = owners.pop(int(rng.integers(0, len(owners))))
            a.publish_chain(toks[: len(toks) // ps * ps], ps, pages[: len(toks) // ps])
            for p in pages:
                a.release(p)
            log.append(("finish", pages))
        elif op == 8 and owners:
            pid = owners[int(rng.integers(0, len(owners)))][1][0]
            a.retain(pid)
            a.release(pid)
            log.append(("retain", pid, a.lookup((0, (0, 0, 0, 0)))))
        elif op == 9 and rng.random() < 0.2:
            log.append(("purge", a.purge_root(0)))
        log.append((a.n_free, a.n_evictable, a.scan_evictable(), a.evictions,
                    list(a._ref), len(evicted)))
    log.append(evicted)
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_operation_for_operation(seed):
    ours, ref = _drive_allocator(tpc, seed), _drive_allocator(jpc, seed)
    assert ours == ref
    assert any(entry[0] == "oom" for entry in ref if isinstance(entry[0], str))
    assert ref[-2][3] > 0, "the sequence must exercise LRU eviction"


def test_block_keys_match_jax():
    toks = list(range(23))
    for parents in ([7, 9, 4, 5, 6], [1, 2, 3, 4, 5]):
        assert tpc.block_keys(toks, 4, parents) == jpc.block_keys(toks, 4, parents)
    with pytest.raises(ValueError, match="page 0"):
        tpc.PageAllocator(1)


# -- multi-query q (the speculative verify) ---------------------------------------

# name: (kv heads, groups, head_dim, page size, max pages, pool, tail, Q,
# lengths, starts)
MQ_CASES = {
    # tests/test_paged.py's multi-query inputs: a dead slot, a page-aligned
    # start, a mid-page start, tail-straddling lengths
    "reference": (4, 2, 32, 16, 4, 16, 24, 5, [0, 20, 40, 21], [0, 16, 33, 20]),
    # the spec tick's Q = 9 at G = 4, head_dim 64 and 128: a dead slot, a
    # tail-only slot, a mid-page start, a page-aligned start
    "d64": (2, 4, 64, 16, 6, 32, 40, 9, [0, 30, 50, 97], [0, 0, 45, 80]),
    "d128": (2, 4, 128, 16, 6, 32, 40, 9, [0, 30, 50, 97], [0, 0, 45, 80]),
    # a tail longer than 128 columns: query 0's limit (125 columns) ends
    # before the tail's column 128, query 8's (133) crosses it
    "long_tail": (2, 4, 64, 16, 16, 40, 256, 9, [381, 60, 30], [256, 30, 0]),
}


@functools.lru_cache(maxsize=None)
def _mq_case(name: str, int8: bool = False):
    """f32 inputs for a 4-D q; the reference case draws in
    ``tests/test_paged.py``'s order (its table random), the others give each
    slot its own pages. ``int8``: the pools quantized per position (absmax
    over D, scale 1.0 on zero rows, round half to even), scales (P, K, 1,
    ps)."""
    kv, groups, d, ps, maxp, pool, tail, nq, lengths, starts = MQ_CASES[name]
    b = len(lengths)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(b, nq, kv * groups, d)).astype(np.float32)
    kp = rng.normal(size=(pool, kv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(pool, kv, ps, d)).astype(np.float32)
    tk = rng.normal(size=(b, kv, tail, d)).astype(np.float32)
    tv = rng.normal(size=(b, kv, tail, d)).astype(np.float32)
    if name == "reference":
        table = rng.integers(1, pool, size=(b, maxp)).astype(np.int32)
    else:
        table = np.zeros((b, maxp), np.int32)
        pid = 1
        for row in range(b):
            for i in range(-(-min(lengths[row], starts[row]) // ps)):
                table[row, i] = pid
                pid += 1
        assert pid <= pool
    a = {"q": q, "k_pages": kp, "v_pages": vp, "page_table": table,
         "lengths": np.asarray(lengths, np.int32), "tail_k": tk, "tail_v": tv,
         "starts": np.asarray(starts, np.int32)}
    if int8:
        for pool_name, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            x = a[pool_name]
            absmax = np.abs(x).max(-1)
            sc = np.where(absmax == 0, 1.0, absmax / np.float32(127)).astype(np.float32)
            a[pool_name] = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
            a[scale] = np.ascontiguousarray(sc[:, :, None, :])
    return a


@functools.lru_cache(maxsize=None)
def _jax_mq(name: str, int8: bool, impl: str) -> np.ndarray:
    a = {k: jnp.asarray(v) for k, v in _mq_case(name, int8).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    if impl == "xla":
        return np.asarray(jpa.paged_attention_xla(*pos, **a))
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True))


def _torch_mq(name: str, int8: bool = False):
    a = {k: torch.from_numpy(v) for k, v in _mq_case(name, int8).items()}
    return [a.pop(k) for k in POSITIONAL], a


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", sorted(MQ_CASES))
def test_multi_query_plain_matches_jax(name, int8, impl):
    """The plain version's 4-D branch (query qi sees the tail columns j with
    starts + j < lengths + qi, every query the same pages) against the JAX
    package's gather reference and its Pallas kernel with ``q_groups`` in
    interpret mode: f32 at 2e-5, over int8 pools at 1e-4 (the reference's
    own tolerances, ``tests/test_paged.py``)."""
    pos, kw = _torch_mq(name, int8)
    out = tpa.paged_attention_plain(*pos, **kw).numpy()
    assert out.shape == pos[0].shape
    np.testing.assert_allclose(out, _jax_mq(name, int8, impl), atol=1e-4 if int8 else ATOL)
    dead = np.flatnonzero(_mq_case(name)["lengths"] == 0)
    assert np.all(out[dead] == 0), "a dead slot must give zeros for every query"


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_multi_query_cpu_wrapper_matches_jax_pallas_interpret(int8):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    pos, kw = _torch_mq("d128", int8)
    tpa.reset_launches()
    out = tpa.paged_attention(*pos, **kw)
    assert (tpa.launches_verify, tpa.launches_verify_int8, tpa.launches_tail,
            tpa.launches_tail_int8) == (0, 0, 0, 0)
    np.testing.assert_allclose(out.numpy(), _jax_mq("d128", int8, "pallas"),
                               atol=1e-4 if int8 else ATOL)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", ["reference", "long_tail"])
def test_multi_query_q1_gives_the_3d_bits(name, int8):
    """A 4-D q with Q = 1 gives the 3-D call's bits (the reference passes no
    q_groups for Q = 1)."""
    pos, kw = _torch_mq(name, int8)
    q = pos[0]
    out41 = tpa.paged_attention(q[:, :1], *pos[1:], **kw)
    out3 = tpa.paged_attention(q[:, 0], *pos[1:], **kw)
    assert out41.shape == q[:, :1].shape
    assert torch.equal(out41[:, 0], out3)


def test_multi_query_requires_the_tail():
    pos, kw = _torch_mq("reference")
    with pytest.raises(ValueError, match="multi-query"):
        tpa.paged_attention(*pos)
    with pytest.raises(ValueError, match="multi-query"):
        tpa.paged_attention(pos[0][:, :1], *pos[1:])
