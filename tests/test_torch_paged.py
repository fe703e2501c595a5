"""Port parity for the paged KV cache.

- Kernel level: the port's ``paged_attention_plain`` and its CPU wrapper
  ``paged_attention`` against the JAX package's gather reference
  ``paged_attention_xla`` and its Pallas kernels (``_paged_tail_kernel``
  with a tail, ``_paged_kernel`` without) in interpret mode, on the same
  numpy inputs. f32 at atol 2e-5, the reference's own tolerance
  (``tests/test_paged.py``).
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpa.paged_attention(*pos, **kw, k_scale=scale, v_scale=scale)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpa.paged_attention(pos[0][:, None], *pos[1:], **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpa.paged_attention(*pos, **kw, mesh=object())
    with pytest.raises(ValueError, match="go together"):
        tpa.paged_attention(*pos, tail_k=kw["tail_k"])


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
