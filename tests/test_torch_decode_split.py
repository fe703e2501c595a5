"""Port parity for the split rule of the paged decode kernels (K3, K4).

``paged_attention_split_plain`` computes what the split-key CUDA kernels
compute, in their order: partials over runs of ``split`` positions of a
slot's axis (pages, then the tail), tile by tile with an online softmax,
merged in split order. It is held here to the JAX package's gather reference
``paged_attention_xla`` and to its Pallas kernels in interpret mode
(``_paged_tail_kernel`` with a tail, ``_paged_kernel`` without), on the same
numpy inputs in f32, at atol 2e-5, the reference's own tolerance
(``tests/test_paged.py``): in f32 the split form only reorders f32 sums.

Cases: the ragged decode tick of ``chip_smoke.py::_paged_main_case`` at
narrow heads (a dead slot, a partial page, an exact page boundary, a shared
page, starts == lengths), page 256 with splits of 64 (boundaries inside
pages) and 256 (the last split holds only the tail); and page 16 with a
tail, where a split's tile straddles the last page and the tail.

K3 over int8 pools (``ditl_paged_tail_i8``): the split twin's int8 branch
(K's scale on each page key's f32 score, p times V's scale cast to the
tails' dtype before p.v, l adding the unscaled p) on the same cases with
the pools quantized per position, against the Pallas kernel's quantized
branch in interpret mode and the gather reference, f32 at 2e-5; and in
bf16 against the plain version's int8 branch at 2e-2 (the twin rounds
p * vs to bf16 against the split's running max, the plain version keeps
it in f32).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.ops import paged_attention as jpa  # noqa: E402
from ditl_tpu_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

ATOL = 2e-5
# bf16 against the plain version: both round p to bf16, against the split's
# running max or the final max, and round o to bf16: a few bf16 ulps.
O_TOL = 2e-2

# name: (page_size, tail_len, lengths, starts)
CASES = {
    # chip_smoke.py::_paged_main_case
    "tick": (256, 16, [0, 710, 512, 1500, 10, 256, 1046, 309],
             [0, 700, 512, 1490, 9, 256, 1030, 300]),
    # page 16: 6 pages (96 positions), then an 8-column tail
    "small": (16, 8, [0, 5, 38, 50, 90, 33], [0, 0, 32, 45, 88, 33]),
}


@functools.lru_cache(maxsize=None)
def _case(name: str, d: int, tail: bool):
    """f32 inputs with 2 KV heads of 4 query heads each; each slot owns
    pages for ceil(max(lengths, starts) / ps) blocks, rows 1 and 2 share
    their first page. Without a tail (K4) the lengths are min(starts,
    lengths)."""
    ps, t, lengths, starts = CASES[name]
    rng = np.random.default_rng(d)
    b, kv, groups = len(lengths), 2, 4
    maxp = max(-(-max(x, y) // ps) for x, y in zip(lengths, starts))
    table = np.zeros((b, maxp), np.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-max(lengths[row], starts[row]) // ps)):
            table[row, i] = pid
            pid += 1
    table[2, 0] = table[1, 0]
    q = rng.normal(size=(b, kv * groups, d)).astype(np.float32)
    kp = rng.normal(size=(pid, kv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(pid, kv, ps, d)).astype(np.float32)
    lengths, starts = np.asarray(lengths, np.int32), np.asarray(starts, np.int32)
    if not tail:
        return {"q": q, "k_pages": kp, "v_pages": vp, "page_table": table,
                "lengths": np.minimum(lengths, starts)}
    return {"q": q, "k_pages": kp, "v_pages": vp, "page_table": table, "lengths": lengths,
            "tail_k": rng.normal(size=(b, kv, t, d)).astype(np.float32),
            "tail_v": rng.normal(size=(b, kv, t, d)).astype(np.float32), "starts": starts}


POSITIONAL = ("q", "k_pages", "v_pages", "page_table", "lengths")


@functools.lru_cache(maxsize=None)
def _jax_out(name: str, d: int, tail: bool, impl: str) -> np.ndarray:
    a = {k: jnp.asarray(v) for k, v in _case(name, d, tail).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    if impl == "xla":
        return np.asarray(jpa.paged_attention_xla(*pos, **a))
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True))


def _split(name: str, d: int, tail: bool, split: int) -> torch.Tensor:
    a = {k: torch.from_numpy(v) for k, v in _case(name, d, tail).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    return tpa.paged_attention_split_plain(*pos, **a, split=split)


@pytest.mark.parametrize("tail", [True, False], ids=["K3", "K4"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name,split", [("tick", 64), ("tick", tpa.SPLIT_KEYS),
                                        ("small", 64)])
def test_split_plain_matches_jax_xla_reference(name, split, d, tail):
    out = _split(name, d, tail, split).numpy()
    np.testing.assert_allclose(out, _jax_out(name, d, tail, "xla"), atol=ATOL)
    dead = np.flatnonzero(_case(name, d, tail)["lengths"] == 0)
    assert dead.size and np.all(out[dead] == 0), "a dead slot must give zeros"


@pytest.mark.parametrize("tail", [True, False], ids=["K3", "K4"])
@pytest.mark.parametrize("d", [64, 128])
def test_split_plain_matches_jax_pallas_interpret(d, tail):
    """At the kernels' own split length, against the Pallas kernel the JAX
    package runs for the same call (K3 with a tail, K4 without)."""
    out = _split("tick", d, tail, tpa.SPLIT_KEYS).numpy()
    np.testing.assert_allclose(out, _jax_out("tick", d, tail, "pallas"), atol=ATOL)


def test_split_cases_reach_the_edges():
    """The tick case has what the kernels' split rule must get right: a
    split whose only keys are the tail, splits past every live key (empty
    partials), a split boundary inside a page, and slots with starts ==
    lengths; the small case a tile across the last page and the tail."""
    ps, t, lengths, starts = CASES["tick"]
    maxp = _case("tick", 64, True)["page_table"].shape[1]
    n_page = maxp * ps
    assert n_page % tpa.SPLIT_KEYS == 0 and t <= tpa.SPLIT_KEYS  # last split: tail only
    assert tpa.split_count(maxp, ps, t, tpa.SPLIT_KEYS) == n_page // tpa.SPLIT_KEYS + 1
    assert ps % 64 == 0 and ps > 64  # splits of 64 cut pages
    assert any(min(s, n) < n_page - tpa.SPLIT_KEYS for s, n in zip(starts, lengths))
    assert any(s == n for s, n in zip(starts, lengths))
    ps, t, _, _ = CASES["small"]
    n_page = _case("small", 64, True)["page_table"].shape[1] * ps
    assert n_page % 64 != 0  # the tile at 64 holds pages and tail


@pytest.mark.parametrize("tail", [True, False], ids=["K3", "K4"])
def test_split_plain_bf16_matches_plain(tail):
    """bf16, as the kernels run: within O_TOL of ``paged_attention_plain``
    (p rounded to bf16 against the split's running max, not the final
    max)."""
    a = {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
         else torch.from_numpy(v) for k, v in _case("tick", 128, tail).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    want = tpa.paged_attention_plain(*pos, *(a[k] for k in ("tail_k", "tail_v", "starts")
                                             if k in a))
    got = tpa.paged_attention_split_plain(*pos, **a)
    torch.testing.assert_close(got.float(), want.float(), atol=O_TOL, rtol=O_TOL)


@functools.lru_cache(maxsize=None)
def _int8_case(name: str, d: int):
    """The K3 case with its pools quantized per position (absmax over D,
    scale 1.0 on zero rows, round half to even, clip), scales (P, K, 1, ps)."""
    a = dict(_case(name, d, True))
    for pool, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
        x = a[pool]
        absmax = np.abs(x).max(-1)
        sc = np.where(absmax == 0, 1.0, absmax / np.float32(127)).astype(np.float32)
        a[pool] = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
        a[scale] = np.ascontiguousarray(sc[:, :, None, :])
    return a


@functools.lru_cache(maxsize=None)
def _jax_int8_out(name: str, d: int, impl: str) -> np.ndarray:
    a = {k: jnp.asarray(v) for k, v in _int8_case(name, d).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    if impl == "xla":
        return np.asarray(jpa.paged_attention_xla(*pos, **a))
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name,split", [("tick", 64), ("tick", tpa.SPLIT_KEYS),
                                        ("small", 64)])
def test_int8_split_plain_matches_jax(name, split, d, impl):
    a = {k: torch.from_numpy(v) for k, v in _int8_case(name, d).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    out = tpa.paged_attention_split_plain(*pos, **a, split=split).numpy()
    np.testing.assert_allclose(out, _jax_int8_out(name, d, impl), atol=ATOL)
    dead = np.flatnonzero(_int8_case(name, d)["lengths"] == 0)
    assert dead.size and np.all(out[dead] == 0), "a dead slot must give zeros"


def test_int8_split_plain_bf16_matches_plain():
    a = {k: torch.from_numpy(v).to(torch.bfloat16) if k in ("q", "tail_k", "tail_v")
         else torch.from_numpy(v) for k, v in _int8_case("tick", 128).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    want = tpa.paged_attention_plain(*pos, **a)
    got = tpa.paged_attention_split_plain(*pos, **a)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=O_TOL, rtol=O_TOL)


def test_split_plain_rejects_ragged_split():
    a = {k: torch.from_numpy(v) for k, v in _case("small", 64, True).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    with pytest.raises(ValueError, match="multiple"):
        tpa.paged_attention_split_plain(*pos, **a, split=96)


# -- multi-query q (the speculative verify) ---------------------------------------

# name: (kv heads, groups, head_dim, page size, max pages, tail, Q, lengths,
# starts); every slot owns its pages.
MQ_CASES = {
    # the spec tick's Q = 9 at G = 4 (narrow heads): a dead slot, a tail-only
    # slot, a mid-page start, a page-aligned start
    "spec": (2, 4, 64, 16, 6, 40, 9, [0, 30, 50, 97], [0, 0, 45, 80]),
    # a tail longer than 128 columns: query 0's limit (125 columns) ends
    # before the tail's column 128, query 8's (133) crosses it, so the split
    # from column 128 on is live for queries 4-8 and dead for 0-3
    "long_tail": (2, 4, 64, 16, 16, 256, 9, [381, 60, 30], [256, 30, 0]),
    "long_tail_d128": (2, 4, 128, 16, 16, 256, 9, [381, 60, 30], [256, 30, 0]),
}


@functools.lru_cache(maxsize=None)
def _mq_case(name: str, int8: bool = False):
    kv, groups, d, ps, maxp, tail, nq, lengths, starts = MQ_CASES[name]
    b = len(lengths)
    rng = np.random.default_rng(11)
    table = np.zeros((b, maxp), np.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-min(lengths[row], starts[row]) // ps)):
            table[row, i] = pid
            pid += 1
    a = {"q": rng.normal(size=(b, nq, kv * groups, d)).astype(np.float32),
         "k_pages": rng.normal(size=(pid, kv, ps, d)).astype(np.float32),
         "v_pages": rng.normal(size=(pid, kv, ps, d)).astype(np.float32),
         "page_table": table, "lengths": np.asarray(lengths, np.int32),
         "tail_k": rng.normal(size=(b, kv, tail, d)).astype(np.float32),
         "tail_v": rng.normal(size=(b, kv, tail, d)).astype(np.float32),
         "starts": np.asarray(starts, np.int32)}
    if int8:
        for pool, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            x = a[pool]
            absmax = np.abs(x).max(-1)
            sc = np.where(absmax == 0, 1.0, absmax / np.float32(127)).astype(np.float32)
            a[pool] = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
            a[scale] = np.ascontiguousarray(sc[:, :, None, :])
    return a


@functools.lru_cache(maxsize=None)
def _jax_mq(name: str, int8: bool, impl: str) -> np.ndarray:
    a = {k: jnp.asarray(v) for k, v in _mq_case(name, int8).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    if impl == "xla":
        return np.asarray(jpa.paged_attention_xla(*pos, **a))
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("split", [64, tpa.SPLIT_KEYS])
@pytest.mark.parametrize("name", sorted(MQ_CASES))
def test_multi_query_split_plain_matches_jax(name, split, int8, impl):
    """The split twin's 4-D branch (tiles and splits processed when any
    query has a live key in them; a query's partial with nothing live in a
    split weighs 0 in the merge) against the JAX package's gather reference
    and its Pallas kernel with ``q_groups`` in interpret mode: f32 at 2e-5,
    over int8 pools at 1e-4."""
    a = {k: torch.from_numpy(v) for k, v in _mq_case(name, int8).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    out = tpa.paged_attention_split_plain(*pos, **a, split=split).numpy()
    np.testing.assert_allclose(out, _jax_mq(name, int8, impl), atol=1e-4 if int8 else ATOL)
    dead = np.flatnonzero(_mq_case(name)["lengths"] == 0)
    assert np.all(out[dead] == 0), "a dead slot must give zeros for every query"


def test_multi_query_long_tail_reaches_a_split_dead_for_early_queries():
    """The long-tail case holds what the merge rule must get right: in slot
    0 the split starting at tail column 128 is live for the last queries and
    holds nothing live for the first."""
    kv, groups, d, ps, maxp, tail, nq, lengths, starts = MQ_CASES["long_tail"]
    assert (maxp * ps) % tpa.SPLIT_KEYS == 0 and tail > 128  # column 128 opens a split
    first = lengths[0] - starts[0]  # query qi sees tail columns < first + qi
    assert first <= 128 < first + nq - 1


def test_multi_query_q1_split_gives_the_3d_bits():
    a = {k: torch.from_numpy(v) for k, v in _mq_case("spec").items()}
    pos = [a.pop(k) for k in POSITIONAL]
    q = pos[0]
    out41 = tpa.paged_attention_split_plain(q[:, :1], *pos[1:], **a)
    out3 = tpa.paged_attention_split_plain(q[:, 0], *pos[1:], **a)
    assert torch.equal(out41[:, 0], out3)
