"""Port parity at the paged shapes past the kernels' first limits: any number
of query heads per KV head (G), any verify-row count (Q x G) and any head dim
up to 256 that is a multiple of 16.

- The port's ``paged_attention`` (on CPU tensors its plain version, no
  launch) against the JAX package's ``paged_attention`` with its Pallas
  kernel in interpret mode, on the same numpy inputs, at (D, H, K, Q) in
  ``SHAPES``: Phi-3-mini's D = 96 (G = 1, single-query and a 9-row
  verify), G = 16 at D = 16 (a single query past the single-query form's 8
  rows, and a 144-row verify: two row groups of the kernels), Mistral-
  Large-2's G = 12 at D = 80 (108 rows) and G = 16 on 2 KV heads at D = 48.
  Over bf16 pools (q and tails bf16) at 2e-2 (the plain version rounds p
  against the final row max, the reference kernel against its running max:
  one bf16 ulp near 1), f32 pools at 2e-5 (the reference's own tolerance),
  int8 pools under an f32 q at 1e-4 (``tests/test_torch_paged.py``'s int8
  tolerance) and under a bf16 q at 2e-2. G = 20 at D = 32 with Q = 3 (60
  rows, the last row tile partial).
- ``paged_attention_split_plain`` (the kernels' order) against
  ``paged_attention_plain`` at the same shapes in f32, splits of 64 and 128
  keys: row groups change no row's arithmetic, so the twin has none. The
  split length a bf16 or float16 call takes (``split_keys``: 256 keys from
  2304 query rows a call) is the twin's default, and the twin holds the
  plain version there.
- Two tiny engine configs, 2 layers each: D = 96 with G = 1, and D = 16 with
  16 query heads on 1 KV head. The port's paged ``ContinuousEngine`` gives
  the JAX engine's greedy tokens on the same weights (``models/convert.py``),
  plain and speculative at the default ``spec_k = 8`` (every tick
  speculative: a 9-row verify at G = 1, 144 rows at G = 16), in bf16 and f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JEngine  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.ops import paged_attention as jpa  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402
from ditl_tpu_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

# (head_dim, query heads, KV heads, Q (1: a 3-D q)); (128, 8, 2, 9) is path
# 11's spec tick at G = 4 (36 rows a KV head: three row tiles, in two blocks
# of at most two on the card's f32 verify over int8 pools), (256, 8, 1, 9) D
# = 256 at G = 8 (72 rows: blocks of two row tiles), (32, 20, 1, 3) G = 20
# at Q = 3 (60 rows: four row tiles, the last partial).
SHAPES = [(96, 2, 2, 1), (96, 2, 2, 9), (16, 16, 1, 1), (16, 16, 1, 9), (80, 12, 1, 9),
          (48, 16, 2, 9), (128, 8, 2, 9), (256, 8, 1, 9), (32, 20, 1, 3)]
# pool kind -> (q and tail dtype, int8 pools, tolerance); "int8_bf16" is the
# int8 serving path's bf16 q and tails over int8 pools, "int8_f16" the same
# in float16
POOLS = {"bf16": ("bfloat16", False, 2e-2), "f32": ("float32", False, 2e-5),
         "int8": ("float32", True, 1e-4), "int8_bf16": ("bfloat16", True, 2e-2),
         "int8_f16": ("float16", True, 2e-2)}
# A dead slot, a tail-only slot, tails that straddle a page edge; page 16,
# four pages a slot, a 24-column tail (the verify's nine rows fit in it).
LENGTHS, STARTS, PAGE, MAX_PAGES, TAIL = [0, 20, 40, 21], [0, 16, 33, 20], 16, 4, 24
POSITIONAL = ("q", "k_pages", "v_pages", "page_table", "lengths")


def _shape_id(shape) -> str:
    d, h, kv, nq = shape
    return f"d{d}_h{h}_kv{kv}_q{nq}"


@functools.lru_cache(maxsize=None)
def _case(shape: tuple, int8: bool) -> dict:
    """f32 numpy inputs, each slot its own pages; int8 pools quantized per
    position (absmax over D, scale 1.0 on zero rows, round half to even)."""
    d, h, kv, nq = shape
    b = len(LENGTHS)
    rng = np.random.default_rng(d * 1000 + h * 10 + nq)
    pool = b * MAX_PAGES + 1
    a = {"q": rng.normal(size=(b, h, d) if nq == 1 else (b, nq, h, d)).astype(np.float32),
         "k_pages": rng.normal(size=(pool, kv, PAGE, d)).astype(np.float32),
         "v_pages": rng.normal(size=(pool, kv, PAGE, d)).astype(np.float32),
         "lengths": np.asarray(LENGTHS, np.int32),
         "tail_k": rng.normal(size=(b, kv, TAIL, d)).astype(np.float32),
         "tail_v": rng.normal(size=(b, kv, TAIL, d)).astype(np.float32),
         "starts": np.asarray(STARTS, np.int32)}
    table = np.zeros((b, MAX_PAGES), np.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-min(LENGTHS[row], STARTS[row]) // PAGE)):
            table[row, i] = pid
            pid += 1
    a["page_table"] = table
    if int8:
        for pool_name, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            x = a[pool_name]
            absmax = np.abs(x).max(-1)
            sc = np.where(absmax == 0, 1.0, absmax / np.float32(127)).astype(np.float32)
            a[pool_name] = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
            a[scale] = np.ascontiguousarray(sc[:, :, None, :])
    return a


FLOATS = ("q", "k_pages", "v_pages", "tail_k", "tail_v")


def _torch_case(shape, pool: str) -> dict:
    dtype, int8, _ = POOLS[pool]
    t = {k: torch.from_numpy(v) for k, v in _case(shape, int8).items()}
    return {k: v.to(getattr(torch, dtype)) if k in FLOATS and v.is_floating_point() else v
            for k, v in t.items()}


@functools.lru_cache(maxsize=None)
def _jax_out(shape: tuple, pool: str) -> np.ndarray:
    dtype, int8, _ = POOLS[pool]
    a = {k: jnp.asarray(v) for k, v in _case(shape, int8).items()}
    a = {k: v.astype(getattr(jnp, dtype)) if k in FLOATS and v.dtype == jnp.float32 else v
         for k, v in a.items()}
    pos = [a.pop(k) for k in POSITIONAL]
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True), np.float32)


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_paged_matches_jax_pallas_at_any_group_rows_and_head_dim(shape, pool):
    """The CPU wrapper (no launch) and the plain version against the JAX
    ``paged_attention`` (Pallas, interpret mode); a dead slot gives zeros;
    the shape routes to a kernel on the card."""
    dtype, int8, tol = POOLS[pool]
    t = _torch_case(shape, pool)
    pos = [t.pop(k) for k in POSITIONAL]
    tpa.reset_launches()
    wrapped = tpa.paged_attention(*pos, **t)
    plain = tpa.paged_attention_plain(*pos, t["tail_k"], t["tail_v"], t["starts"],
                                      t.get("k_scale"), t.get("v_scale"))
    assert sum(getattr(tpa, c) for c in tpa._COUNTERS.values()) == 0
    want = _jax_out(shape, pool)
    for out in (wrapped, plain):
        assert out.dtype == getattr(torch, dtype) and out.shape == pos[0].shape
        np.testing.assert_allclose(out.float().numpy(), want, atol=tol, rtol=tol)
    assert np.all(wrapped.float().numpy()[0] == 0), "a dead slot gives zeros"
    d, _, _, nq = shape
    assert tpa.kernel_route(getattr(torch, dtype), d, int8=int8, verify=nq > 1,
                            tail=True).startswith("ditl_paged")


@functools.lru_cache(maxsize=None)
def _jax_no_tail_out(shape: tuple, pool: str) -> np.ndarray:
    """The JAX ``paged_attention`` without a tail (K4's Pallas kernel,
    interpret mode) over pages up to min(starts, lengths)."""
    dtype, _, _ = POOLS[pool]
    a = _case(shape, False)
    lens = np.minimum(a["starts"], a["lengths"])
    pos = [jnp.asarray(a[k]).astype(getattr(jnp, dtype)) if k in FLOATS else jnp.asarray(a[k])
           for k in POSITIONAL[:4]] + [jnp.asarray(lens)]
    return np.asarray(jpa.paged_attention(*pos, interpret=True), np.float32)


@pytest.mark.parametrize("pool", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[3] == 1], ids=_shape_id)
def test_paged_no_tail_matches_jax_pallas(shape, pool):
    """K4 (no tail, pages up to min(starts, lengths)) at the one-query
    shapes: the CPU wrapper (no launch) and the plain version against the
    JAX ``paged_attention`` without a tail (Pallas, interpret mode); the
    shape routes to K4's entry point (on the card K4-f32 runs the
    tensor-core kernel at any G and D)."""
    dtype, _, tol = POOLS[pool]
    t = _torch_case(shape, pool)
    lens = torch.minimum(t["starts"], t["lengths"])
    pos = [t[k] for k in POSITIONAL[:4]] + [lens]
    tpa.reset_launches()
    wrapped = tpa.paged_attention(*pos)
    plain = tpa.paged_attention_plain(*pos)
    assert sum(getattr(tpa, c) for c in tpa._COUNTERS.values()) == 0
    want = _jax_no_tail_out(shape, pool)
    for out in (wrapped, plain):
        assert out.dtype == getattr(torch, dtype) and out.shape == pos[0].shape
        np.testing.assert_allclose(out.float().numpy(), want, atol=tol, rtol=tol)
    assert np.all(wrapped.float().numpy()[0] == 0), "a dead slot gives zeros"
    assert tpa.kernel_route(getattr(torch, dtype), shape[0], int8=False, verify=False,
                            tail=False) == "ditl_paged" + ("_f32" if pool == "f32" else "_bf16")


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_split_twin_matches_plain_with_row_groups(shape, split):
    """The kernels' order (``paged_attention_split_plain``) gives the plain
    version's output in f32 with and without a tail, at shapes whose rows
    the kernels cut into row groups (144 and 108 verify rows, a 16-row
    single query)."""
    for pool in ("f32", "int8"):
        t = _torch_case(shape, pool)
        pos = [t.pop(k) for k in POSITIONAL]
        args = (t["tail_k"], t["tail_v"], t["starts"], t.get("k_scale"), t.get("v_scale"))
        twin = tpa.paged_attention_split_plain(*pos, *args, split=split)
        np.testing.assert_allclose(twin.numpy(), tpa.paged_attention_plain(*pos, *args).numpy(),
                                   atol=2e-5, rtol=2e-5)
        if pos[0].dim() == 3 and pool == "f32":  # K4: pages up to min(starts, lengths)
            lens = torch.minimum(t["starts"], pos[4])
            no_tail = (*pos[:4], lens)
            np.testing.assert_allclose(
                tpa.paged_attention_split_plain(*no_tail, split=split).numpy(),
                tpa.paged_attention_plain(*no_tail).numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,b,nq,h,kv,split", [
    ("bfloat16", 64, 1, 64, 8, 128), ("bfloat16", 8, 9, 32, 8, 256),
    ("float16", 7, 9, 32, 8, 128), ("bfloat16", 8, 9, 128, 8, 256),
    ("float16", 8, 9, 32, 32, 256), ("bfloat16", 8, 9, 8, 1, 128),
    ("bfloat16", 8, 1, 128, 8, 128), ("float32", 8, 9, 128, 8, 256),
    ("float32", 8, 9, 32, 8, 128), ("float32", 8, 5, 128, 8, 256),
    ("float32", 8, 1, 128, 8, 128)])
def test_split_keys_follows_the_rows_of_the_call(dtype, b, nq, h, kv, split):
    """The split length: 256 keys in bf16 and float16 where the call holds
    at least 2304 query rows (B * Q * H: the spec tick of llama3-8b, 8 x 9
    x 32) and more than 8 a KV head (the row-tile kernel); for the f32
    verify over f32 pools from 4608 rows (path 16's 144 and 80 rows, not
    path 11's 36); 128 (``SPLIT_KEYS``) otherwise: fewer rows, the
    single-query kernels, one f32 query at any G."""
    q = torch.empty((b, h, 16) if nq == 1 else (b, nq, h, 16), dtype=getattr(torch, dtype))
    assert tpa.split_keys(q, torch.empty((1, kv, 16, 16))) == split


def test_split_keys_keeps_128_for_the_f32_verify_over_int8_pools():
    """The f32 verify over int8 pools keeps ``SPLIT_KEYS`` at every row
    count (its 256-key rule is the f32 pools' alone), so its bits hold."""
    q = torch.empty((8, 9, 128, 16), dtype=torch.float32)
    assert tpa.split_keys(q, torch.empty((1, 8, 16, 16), dtype=torch.int8)) == tpa.SPLIT_KEYS
    assert tpa.split_keys(q, torch.empty((1, 8, 16, 16))) == tpa.LONG_SPLIT


# (B, Q, H, K, q dtype): a bf16 verify of 2592 query rows (splits of 256
# keys), and G = 16 in one query and at Q = 9 on fewer rows (splits of
# 128), over float and int8 pools.
SPLIT_CALLS = [(4, 9, 72, 8, "bfloat16"), (2, 1, 32, 2, "float16"), (2, 9, 32, 2, "bfloat16")]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("call", SPLIT_CALLS, ids=lambda c: f"b{c[0]}_q{c[1]}_h{c[2]}_k{c[3]}")
def test_split_twin_takes_the_wrappers_split(call, int8):
    """The split twin's default length is ``split_keys``, the one the CUDA
    wrapper launches with (the same bits as an explicit ``split=``), and at
    it the twin gives the plain version's output at the kernels' 16-bit
    tolerance (2e-2)."""
    b, nq, h, kv, dtype = call
    d, ps, maxp, tail = 16, 16, 12, 24
    rng = np.random.default_rng(b * 100 + nq * 10 + kv)
    dt = getattr(torch, dtype)
    lengths = torch.tensor([181, 0, 40, 21][:b], dtype=torch.int32)
    starts = torch.tensor([176, 0, 33, 20][:b], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(b, h, d) if nq == 1 else (b, nq, h, d))).to(dt)
    kp, vp = (torch.from_numpy(rng.normal(size=(b * maxp + 1, kv, ps, d))).to(dt)
              for _ in range(2))
    table = torch.arange(1, b * maxp + 1, dtype=torch.int32).reshape(b, maxp)
    tk, tv = (torch.from_numpy(rng.normal(size=(b, kv, tail, d))).to(dt) for _ in range(2))
    scales = ()
    if int8:
        kp, vp = ((x.float() * 20).round().clamp(-127, 127).to(torch.int8) for x in (kp, vp))
        scales = tuple(torch.from_numpy(rng.uniform(0.01, 0.05, size=(b * maxp + 1, kv, 1, ps))
                                        .astype(np.float32)) for _ in range(2))
    args = (q, kp, vp, table, lengths, tk, tv, starts, *scales)
    split = tpa.split_keys(q, kp)
    assert split == (256 if b * nq * h >= 2304 else 128)
    twin = tpa.paged_attention_split_plain(*args)
    assert torch.equal(twin, tpa.paged_attention_split_plain(*args, split=split))
    np.testing.assert_allclose(twin.float().numpy(),
                               tpa.paged_attention_plain(*args).float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_every_multiple_of_16_routes_and_others_raise():
    """``HEAD_DIMS`` is every multiple of 16 up to 256, each on the smallest
    template instance that holds it; any other head dim raises naming
    ROADMAP.md §2 in every dtype."""
    assert tpa.HEAD_DIMS == tuple(range(16, 257, 16))
    assert tpa.INSTANCE_DIMS == (32, 64, 128, 256)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in tpa.HEAD_DIMS:
            assert tpa.kernel_route(dtype, d, int8=False, verify=True, tail=True).startswith(
                "ditl_paged_verify")
        for d in (8, 40, 100, 264, 272, 512):
            with pytest.raises(NotImplementedError, match=f"head_dim {d}.*ROADMAP.md §2"):
                tpa.kernel_route(dtype, d, int8=False, verify=False, tail=True)


# -- engines ---------------------------------------------------------------------

# Two layers at a tiny width: Phi-3-mini's D = 96 with G = 1, and G = 16 (16
# query heads on 1 KV head) at D = 16.
ENGINE_CONFIGS = {
    "d96_g1": dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                   num_heads=2, num_kv_heads=2, head_dim=96, max_seq_len=256),
    "d16_g16": dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                    num_heads=16, num_kv_heads=1, head_dim=16, max_seq_len=256),
}
PROMPTS = ["abcabcabcabcabcabc", "the cat sat on the mat the cat sat", "x"]
PAGED = dict(n_slots=3, decode_chunk=4, page_size=16, cache_mode="paged")


@functools.lru_cache(maxsize=None)
def _weights(name: str):
    jcfg = JModelConfig(**ENGINE_CONFIGS[name], param_dtype="float32")
    return jax.device_get(jllama.init_params(jax.random.key(0), jcfg))


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(ENGINE_CONFIGS))
def test_engine_greedy_matches_jax(name, dtype, spec):
    """The port's paged continuous engine against the JAX paged engine on the
    same weights: identical greedy tokens, plain and with every tick
    speculative at the default ``spec_k`` (8: a verify of 9 x G rows per KV
    head)."""
    kw = dict(ENGINE_CONFIGS[name], dtype=dtype, param_dtype="float32")
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    params = _weights(name)
    eng_kw = dict(PAGED, **(dict(speculative=True, spec_threshold=0.0) if spec else {}))
    jeng = JEngine(jax.tree.map(jnp.asarray, params), jcfg, JByteTokenizer(), **eng_kw)
    teng = ContinuousEngine(params_from_jax(params, cfg, "cpu"), cfg, ByteTokenizer(),
                            device="cpu", **eng_kw)
    assert teng.cache["kp"].shape[-1] == cfg.head_dim
    out = _greedy_tokens(teng)
    if spec:
        st = teng.stats()["speculative"]
        assert teng.spec_k == 8 and st["spec_ticks"] == st["ticks"] > 0
    assert out == _greedy_tokens(jeng)
    assert all(len(o) == 12 for o in out)


def _greedy_tokens(engine) -> list[list[int]]:
    """Each prompt's 12 greedy token ids (EOS never ends them: the ids, not
    the text, so bytes that decode to nothing still count)."""
    tok = engine.tokenizer
    ids = [engine.submit([tok.bos_id] + tok.encode(p), max_new_tokens=12, temperature=0.0)
           for p in PROMPTS]
    done = engine.run()
    return [list(done[i]) for i in ids]
