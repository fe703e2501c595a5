"""Port parity at the head dims the reference's kernels take beyond 64 and
128: D = 32 (``tiny-llama``, the default ``ModelConfig``) and D = 256.

- Paged attention: the port's ``paged_attention_plain`` and its CPU wrapper
  against the JAX package's gather reference ``paged_attention_xla`` and its
  Pallas kernels in interpret mode, on the same numpy inputs, at D = 256
  (single-query with and without a tail, a Q = 3 verify at G = 8, int8
  pools with scales) and D = 32 (int8 pools, no tail; the D = 32 verify is
  ``tests/test_torch_paged.py``'s "reference" case). f32 at atol 2e-5, the
  reference's own tolerance; the int8 verify at 1e-4, as
  ``tests/test_torch_paged.py`` holds it.
- Flash attention at D = 256: the forward and ``torch.autograd`` through the
  port's ``flash_attention`` (the plain versions on the CPU) against the JAX
  package's ``flash_attention`` with its Pallas kernels in interpret mode
  (S = 128, so its ``supports`` takes the kernel), causal and packed, f32:
  o at atol 2e-5, each gradient within 1e-4 of its largest magnitude (the
  same formulas, whole-tensor here and tiled there, summed in other
  orders). The kernels' D = 256 tilings (32-key tiles for K1 and K2a, 64-key
  blocks for K2b) cover every admitted pair.
- A D = 256 model (2 layers, vocab 512, 2 query heads on 1 KV head, f32):
  greedy tokens of the port's paged continuous engine equal the JAX paged
  engine's, and one train step with ``attention_impl=flash`` matches the
  JAX step on loss (1e-5 relative), grad norm (1e-4) and every updated
  leaf (1e-3 of its largest value, ``tests/test_torch_train.py``'s rule).
- ``tiny-llama`` (D = 32) in f32: the port's paged engine gives the JAX
  paged engine's greedy tokens.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import MeshConfig  # noqa: E402
from ditl_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ditl_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from ditl_tpu.data.loader import make_global_batch  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JGenerateConfig  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.ops import flash_attention as jfa  # noqa: E402
from ditl_tpu.ops import paged_attention as jpa  # noqa: E402
from ditl_tpu.runtime.mesh import build_mesh  # noqa: E402
from ditl_tpu.train import state as jstate  # noqa: E402
from ditl_tpu.train import step as jstep  # noqa: E402
from ditl_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig  # noqa: E402
from ditl_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    params_to_numpy,
    train_params_from_jax,
)
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from ditl_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from ditl_tpu_torch.train import state as tstate  # noqa: E402
from ditl_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_flash_attention import _assert_covers, _schedule_ids  # noqa: E402
from test_torch_train import _assert_trees_close, _batch  # noqa: E402

torch.set_num_threads(1)

ATOL = 2e-5

# -- paged attention -------------------------------------------------------

# name: (kv heads, groups, head_dim, page size, max pages, pool, tail or 0,
# Q (0: a 3-D q), int8 pools, lengths, starts or None)
PAGED_CASES = {
    # K4: a dead slot, a partial page, an exact page boundary, many pages
    "d256_no_tail": (2, 2, 256, 16, 6, 32, 0, 0, False, [0, 7, 16, 90], None),
    # K3: a dead slot, a tail-only slot, page-aligned and mid-page starts
    "d256_tail": (2, 4, 256, 16, 6, 32, 8, 0, False, [0, 5, 38, 50], [0, 0, 32, 45]),
    # K3's verify, Q = 3 at G = 8: tail-straddling lengths
    "d256_verify_g8": (1, 8, 256, 16, 4, 16, 24, 3, False, [0, 20, 40, 21], [0, 16, 33, 20]),
    # K3 over int8 pools with (P, K, 1, ps) scales
    "d256_int8": (2, 4, 256, 16, 6, 32, 8, 0, True, [0, 5, 38, 50], [0, 0, 32, 45]),
    # its verify, Q = 3 at G = 8
    "d256_int8_verify_g8": (1, 8, 256, 16, 4, 16, 24, 3, True, [0, 20, 40, 21],
                            [0, 16, 33, 20]),
    # D = 32 (tiny-llama's 8 query on 4 KV heads): K4 and K3 over int8 pools
    "d32_no_tail": (4, 2, 32, 16, 6, 32, 0, 0, False, [0, 7, 16, 90], None),
    "d32_int8": (4, 2, 32, 16, 6, 32, 8, 0, True, [0, 5, 38, 50], [0, 0, 32, 45]),
}
POSITIONAL = ("q", "k_pages", "v_pages", "page_table", "lengths")


@functools.lru_cache(maxsize=None)
def _paged_case(name: str):
    """f32 inputs, each slot its own pages; int8 pools quantized per
    position (absmax over D, scale 1.0 on zero rows, round half to even)."""
    kv, groups, d, ps, maxp, pool, tail, nq, int8, lengths, starts = PAGED_CASES[name]
    b = len(lengths)
    rng = np.random.default_rng(len(name))
    q_shape = (b, kv * groups, d) if nq == 0 else (b, nq, kv * groups, d)
    a = {"q": rng.normal(size=q_shape).astype(np.float32),
         "k_pages": rng.normal(size=(pool, kv, ps, d)).astype(np.float32),
         "v_pages": rng.normal(size=(pool, kv, ps, d)).astype(np.float32),
         "lengths": np.asarray(lengths, np.int32)}
    resident = lengths if starts is None else np.minimum(starts, lengths)
    table = np.zeros((b, maxp), np.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-int(resident[row]) // ps)):
            table[row, i] = pid
            pid += 1
    assert pid <= pool
    a["page_table"] = table
    if starts is not None:
        a.update(tail_k=rng.normal(size=(b, kv, tail, d)).astype(np.float32),
                 tail_v=rng.normal(size=(b, kv, tail, d)).astype(np.float32),
                 starts=np.asarray(starts, np.int32))
    if int8:
        for pool_name, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            x = a[pool_name]
            absmax = np.abs(x).max(-1)
            sc = np.where(absmax == 0, 1.0, absmax / np.float32(127)).astype(np.float32)
            a[pool_name] = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
            a[scale] = np.ascontiguousarray(sc[:, :, None, :])
    return a


@functools.lru_cache(maxsize=None)
def _jax_paged(name: str, impl: str) -> np.ndarray:
    a = {k: jnp.asarray(v) for k, v in _paged_case(name).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    if impl == "xla":
        return np.asarray(jpa.paged_attention_xla(*pos, **a))
    return np.asarray(jpa.paged_attention(*pos, **a, interpret=True))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_plain_and_cpu_wrapper_match_jax(name, impl):
    """The plain version and the CPU wrapper (which runs it and launches
    nothing) against the JAX gather reference and its Pallas kernel in
    interpret mode; a dead slot gives zeros; the head dim routes to the
    kernels on the card."""
    a = {k: torch.from_numpy(v) for k, v in _paged_case(name).items()}
    pos = [a.pop(k) for k in POSITIONAL]
    kw = dict(a)
    plain = tpa.paged_attention_plain(*pos, kw.get("tail_k"), kw.get("tail_v"),
                                      kw.get("starts"), kw.get("k_scale"), kw.get("v_scale"))
    tpa.reset_launches()
    wrapped = tpa.paged_attention(*pos, **kw)
    assert sum(getattr(tpa, c) for c in tpa._COUNTERS.values()) == 0
    want = _jax_paged(name, impl)
    verify_int8 = "int8" in name and "verify" in name
    for out in (plain, wrapped):
        np.testing.assert_allclose(out.numpy(), want, atol=1e-4 if verify_int8 else ATOL)
    dead = np.flatnonzero(_paged_case(name)["lengths"] == 0)
    assert np.all(plain.numpy()[dead] == 0)
    d = pos[0].shape[-1]
    int8, verify, tail = "k_scale" in kw, pos[0].dim() == 4, "tail_k" in kw
    assert tpa.kernel_route(torch.float32, d, int8=int8, verify=verify, tail=tail).startswith(
        "ditl_paged")


# -- flash attention -------------------------------------------------------

def _flash_inputs(packed: bool):
    """B=2, S=128, 4 query heads on 2 KV heads, D = 256; packed: two
    documents a row, then right padding."""
    rng = np.random.default_rng(3 + packed)
    q, do = (rng.standard_normal((2, 128, 4, 256)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 128, 2, 256)).astype(np.float32) for _ in range(2))
    seg = None
    if packed:
        seg = np.ones((2, 128), np.int32)
        seg[:, 61:] = 2
        seg[:, 120:] = 0
    return q, k, v, do, seg


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_flash_forward_and_gradients_match_jax_kernels(packed, causal):
    """The port's ``flash_attention`` at D = 256 (the plain versions on the
    CPU, no launch) against ``jax.vjp`` of the JAX package's
    ``flash_attention`` with its Pallas kernels in interpret mode."""
    q, k, v, do, seg = _flash_inputs(packed)
    assert jfa.supports(128, 128, 256)
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, segment_ids=jseg,
                                   block_q=128, block_kv=128, interpret=True)

    jo, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention(*leaves, causal=causal,
                              segment_ids=None if seg is None else torch.from_numpy(seg))
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(do))
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == (0, 0, 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), atol=ATOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for kind in ("fwd", "dq", "dkv"):
            assert tfa.kernel_route(dtype, 256, kind)[0] in ("flash_fwd.cu", "flash_bwd.cu",
                                                              "flash_f32.cu")


@pytest.mark.parametrize("kind,causal,s", [("sorted", True, 300), ("nonmono", True, 300),
                                           ("padded", False, 200), ("mid", True, 257)])
def test_head_dim_256_tilings_cover_admitted_pairs(kind, causal, s):
    """``tile_schedule`` at the D = 256 tilings, K1's and K2a's 32-key tiles
    (block and warpgroup rows) and K2b's 64-key blocks: every admitted
    (query, key) pair lies in a visited tile."""
    assert (tfa.fwd_block_kv(256), tfa.bwd_dkv_block_kv(256)) == (32, 64)
    assert (tfa.fwd_block_kv(128), tfa.bwd_dkv_block_kv(128)) == (64, 128)
    seg = _schedule_ids(kind, 2, s, seed=s)
    for block_q, block_kv in ((tfa.FWD_BLOCK_Q, tfa.fwd_block_kv(256)),
                              (tfa.FWD_WARPGROUP_ROWS, tfa.fwd_block_kv(256)),
                              (tfa.BWD_DKV_BLOCK_Q, tfa.bwd_dkv_block_kv(256))):
        _assert_covers(seg, causal, s, s, block_q, block_kv)


# -- models ------------------------------------------------------------------

# 2 layers, vocab 512, 2 query heads on 1 KV head at D = 256, f32.
TINY_256 = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=2, num_kv_heads=1, head_dim=256, max_seq_len=256,
                dtype="float32", param_dtype="float32", attention_impl="flash")
PROMPTS = ["hello world", "the quick brown fox jumps", "a",
           "some longer prompt with more text to cross pages"]


def _greedy_pair(over: dict, max_new: int):
    """Greedy tokens of the JAX and the port's paged continuous engines on
    the same weights (the JAX init, carried across by ``params_from_jax``)."""
    jcfg, cfg = JModelConfig(**over), ModelConfig(**over)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.device_get(params), cfg, "cpu")
    kw = dict(n_slots=3, decode_chunk=4, page_size=16)
    jeng = JEngine(params, jcfg, JByteTokenizer(), cache_mode="paged",
                   gen=JGenerateConfig(max_new_tokens=max_new), **kw)
    teng = ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged",
                            gen=GenerateConfig(max_new_tokens=max_new), device="cpu", **kw)
    assert teng.cache["kp"].shape[-1] == cfg.head_dim
    return jeng.generate(PROMPTS), teng.generate(PROMPTS)


def test_head_dim_256_paged_engine_greedy_matches_jax():
    want, got = _greedy_pair(TINY_256, 12)
    assert got == want


def test_tiny_llama_paged_engine_greedy_matches_jax():
    """``tiny-llama`` (the default ModelConfig: D = 32, 8 query on 4 KV heads,
    hidden 256, 4 layers, vocab 32000) in f32, as the README's quick start
    serves it on the paged engine."""
    assert (ModelConfig().name, ModelConfig().head_dim) == ("tiny-llama", 32)
    want, got = _greedy_pair(dict(dtype="float32", param_dtype="float32"), 8)
    assert got == want


def test_head_dim_256_train_step_with_flash_matches_jax():
    """One train step (adafactor, full remat, the fused loss) of the D = 256
    model with ``attention_impl=flash`` against the JAX package's
    ``make_train_step`` on a one-device mesh, its flash attention through
    the Pallas kernels in interpret mode (S = 128): loss, grad norm and
    every updated parameter leaf."""
    over = dict(TINY_256, remat="full", loss_impl="fused", loss_block_tokens=96)
    jcfg, cfg = JModelConfig(**over), ModelConfig(**over)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5, grad_accum_steps=1,
              optimizer="adafactor")
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    params = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    batch = _batch(0, b=2)
    gb = make_global_batch(mesh, batch)
    with mesh:
        jparams = jax.tree.map(jnp.asarray, params)
        tx = jstate.make_optimizer(jtcfg, jparams)
        jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                                opt_state=tx.init(jparams))
        jst, jm = jstep.make_train_step(jcfg, jtcfg, mesh, gb)(jst, gb)
    tparams = train_params_from_jax(params, cfg, "cpu")
    opt = tstate.make_optimizer(tcfg, tparams)
    st = tstate.TrainState.create(tparams, opt)
    tfa.reset_launches()
    m = tstep.train_step(st, {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, cfg,
                         opt, tcfg.grad_accum_steps)
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == (0, 0, 0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _assert_trees_close(params_to_numpy(st.params), jax.device_get(jst.params), 1e-3,
                        floor=1e-3, outliers=1e-3, outlier_atol=3 * kw["learning_rate"])
