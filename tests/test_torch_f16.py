"""float16 serving, and f32 serving over int8 pools, on the CPU against the
JAX package.

The reference's flash and paged kernels take any float dtype with f32 sums,
so it serves ``--override dtype=float16`` (with or without ``--kv-quant
int8``) and an f32 q over int8 pools through them. The port routes these
operands on the card to K1-f16, K3-f16 (its verify, K4-f16, and the
int8-pool forms) in ``csrc/flash_fwd.cu`` and ``csrc/paged_attention.cu``,
and an f32 q over int8 pools to K3-int8-f32 and its verify in
``csrc/paged_attention_f32.cu``. Here, without a card, the wrappers run
their plain versions; what this file holds:

- ``params_from_jax`` carries a float16 config's tree over: every weight in
  float16, the JAX tree's values cast to float16 bit for bit;
- ``flash_attention_plain`` in float16 against the JAX flash forward (its
  Pallas kernel in interpret mode): o within 2e-3 (a float16 ulp at 1 is
  9.8e-4; the kernel rounds p at its running max, the plain version at the
  final max, and both round o), lse within 1e-4;
- ``paged_attention_plain`` in float16 (q, tails and pools), and over int8
  pools with a float16 and with an f32 q and tails, against the JAX
  ``paged_attention`` (Pallas, interpret mode), 3-D and 4-D q: float16 at
  2e-3 (the reference rounds p to v's dtype at each block's running max),
  f32 over int8 pools at 1e-4 (the reference's own int8 tolerance,
  ``tests/test_paged.py``);
- greedy tokens of the lock-step ``Generator`` and of the paged
  ``ContinuousEngine`` with ``attention_impl="flash"`` (the JAX flash kernel
  in interpret mode) in float16, over the compute dtype's cache and over
  int8 caches, and in f32 over int8 caches, identical to the JAX package's;
  float16 prompt-lookup speculation on the continuous engine identical to
  the JAX speculative engine's;
- ``infer/server.py --override dtype=float16`` answering over HTTP on both
  engines with the JAX Generator's greedy text over the server's own
  weights.

Inputs are made with numpy from a seed and handed to both packages.
"""

import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from ditl_tpu.infer.continuous import ContinuousEngine as JEngine  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JGenerateConfig  # noqa: E402
from ditl_tpu.infer.engine import Generator as JGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.ops import flash_attention as jfa  # noqa: E402
from ditl_tpu.ops import paged_attention as jpa  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax, params_to_numpy  # noqa: E402
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from ditl_tpu_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

# A Llama-layout config at a tiny width and depth whose head_dim (64) the
# reference's flash kernel takes, float16 compute and weights, flash
# attention; "kv_cache_dtype" is set per test.
F16_TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=256,
                dtype="float16", param_dtype="float32", attention_impl="flash")
PROMPTS = ["hello world", "the quick brown fox jumps", "a",
           "some longer prompt with more text to cross pages"]
O_TOL = 2e-3  # float16 outputs (a float16 ulp at 1 is 9.8e-4)
INT8_TOL = 1e-4  # f32 over int8 pools (tests/test_paged.py's int8 tolerance)


def _configs(dtype: str = "float16", kv: str = ""):
    kw = dict(F16_TINY, dtype=dtype, kv_cache_dtype=kv)
    return JModelConfig(**kw), ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _tree():
    return jax.device_get(jllama.init_params(jax.random.key(0), _configs()[0]))


@functools.lru_cache(maxsize=None)
def _tparams(dtype: str):
    return params_from_jax(_tree(), _configs(dtype)[1], "cpu")


def test_params_from_jax_carries_a_float16_tree():
    """The serving tree of a float16 config holds the JAX f32 masters cast to
    float16 (what the reference's forward computes with), bit for bit, under
    the storage rules of ``models/llama.py::serving_params``: weights and the
    embedding in float16, norm scales in f32, the head in f32 holding
    float16 values."""
    params = _tparams("float16")
    leaves = jax.tree_util.tree_leaves_with_path(_tree())
    assert len(leaves) >= 10
    for path, leaf in leaves:
        keys = [p.key for p in path]
        node = params
        for key in keys:
            node = node[key]
        want = np.asarray(leaf, np.float32)
        if any("norm" in k for k in keys):
            assert node.dtype == torch.float32, keys
        else:
            want = want.astype(np.float16).astype(np.float32)
            assert node.dtype == (torch.float32 if keys[0] == "lm_head"
                                  else torch.float16), keys
        np.testing.assert_array_equal(node.float().numpy(), want, err_msg=str(keys))


# -- flash forward ---------------------------------------------------------------

# (b, s, h, kv, d, causal, ids): GQA at head_dim 64 and 128, causal and not,
# right-padded and packed segment ids
FLASH_CASES = {
    "causal_d64": (2, 128, 4, 2, 64, True, None),
    "packed_d128": (2, 128, 8, 2, 128, True, "packed"),
    "padded_noncausal_d64": (2, 128, 4, 4, 64, False, "padded"),
}


def _flash_case(name: str):
    b, s, h, kv, d, causal, ids = FLASH_CASES[name]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, s, h, d)).astype(np.float16)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float16)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float16)
    seg = None
    if ids == "packed":
        seg = np.repeat(np.array([[1, 2, 3, 3]], np.int32), s // 4, axis=1).repeat(b, 0)
    elif ids == "padded":
        seg = (np.arange(s)[None] < np.array([[s], [s - 37]])).astype(np.int32)
    return q, k, v, seg, causal


def _jax_flash(q, k, v, seg, causal):
    """The JAX flash forward's (o, lse) through its Pallas kernel in
    interpret mode, on the model's (B, S, H, D) layout; lse (B, H, S)."""
    s, d = q.shape[1], q.shape[3]
    blocks = jfa._pick_blocks(s, s, 512, 512)
    qt, kt, vt = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)) for x in (q, k, v))
    jseg = None if seg is None else jnp.asarray(seg)
    o, lse = jfa._fwd(qt, kt, vt, jseg, jseg, causal=causal, scale=d**-0.5, blocks=blocks,
                      interpret=True)
    lse = np.asarray(lse, np.float32)  # lane-replicated: (B, H, S, lanes)
    return np.asarray(jnp.transpose(o, (0, 2, 1, 3)), np.float32), lse[..., 0]


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_f16_matches_jax_forward(name):
    """``flash_attention_plain`` and the CPU wrapper in float16 against the
    JAX flash forward: o at ``O_TOL``, lse (f32) at 1e-4; the wrapper runs
    the plain version on CPU tensors and counts no launch."""
    q, k, v, seg, causal = _flash_case(name)
    jo, jlse = _jax_flash(q, k, v, seg, causal)
    tseg = None if seg is None else torch.from_numpy(seg)
    tfa.reset_launches()
    o, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                     causal=causal, segment_ids=tseg)
    assert (tfa.launches, tfa.launches_f16) == (0, 0)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), jo, atol=O_TOL, rtol=O_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-4, rtol=1e-4)


# -- paged decode attention -------------------------------------------------------

# name: (q's dtype, int8 pools, Q or None for a 3-D q)
PAGED_VARIANTS = {
    "f16": ("float16", False, None),
    "f16_verify": ("float16", False, 9),
    "f16_int8": ("float16", True, None),
    "f16_int8_verify": ("float16", True, 9),
    "f32_int8": ("float32", True, None),
    "f32_int8_verify": ("float32", True, 9),
}


@functools.lru_cache(maxsize=None)
def _paged_case(name: str):
    """numpy inputs of one variant: 2 KV heads, G = 4, head_dim 64, page 16,
    a 40-column tail; a dead slot, a tail-only slot, a mid-page start and a
    page-aligned start. int8 pools are quantized per position as the caches
    do (absmax over D, scale 1.0 on zero rows), scales (P, K, 1, ps)."""
    dtype, int8, nq = PAGED_VARIANTS[name]
    kv, groups, d, ps, maxp, pool, tail = 2, 4, 64, 16, 6, 32, 40
    lengths, starts = [0, 30, 50, 97], [0, 0, 45, 80]
    b = len(lengths)
    rng = np.random.default_rng(11)
    npdt = np.dtype(dtype)
    qshape = (b, kv * groups, d) if nq is None else (b, nq, kv * groups, d)
    a = {"q": rng.normal(size=qshape).astype(npdt),
         "k_pages": rng.normal(size=(pool, kv, ps, d)).astype(npdt),
         "v_pages": rng.normal(size=(pool, kv, ps, d)).astype(npdt)}
    table = np.zeros((b, maxp), np.int32)
    pid = 1
    for row in range(b):
        for i in range(-(-min(lengths[row], starts[row]) // ps)):
            table[row, i] = pid
            pid += 1
    a.update(page_table=table, lengths=np.asarray(lengths, np.int32),
             tail_k=rng.normal(size=(b, kv, tail, d)).astype(npdt),
             tail_v=rng.normal(size=(b, kv, tail, d)).astype(npdt),
             starts=np.asarray(starts, np.int32))
    if int8:
        for pool_name, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            x = a[pool_name].astype(np.float32)
            absmax = np.abs(x).max(-1)
            sc = np.where(absmax == 0, 1.0, absmax / np.float32(127)).astype(np.float32)
            a[pool_name] = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
            a[scale] = np.ascontiguousarray(sc[:, :, None, :])
    return a


POSITIONAL = ("q", "k_pages", "v_pages", "page_table", "lengths")


@pytest.mark.parametrize("name", sorted(PAGED_VARIANTS))
def test_paged_plain_matches_jax_pallas_interpret(name):
    """``paged_attention_plain``, its split twin and the CPU wrapper (which
    runs the plain version and counts no launch) against the JAX
    ``paged_attention`` (its Pallas kernel in interpret mode) on float16
    pools and over int8 pools with a float16 or f32 q, 3-D and 4-D q."""
    dtype, int8, _ = PAGED_VARIANTS[name]
    a = {k: jnp.asarray(v) for k, v in _paged_case(name).items()}
    jpos = [a.pop(k) for k in POSITIONAL]
    want = np.asarray(jpa.paged_attention(*jpos, **a, interpret=True), np.float32)
    t = {k: torch.from_numpy(v) for k, v in _paged_case(name).items()}
    pos = [t.pop(k) for k in POSITIONAL]
    tol = INT8_TOL if dtype == "float32" else O_TOL
    tpa.reset_launches()
    for out in (tpa.paged_attention(*pos, **t), tpa.paged_attention_plain(*pos, **t),
                tpa.paged_attention_split_plain(*pos, **t)):
        assert out.dtype == getattr(torch, dtype) and out.shape == pos[0].shape
        np.testing.assert_allclose(out.float().numpy(), want, atol=tol, rtol=tol)
        assert np.all(out.float().numpy()[0] == 0), "a dead slot gives zeros"
    assert sum(getattr(tpa, c) for c in tpa._COUNTERS.values()) == 0


# -- engines ----------------------------------------------------------------------

# (compute dtype, kv_cache_dtype): float16 over float16 caches and over int8
# caches, f32 over int8 caches (path 11's arithmetic)
ENGINES = [("float16", ""), ("float16", "int8"), ("float32", "int8")]


@functools.lru_cache(maxsize=None)
def _jparams():
    return jax.tree.map(jnp.asarray, _tree())


def _jax_greedy(jcfg, prompts, max_new, params=None):
    """The JAX Generator's greedy texts over ``params`` (default: the seed's
    tree)."""
    tok = JByteTokenizer()
    out = JGenerator(_jparams() if params is None else params, jcfg, tok).generate_tokens(
        [[tok.bos_id] + tok.encode(p) for p in prompts], JGenerateConfig(max_new_tokens=max_new))
    return [tok.decode(t) for t in out]


@pytest.mark.parametrize("dtype,kv", ENGINES)
def test_lockstep_greedy_matches_jax(dtype, kv):
    """The lock-step ``Generator`` (flash prefill, then the contiguous
    cache's decode, int8 or not) gives the JAX Generator's greedy tokens."""
    jcfg, cfg = _configs(dtype, kv)
    tok = ByteTokenizer()
    out = Generator(_tparams(dtype), cfg, tok, device="cpu").generate_tokens(
        [[tok.bos_id] + tok.encode(p) for p in PROMPTS], GenerateConfig(max_new_tokens=16))
    assert [tok.decode(t) for t in out] == _jax_greedy(jcfg, PROMPTS, 16)


PAGED = dict(n_slots=3, decode_chunk=4, page_size=16, cache_mode="paged")


@pytest.mark.parametrize("dtype,kv", ENGINES)
def test_continuous_greedy_matches_jax(dtype, kv):
    """The continuous engine over page pools of the compute dtype or int8
    (flash prefill, paged decode through ``paged_attention``) gives the JAX
    paged engine's greedy tokens."""
    jcfg, cfg = _configs(dtype, kv)
    jeng = JEngine(_jparams(), jcfg, JByteTokenizer(), gen=JGenerateConfig(max_new_tokens=16),
                   **PAGED)
    teng = ContinuousEngine(_tparams(dtype), cfg, ByteTokenizer(),
                            gen=GenerateConfig(max_new_tokens=16), device="cpu", **PAGED)
    assert teng.cache["kp"].dtype == (torch.int8 if kv else getattr(torch, dtype))
    assert teng.generate(PROMPTS) == jeng.generate(PROMPTS)


SPEC_PROMPTS = ["abcabcabcabcabcabc", "the cat sat on the mat the cat sat", "x",
                "hello hello hello hello"]


@pytest.mark.parametrize("kv", ["", "int8"], ids=["float16_pools", "int8_pools"])
def test_continuous_speculative_f16_greedy_matches_jax(kv):
    """float16 prompt-lookup speculation on the continuous engine, every
    tick speculative: the JAX speculative engine's greedy tokens, over
    float16 and over int8 pools (the verify is K3's multi-query form)."""
    jcfg, cfg = _configs("float16", kv)
    kw = dict(speculative=True, spec_threshold=0.0, spec_rounds=2, **PAGED)
    jeng = JEngine(_jparams(), jcfg, JByteTokenizer(), **kw)
    teng = ContinuousEngine(_tparams("float16"), cfg, ByteTokenizer(), device="cpu", **kw)
    out = teng.generate(SPEC_PROMPTS, max_new_tokens=24, temperature=0.0)
    st = teng.stats()["speculative"]
    assert st["spec_ticks"] == st["ticks"] > 0 and st["verify_rounds"] > 0
    assert out == jeng.generate(SPEC_PROMPTS, max_new_tokens=24, temperature=0.0)


def test_cli_serves_f16_on_both_engines():
    """``infer/server.py --override dtype=float16 --override
    attention_impl=flash --engine continuous``: float16 weights and float16
    pools; a greedy completion through the continuous engine and a logprob
    request through the lock-step Generator both give the JAX Generator's
    greedy text over the server's own weights."""
    overrides = [x for k, v in F16_TINY.items() if k != "param_dtype"
                 for x in ("--override", f"{k}={v}")]
    srv = tserver.create_server(["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                                 *overrides, "--engine", "continuous", "--cache-mode",
                                 "paged", "--page-size", "16", "--slots", "2"])
    gen = srv.RequestHandlerClass.generator
    engine = srv.engine._engine
    assert gen.cfg.dtype == "float16" and gen.cfg.attention_impl == "flash"
    assert gen.params["layers"]["attn"]["wq"].dtype == torch.float16
    assert engine.cache["kp"].dtype == torch.float16
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(gen.params))
    prompt = "The quick brown fox"
    want = _jax_greedy(JModelConfig(**F16_TINY), [prompt], 10, jparams)[0]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/completions"
        for extra in ({}, {"logprobs": 1}):
            req = urllib.request.Request(
                url, data=json.dumps({"prompt": prompt, "max_tokens": 10, "temperature": 0,
                                      **extra}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                body = json.loads(r.read())
            assert body["choices"][0]["text"] == want, extra
    finally:
        srv.close(drain=True)
        thread.join(timeout=10)
    assert not thread.is_alive()
