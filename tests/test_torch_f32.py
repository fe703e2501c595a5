"""f32 serving and f32 training through the attention kernels, on the CPU.

The JAX package's flash and paged kernels take any float dtype and sum in
f32, so it serves and trains with ``model.dtype=float32`` through them. The
port routes f32 operands on the card to its f32 kernels (K1-f32, K2a-f32,
K2b-f32 in ``csrc/flash_f32.cu``; K3-f32, its verify and K4-f32 in
``csrc/paged_attention_f32.cu``). Here, without a card, the wrappers run
their plain versions; what this file holds:

- the route from (dtype, head_dim) to the flash kernels' entry points, from
  (dtype, int8 pools, verify, tail) to the paged kernels' ones, and from the
  dtype to the MLP and projection backward's (K5a, K5b, K6; f32 in
  ``csrc/gemm_f32.cu``): which entry point each case takes, and which cases
  raise naming ROADMAP.md §2; operands of mixed dtypes raise before any
  launch; the f32 kernels' split rule for a weight gradient;
- a Qwen2-layout config (q/k/v biases, tied embeddings, 14 query / 2 KV
  heads so G = 7, head_dim 64, 2 layers) in f32 with
  ``attention_impl="flash"``: its parameters round-trip through the
  converter bit for bit, three train steps equal the JAX package's through
  its Pallas kernels in interpret mode (loss, grad norm, updated
  parameters), also under the reference's kernel flags (``fused_gate_up``,
  ``mlp_bwd_impl`` and ``proj_bwd_impl="pallas"``, its K5/K6 in interpret
  mode), and greedy tokens of both engines, and of the server built with
  ``--override dtype=float32``, equal the JAX package's; ``qwen2-0.5b``'s
  widths take K5/K6 in both packages only with path 10's block fields.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are ``tests/test_torch_train.py``'s for f32: 1e-5 relative on
the loss, 1e-4 on the grad norm, 1e-3 of each leaf's largest value on the
parameters after three steps (the same arithmetic summed in other orders,
with that file's two stated exceptions for near-zero leaves and elements).
Greedy tokens must be identical (f32 compute).
"""

import threading

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
from ditl_tpu.infer.engine import Generator as JGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.models.presets import get_preset as jget_preset  # noqa: E402
from ditl_tpu.ops import mlp as jmlp  # noqa: E402
from ditl_tpu.ops import projection as jproj  # noqa: E402
from ditl_tpu.runtime.mesh import build_mesh  # noqa: E402
from ditl_tpu.train import state as jstate  # noqa: E402
from ditl_tpu.train import step as jstep  # noqa: E402
from ditl_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer import server as tserver  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    params_to_numpy,
    train_params_from_jax,
)
from ditl_tpu_torch.models.presets import get_preset  # noqa: E402
from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from ditl_tpu_torch.ops import mlp as tmlp  # noqa: E402
from ditl_tpu_torch.ops import mlp_bwd as tmb  # noqa: E402
from ditl_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from ditl_tpu_torch.ops import projection as tproj  # noqa: E402
from ditl_tpu_torch.train import state as tstate  # noqa: E402
from ditl_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_train import _assert_trees_close, _batch, _leaves  # noqa: E402

torch.set_num_threads(1)

# qwen2-0.5b's layout (models/presets.py) at a tiny width and depth: q/k/v
# biases, tied embeddings, 14 query / 2 KV heads (G = 7), head_dim 64, its
# rope theta and norm epsilon; f32 compute and masters, flash attention.
QWEN2_TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                  num_heads=14, num_kv_heads=2, head_dim=64, max_seq_len=256,
                  rope_theta=1000000.0, rms_norm_eps=1e-6, attention_bias=True,
                  tie_embeddings=True, dtype="float32", param_dtype="float32",
                  attention_impl="flash")


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------

_FLASH_BF16 = ("flash_fwd.cu", "flash_bwd.cu", "_bf16")
_FLASH_F16 = ("flash_fwd.cu", "flash_bwd.cu", "_f16")
_FLASH_F32 = ("flash_f32.cu", "flash_f32.cu", "_f32")
# (dtype, head_dim) -> (forward source, backward source or the text its
# raise carries, symbol suffix), or the text every kind's raise carries.
FLASH_ROUTES = {
    ("bfloat16", 32): _FLASH_BF16, ("bfloat16", 64): _FLASH_BF16,
    ("bfloat16", 128): _FLASH_BF16, ("bfloat16", 256): _FLASH_BF16,
    ("float32", 32): "head_dim 32.*ROADMAP.md §2", ("float32", 64): _FLASH_F32,
    ("float32", 128): _FLASH_F32, ("float32", 256): _FLASH_F32,
    ("float16", 32): _FLASH_F16, ("float16", 64): _FLASH_F16,
    ("float16", 128): _FLASH_F16, ("float16", 256): _FLASH_F16,
}


@pytest.mark.parametrize("dtype,head_dim", sorted(FLASH_ROUTES))
def test_flash_kernel_route(dtype, head_dim):
    """``kernel_route``: bf16 at D in {32, 64, 128, 256} keeps the bf16
    kernels, float16 at the same D takes ``ditl_flash_fwd_f16`` and
    ``ditl_flash_bwd_{dq,dkv}_f16`` (the same sources' float16 instances),
    f32 at D in {64, 128, 256} (the reference's own head dims) takes
    ``ditl_flash_*_f32``; f32 at D = 32 raises for every kind, naming
    ROADMAP.md §2."""
    dt = getattr(torch, dtype)
    want = FLASH_ROUTES[(dtype, head_dim)]
    if isinstance(want, str):
        for kind in ("fwd", "dq", "dkv"):
            with pytest.raises(NotImplementedError, match=want):
                tfa.kernel_route(dt, head_dim, kind)
        return
    fwd_src, bwd, suffix = want
    assert tfa.kernel_route(dt, head_dim) == tfa.kernel_route(dt, head_dim, "fwd") == (
        fwd_src, "ditl_flash_fwd" + suffix)
    for kind in ("dq", "dkv"):
        if bwd.endswith(".cu"):
            assert tfa.kernel_route(dt, head_dim, kind) == (bwd, f"ditl_flash_bwd_{kind}{suffix}")
        else:
            with pytest.raises(NotImplementedError, match=bwd):
                tfa.kernel_route(dt, head_dim, kind)


# (dtype, int8 pools, form) -> entry point or the text the raise carries.
PAGED_ROUTES = {
    ("bfloat16", False, "tail"): "ditl_paged_tail_bf16",
    ("bfloat16", False, "verify"): "ditl_paged_verify_bf16",
    ("bfloat16", False, "no_tail"): "ditl_paged_bf16",
    ("bfloat16", True, "tail"): "ditl_paged_tail_i8",
    ("bfloat16", True, "verify"): "ditl_paged_verify_i8",
    ("float32", False, "tail"): "ditl_paged_tail_f32",
    ("float32", False, "verify"): "ditl_paged_verify_f32",
    ("float32", False, "no_tail"): "ditl_paged_f32",
    ("float32", True, "tail"): "ditl_paged_tail_i8_f32",
    ("float32", True, "verify"): "ditl_paged_verify_i8_f32",
    ("float16", False, "tail"): "ditl_paged_tail_f16",
    ("float16", False, "verify"): "ditl_paged_verify_f16",
    ("float16", False, "no_tail"): "ditl_paged_f16",
    ("float16", True, "tail"): "ditl_paged_tail_i8_f16",
    ("float16", True, "verify"): "ditl_paged_verify_i8_f16",
    ("float64", False, "tail"): "float64.*ROADMAP.md §2",
}


@pytest.mark.parametrize("dtype,int8,form", sorted(PAGED_ROUTES))
def test_paged_kernel_route(dtype, int8, form):
    """``kernel_route``: bf16 and float16 q over pools of their dtype or int8
    take ``csrc/paged_attention.cu``'s entry points (``_bf16``/``_i8``,
    ``_f16``/``_i8_f16``), f32 q over f32 or int8 pools (variant F)
    ``csrc/paged_attention_f32.cu``'s (``_f32``/``_i8_f32``), at every head
    dim of ``HEAD_DIMS`` (each multiple of 16 up to 256: 48 and 96 among
    them); each has its argument count, counter and source; another dtype,
    or another head dim (40, 272), raises naming ROADMAP.md §2."""
    want = PAGED_ROUTES[(dtype, int8, form)]
    kw = dict(int8=int8, verify=form == "verify", tail=form != "no_tail")
    dt = getattr(torch, dtype)
    if not want.startswith("ditl_"):
        with pytest.raises(NotImplementedError, match=want):
            tpa.kernel_route(dt, 128, **kw)
        return
    assert tpa.HEAD_DIMS == tuple(range(16, 257, 16))
    assert 48 in tpa.HEAD_DIMS and 96 in tpa.HEAD_DIMS
    for head_dim in tpa.HEAD_DIMS:
        assert tpa.kernel_route(dt, head_dim, **kw) == want
    for head_dim in (40, 272):
        with pytest.raises(NotImplementedError, match=f"head_dim {head_dim}.*ROADMAP.md §2"):
            tpa.kernel_route(dt, head_dim, **kw)
    assert want in tpa._ARGS and want in tpa._COUNTERS
    assert tpa._SOURCES[want] == ("paged_attention_f32.cu" if dtype == "float32"
                                  else "paged_attention.cu")


def test_f32_kernels_live_in_their_own_sources():
    """The f32 kernels are separate sources, so the bf16 and int8 builds'
    source hashes, and the bits their digests pin, stay as they were: no
    f32 entry point in the bf16 sources, and no shared header added."""
    from ditl_tpu_torch.ops.cuda_build import CSRC

    assert sorted(p.name for p in CSRC.glob("*.cuh")) == ["gemm_sm90.cuh", "hopper.cuh"]
    for name in ("flash_fwd.cu", "flash_bwd.cu", "paged_attention.cu"):
        assert "_f32(" not in (CSRC / name).read_text()
    for src, syms in (("flash_f32.cu", ["ditl_flash_fwd_f32", "ditl_flash_bwd_dq_f32",
                                         "ditl_flash_bwd_dkv_f32"]),
                      ("paged_attention_f32.cu", ["ditl_paged_tail_f32", "ditl_paged_f32",
                                                  "ditl_paged_verify_f32",
                                                  "ditl_paged_tail_i8_f32",
                                                  "ditl_paged_verify_i8_f32"])):
        text = (CSRC / src).read_text()
        assert all(f'extern "C" int {s}(' in text for s in syms), src


# dtype -> (K5 source, K6 source, symbol suffix) or the text the raise carries.
MM_ROUTES = {
    "bfloat16": ("mlp_bwd.cu", "projection_bwd.cu", "_bf16"),
    "float32": ("gemm_f32.cu", "gemm_f32.cu", "_f32"),
    "float16": ("mlp_bwd.cu", "projection_bwd.cu", "_f16"),
    "float64": "float64.*ROADMAP.md §2",
}


@pytest.mark.parametrize("dtype", sorted(MM_ROUTES))
def test_mlp_and_projection_kernel_route(dtype):
    """``mlp_bwd.kernel_route`` and ``projection.kernel_route``: bf16 keeps
    the bf16 kernels, float16 takes their float16 instances
    (``ditl_mlp_bwd_*_f16``, ``ditl_proj_bwd_f16`` in the same sources), f32
    takes ``ditl_mlp_bwd_*_f32`` and ``ditl_proj_bwd_f32``
    (csrc/gemm_f32.cu); another dtype (float64) raises naming ROADMAP.md
    §2."""
    want = MM_ROUTES[dtype]
    if isinstance(want, str):
        for route in (tmb.kernel_route, tproj.kernel_route):
            with pytest.raises(NotImplementedError, match=want):
                route(getattr(torch, dtype))
        return
    k5, k6, sfx = want
    assert tmb.kernel_route(getattr(torch, dtype)) == (
        k5, "ditl_mlp_bwd_dgu_dwdown" + sfx, "ditl_mlp_bwd_dh_dwgu" + sfx)
    assert tproj.kernel_route(getattr(torch, dtype)) == (k6, "ditl_proj_bwd" + sfx)


def _mm_operands(kind):
    """Operands of K5a, K5b and K6 (N = 64, D = F = 128) in f32 with one of
    them bf16 (``"mixed"``), or all float16 or all float64."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    h, g, w = t(64, 128), t(64, 128), t(128, 128)
    gate, up = t(64, 256).chunk(2, dim=-1)
    w_gu, dgu = t(128, 256), t(64, 256)
    calls = {"dgu_dwdown": (tmb.dgu_dwdown, [g, w, gate, up]),
             "dh_dwgu": (tmb.dh_dwgu, [h, dgu, w_gu]),
             "proj_bwd_rows": (tproj.proj_bwd_rows, [h, w, g])}
    for fn, args in calls.values():
        if kind == "mixed":
            args[-1] = args[-1].bfloat16()
        else:
            args[:] = [a.to(getattr(torch, kind)) for a in args]
    return calls


@pytest.mark.parametrize("kind,error,match", [
    ("mixed", ValueError, "one dtype"), ("float16", ValueError, "CUDA tensors"),
    ("float64", NotImplementedError, "ROADMAP.md §2")])
@pytest.mark.parametrize("wrapper", ["dgu_dwdown", "dh_dwgu", "proj_bwd_rows"])
def test_mlp_and_projection_kernels_check_dtypes_before_anything(wrapper, kind, error,
                                                                 match):
    """The CUDA wrappers of K5a, K5b and K6 check their operands' dtypes
    first: mixed dtypes raise ``ValueError``, float64 (not ported)
    ``NotImplementedError`` naming ROADMAP.md, before the device check and
    before any library is built or launched (so here, on CPU tensors, too);
    float16, which has kernels, passes the dtype check and is refused at the
    device check, here on CPU tensors, before anything launches."""
    fn, args = _mm_operands(kind)[wrapper]
    tmb.reset_launches()
    tproj.reset_launches()
    with pytest.raises(error, match=match):
        fn(*args)
    assert (tmb.launches_dgu, tmb.launches_dh, tmb.launches_dgu_f16, tmb.launches_dh_f16,
            tmb.launches_dgu_f32, tmb.launches_dh_f32, tproj.launches, tproj.launches_f16,
            tproj.launches_f32) == (0,) * 9


def test_f32_mm_kernels_live_in_their_own_source():
    """K5a-f32, K5b-f32 and K6-f32 are csrc/gemm_f32.cu's, which includes no
    header of the repo (the build hash covers csrc/*.cuh, so a new header
    would rebuild every bf16 library); no bf16 source names them."""
    from ditl_tpu_torch.ops.cuda_build import CSRC

    text = (CSRC / "gemm_f32.cu").read_text()
    syms = ["ditl_mlp_bwd_dgu_dwdown_f32", "ditl_mlp_bwd_dh_dwgu_f32", "ditl_proj_bwd_f32"]
    assert all(f'extern "C" int {s}(' in text for s in syms)
    assert '#include "' not in text
    for name in ("mlp_bwd.cu", "projection_bwd.cu", "gemm_sm90.cuh"):
        other = (CSRC / name).read_text()
        assert not any(s in other for s in syms) and "_f32" not in other, name


# (M, N, K) of weight gradients: path 10's d_w_down, d_w_gu, wq/wo's and
# wk/wv's dw, the card tests' ragged shapes (K6-f32's dw at N = 2000 with F
# = 640, 600 and 36, and at F = 4096 over 512 tokens), the least N, and a K
# that is no multiple of the stage depth.
SPLIT_SHAPES = [(4864, 896, 8192), (896, 9728, 8192), (896, 896, 8192), (896, 128, 8192),
                (384, 384, 2064), (256, 384, 2064), (384, 384, 16), (128, 128, 1000),
                (384, 640, 2000), (384, 600, 2000), (384, 36, 2000), (256, 4096, 512)]


@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES)
def test_f32_weight_splits_cover_the_tokens_once(m, n, k):
    """``f32_weight_splits``: the wanted count is what brings the tiles to
    the card's SMs, at most F32_MAX_SPLITS; each split is the least multiple
    of F32_BLOCK_K that takes the contraction in that many, so the splits
    cover it exactly once (the last one the rest, none empty) and are no
    more than wanted; one split of the whole K when the tiles alone fill
    the card."""
    splits, chunk = tmb.f32_weight_splits(m, n, k)
    tiles = -(-m // tmb.F32_BLOCK) * -(-n // tmb.F32_BLOCK)
    want = min(tmb.F32_MAX_SPLITS, max(1, -(-tmb.CARD_SMS // tiles)))
    least = -(-(-(-k // want)) // tmb.F32_BLOCK_K) * tmb.F32_BLOCK_K
    if splits == 1:
        assert chunk == k and least >= k
        return
    assert chunk == least and 1 < splits <= want
    assert chunk * (splits - 1) < k <= chunk * splits


@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES + [(896, 896, 4096), (896, 128, 16384)])
def test_f32_proj_splits_cover_the_tokens_once(m, n, k):
    """``f32_proj_splits`` (K6-f32's dw, D = M by F = N over K tokens, its
    grid shared with dx's (K / 128) x (D / 128) tiles): the least count, at
    most F32_MAX_SPLITS, whose splits are no deeper in k-tiles than the dx
    blocks' work a CARD_SMS share (each dx block its F / 32 k-tiles plus
    F32_BLOCK_FIXED_K); each split the least multiple of F32_BLOCK_K that
    takes the tokens in that many, so the splits cover them once, in order,
    none empty. Path 10: 3 splits at wq/wo, 8 at wk/wv, and the same at
    half and twice its tokens (the count follows D and F, not N)."""
    splits, chunk = tmb.f32_proj_splits(k, m, n)
    dx_work = -(-k // 128) * -(-m // 128) * (-(-n // 32) + tmb.F32_BLOCK_FIXED_K)
    depth = {s: -(-(-(-k // s)) // 32) for s in range(1, tmb.F32_MAX_SPLITS + 1)}
    want = min([s for s, kt in depth.items() if kt * tmb.CARD_SMS <= dx_work]
               or [tmb.F32_MAX_SPLITS])
    assert splits <= want
    if splits == 1:
        assert chunk == k
    else:
        assert chunk == depth[want] * tmb.F32_BLOCK_K
        assert chunk * (splits - 1) < k <= chunk * splits
    assert tmb.f32_proj_splits(8192, 896, 896) == (3, 2752)
    assert tmb.f32_proj_splits(8192, 896, 128) == (8, 1024)
    assert [tmb.f32_proj_splits(t, 896, f)[0] for t in (4096, 16384)
            for f in (896, 128)] == [3, 8, 3, 8]


@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES + [(1408, 1536, 512), (4864, 896, 2000)])
def test_f32_dwdown_splits_cover_the_tokens_once(m, n, k):
    """``f32_dwdown_splits`` (K5a-f32's d_w_down): a grid under CARD_SMS
    tiles takes ``f32_weight_splits``' split; a larger one the count up to
    F32_DWDOWN_MAX_SPLITS that wastes least of its last wave (path 10's 266
    tiles: four splits of 2048 tokens; 132 tiles, one whole wave: none).
    The splits cover the tokens once, in order, none empty, each but the
    last a multiple of F32_BLOCK_K deep."""
    splits, chunk = tmb.f32_dwdown_splits(m, n, k)
    tiles = -(-m // tmb.F32_BLOCK) * -(-n // tmb.F32_BLOCK)
    if tiles < tmb.CARD_SMS:
        assert (splits, chunk) == tmb.f32_weight_splits(m, n, k)
    else:
        counts = range(1, tmb.F32_DWDOWN_MAX_SPLITS + 1)
        waves = {s: -(-s * tiles // tmb.CARD_SMS) / s for s in counts}
        want = min(s for s in counts if waves[s] == min(waves.values()))
        assert splits <= want
    if splits == 1:
        assert chunk == k
    else:
        assert chunk % tmb.F32_BLOCK_K == 0
        bounds = [(i * chunk, min(k, (i + 1) * chunk)) for i in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        assert all(a < b for a, b in bounds)
        assert all(x[1] == y[0] for x, y in zip(bounds, bounds[1:]))
    assert tmb.f32_dwdown_splits(4864, 896, 8192) == (4, 2048)
    assert tmb.f32_dwdown_splits(1408, 1536, 512) == (1, 512)


# ---------------------------------------------------------------------------
# The Qwen2-layout config in f32
# ---------------------------------------------------------------------------


def _configs(**kw):
    over = dict(QWEN2_TINY, **kw)
    return JModelConfig(**over), ModelConfig(**over)


def _jax_params(jcfg, seed=0):
    """JAX init, with random norm scales and q/k/v biases so their
    gradients matter."""
    params = jax.device_get(jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    layers = params["layers"]
    for group in ("attn_norm", "mlp_norm"):
        s = layers[group]["scale"]
        layers[group]["scale"] = (1 + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
    for key in ("bq", "bk", "bv"):
        b = layers["attn"][key]
        layers["attn"][key] = (0.1 * rng.standard_normal(b.shape)).astype(b.dtype)
    return params


def test_qwen2_layout_round_trips_in_f32():
    """The converter carries the Qwen2 layout's f32 parameters (biases,
    tied embeddings, no lm head) across and back bit for bit, as training
    masters and as the serving tree, whose tied head is the embedding's
    transpose."""
    jcfg, cfg = _configs()
    params = _jax_params(jcfg)
    assert "bq" in params["layers"]["attn"] and "lm_head" not in params
    want = dict(_leaves(params))
    serving = dict(_leaves(params_to_numpy(params_from_jax(params, cfg, "cpu"))))
    assert np.array_equal(serving.pop(("lm_head", "kernel")),
                          want[("embed", "embedding")].T)
    for back in (serving, dict(_leaves(params_to_numpy(
            train_params_from_jax(params, cfg, "cpu"))))):
        assert back.keys() == want.keys()
        for path, x in want.items():
            assert back[path].dtype == np.float32 and np.array_equal(back[path], x), path


# (model overrides, train overrides): path 9's training configuration (full
# remat, adafactor, the fused loss, MLP and projection backward at the "xla"
# defaults), path 10's (the same under the reference's kernel flags, with
# blocks that tile this config: D = 128, F = 256, wq 128 x 896, wk/wv 128 x
# 128, wo 896 x 128, N = 256), and adamw without remat under the naive loss.
_PATH9 = dict(remat="full", loss_impl="fused", loss_block_tokens=96)
KERNEL_FLAGS = dict(fused_gate_up=True, mlp_bwd_impl="pallas", proj_bwd_impl="pallas",
                    mlp_bwd_block_n=32, mlp_bwd_block_f=128, mlp_bwd_block_d=128,
                    proj_bwd_block_n=32, proj_bwd_block_d=128)
STEP_CASES = {
    "remat_full-adafactor-fused": (_PATH9, dict(optimizer="adafactor")),
    "remat_full-adafactor-fused-kernel_flags": (dict(_PATH9, **KERNEL_FLAGS),
                                                dict(optimizer="adafactor")),
    "remat_none-adamw-naive": (dict(remat="none"), dict(optimizer="adamw")),
}


def _bwd_impls(jcfg, cfg, b, s):
    """The MLP and attention projections' backward each package takes for
    these configs at (B, S): {(package, product): impl}."""
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    out = {}
    for name, c, mlp, proj in (("jax", jcfg, jmlp, jproj), ("torch", cfg, tmlp, tproj)):
        mb = (c.mlp_bwd_block_n, c.mlp_bwd_block_f, c.mlp_bwd_block_d)
        pb = (c.proj_bwd_block_n, c.proj_bwd_block_d)
        out[(name, "mlp")] = mlp.effective_bwd_impl(c.mlp_bwd_impl, b, s, d, f, mb)
        for w, d_in, d_out in (("wq", d, c.num_heads * hd), ("wk/wv", d, c.num_kv_heads * hd),
                               ("wo", c.num_heads * hd, d)):
            out[(name, w)] = proj.effective_bwd_impl(c.proj_bwd_impl, b, s, d_in, d_out, pb)
    return out


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_qwen2_f32_train_steps_match_jax(case):
    """Three f32 train steps of the Qwen2-layout config against the JAX
    package's ``make_train_step`` on a one-device mesh, its flash attention
    (and under the kernel flags its MLP and projection backward) through the
    Pallas kernels in interpret mode: loss, grad norm and every updated
    parameter leaf after each step. Both packages take the backward the
    case's flags name, for the MLP and every projection."""
    model_kw, train_kw = STEP_CASES[case]
    jcfg, cfg = _configs(**model_kw)
    impls = _bwd_impls(jcfg, cfg, 2, 128)
    assert set(impls.values()) == {cfg.mlp_bwd_impl} == {cfg.proj_bwd_impl}, impls
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5, grad_accum_steps=1,
              **train_kw)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    params = _jax_params(jcfg)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    batches = [_batch(seed, b=2) for seed in range(3)]
    gb = [make_global_batch(mesh, b) for b in batches]
    with mesh:
        jparams = jax.tree.map(jnp.asarray, params)
        tx = jstate.make_optimizer(jtcfg, jparams)
        jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                                opt_state=tx.init(jparams))
        jtrain = jstep.make_train_step(jcfg, jtcfg, mesh, gb[0])
    tparams = train_params_from_jax(params, cfg, "cpu")
    opt = tstate.make_optimizer(tcfg, tparams)
    st = tstate.TrainState.create(tparams, opt)
    for i in range(3):
        with mesh:
            jst, jm = jtrain(jst, gb[i])
        batch = {k: torch.from_numpy(v.copy()) for k, v in batches[i].items()}
        m = tstep.train_step(st, batch, cfg, opt, tcfg.grad_accum_steps)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        _assert_trees_close(params_to_numpy(st.params), jax.device_get(jst.params), 1e-3,
                            floor=1e-3, outliers=1e-3, outlier_atol=3 * kw["learning_rate"])
    assert st.step == 3


def test_qwen2_05b_takes_the_kernels_only_with_path_10_blocks():
    """``qwen2-0.5b`` at B=4, S=2048 (D = 896, F = 4864) under the kernel
    flags: with path 10's block fields (``mlp_bwd_block_f=256``,
    ``proj_bwd_block_d=128``) both packages take K5/K6 for the MLP and every
    projection; with the default blocks both take the einsum backward
    (4864 % 512 and 896 % 256 are not 0)."""
    flags = dict(fused_gate_up=True, mlp_bwd_impl="pallas", proj_bwd_impl="pallas")
    blocks = dict(mlp_bwd_block_f=256, proj_bwd_block_d=128)
    for extra, want in ((blocks, "pallas"), ({}, "xla")):
        jcfg = jget_preset("qwen2-0.5b", **flags, **extra)
        cfg = get_preset("qwen2-0.5b", **flags, **extra)
        assert (cfg.hidden_size, cfg.intermediate_size) == (896, 4864)
        impls = _bwd_impls(jcfg, cfg, 4, 2048)
        assert len(impls) == 8 and set(impls.values()) == {want}, (extra, impls)


PROMPTS = ["hello world", "the quick brown fox jumps", "a",
           "some longer prompt with more text to cross pages"]


@pytest.fixture(scope="module")
def qwen2_pair():
    jcfg, cfg = _configs()
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jcfg, params, cfg, params_from_jax(jax.device_get(params), cfg, "cpu")


def _jax_greedy(jcfg, params, prompts, max_new):
    tok = JByteTokenizer()
    out = JGenerator(params, jcfg, tok).generate_tokens(
        [[tok.bos_id] + tok.encode(p) for p in prompts], JGenerateConfig(max_new_tokens=max_new))
    return [tok.decode(t) for t in out]


def test_qwen2_f32_lockstep_greedy_matches_jax(qwen2_pair):
    """The lock-step ``Generator`` (flash prefill, then the cache's decode)
    in f32 gives the JAX Generator's greedy tokens."""
    jcfg, params, cfg, tparams = qwen2_pair
    tok = ByteTokenizer()
    out = Generator(tparams, cfg, tok, device="cpu").generate_tokens(
        [[tok.bos_id] + tok.encode(p) for p in PROMPTS], GenerateConfig(max_new_tokens=16))
    assert [tok.decode(t) for t in out] == _jax_greedy(jcfg, params, PROMPTS, 16)


def test_qwen2_f32_continuous_greedy_matches_jax(qwen2_pair):
    """The continuous engine over f32 page pools (flash prefill, paged decode
    through ``paged_attention``) gives the JAX paged engine's greedy tokens,
    and the JAX Generator's."""
    jcfg, params, cfg, tparams = qwen2_pair
    kw = dict(n_slots=3, decode_chunk=4, page_size=16)
    jeng = JEngine(params, jcfg, JByteTokenizer(), cache_mode="paged",
                   gen=JGenerateConfig(max_new_tokens=16), **kw)
    teng = ContinuousEngine(tparams, cfg, ByteTokenizer(), cache_mode="paged",
                            gen=GenerateConfig(max_new_tokens=16), device="cpu", **kw)
    assert teng.cache["kp"].dtype == torch.float32
    ref = jeng.generate(PROMPTS)
    assert teng.generate(PROMPTS) == ref
    assert ref == _jax_greedy(jcfg, params, PROMPTS, 16)


def test_cli_serves_f32_on_both_engines():
    """``infer/server.py --override dtype=float32 --override
    attention_impl=flash --engine continuous``: f32 weights and f32 pools
    (``kv_cache_dtype`` "" is the compute dtype); a greedy completion through
    the continuous engine and a logprob request through the lock-step
    Generator both give the JAX Generator's greedy text over the server's
    own weights."""
    import json
    import urllib.request

    overrides = [x for k, v in QWEN2_TINY.items() for x in ("--override", f"{k}={v}")]
    srv = tserver.create_server(["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                                 *overrides, "--engine", "continuous", "--cache-mode",
                                 "paged", "--page-size", "16", "--slots", "2"])
    gen = srv.RequestHandlerClass.generator
    engine = srv.engine._engine
    assert gen.cfg.dtype == "float32" and gen.cfg.attention_impl == "flash"
    assert gen.params["layers"]["attn"]["wq"].dtype == torch.float32
    assert engine.cache["kp"].dtype == torch.float32
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(gen.params))
    prompt = "The quick brown fox"
    want = _jax_greedy(JModelConfig(**QWEN2_TINY), jparams, [prompt], 10)[0]
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


# -- K2b-f32's split (f32_dkv_splits) ------------------------------------------

# (batch, kv_heads, groups, s_q, s_kv, head_dim): path 15's packed row (D =
# 256, 8 on 1), path 9's batch (G = 7 on 2), G = 7 on one KV head (9 runs),
# the serving prefill (G = 4 on 8), MQA and ragged lengths at D = 256 and
# 128, Sq != Skv, G = 16 (path 16's heads), a grid that fills the card.
SPLIT_SHAPES = [
    (1, 1, 8, 2048, 2048, 256),
    (4, 2, 7, 2048, 2048, 64),
    (1, 1, 7, 2048, 2048, 64),
    (4, 8, 4, 512, 512, 128),
    (2, 2, 1, 300, 300, 256),
    (1, 1, 1, 129, 129, 128),
    (2, 4, 1, 200, 333, 256),
    (1, 8, 16, 512, 512, 128),
    (8, 8, 4, 2048, 2048, 128),
]


@pytest.mark.parametrize("sms", [132, 114, 78, 16])
@pytest.mark.parametrize("b,kv,g,s_q,s_kv,d", SPLIT_SHAPES)
def test_f32_dkv_runs_cover_every_item_once_in_order(b, kv, g, s_q, s_kv, d, sms):
    """K2b-f32's runs: every (group head, query tile) item of a KV head
    exactly once, in the folded order, no run empty, at most
    F32_DKV_MAX_SPLITS; the kernel's own check on (splits, chunk) holds; a
    grid of two waves or more is not split, a smaller one is split toward two
    waves; the same shapes and SM count give the same split."""
    block = tfa.f32_bwd_block(d)
    splits, chunk = tfa.f32_dkv_splits(b, kv, g, s_q, s_kv, d, sms)
    assert (splits, chunk) == tfa.f32_dkv_splits(b, kv, g, s_q, s_kv, d, sms)
    n_q = -(-s_q // block)
    items = g * n_q
    runs = tfa.f32_dkv_runs(splits, chunk, g, n_q)
    assert [item for run in runs for item in run] == [(h, t) for h in range(g)
                                                      for t in range(n_q)]
    assert all(runs) and 1 <= splits <= tfa.F32_DKV_MAX_SPLITS
    assert chunk * (splits - 1) < items <= chunk * splits
    blocks = kv * b * -(-s_kv // block)
    want = min(tfa.F32_DKV_MAX_SPLITS, items, -(-2 * sms // blocks))
    if blocks >= 2 * sms:
        assert (splits, chunk) == (1, items)
    else:
        assert splits <= want and chunk == -(-items // want)


def test_f32_dkv_split_fills_the_card_at_path_15():
    """Path 15's packed row (B = 1, S = 2048, 8 heads on 1, D = 256): 64 key
    blocks alone; 5 runs of 103 items take K2b-f32 to 320 blocks on the H100
    SXM's 132 SMs. Path 9's batch takes 2 runs (512 blocks)."""
    assert tfa.f32_bwd_block(256) == 32 and tfa.f32_bwd_block(64) == 64
    assert tfa.f32_dkv_splits(1, 1, 8, 2048, 2048, 256) == (5, 103)
    assert 5 * 2048 // 32 >= tfa.CARD_SMS
    assert tfa.f32_dkv_splits(4, 2, 7, 2048, 2048, 64) == (2, 112)
    assert tfa.f32_dkv_splits(1, 1, 7, 2048, 2048, 64) == (9, 25)
