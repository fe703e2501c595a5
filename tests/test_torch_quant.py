"""Port parity for weight-only int8 (``ditl_tpu_torch/ops/quant.py``) against
the JAX package's ``ops/quant.py``, on the same numpy weights.

- ``quantize_weights``: int8 values and f32 scales bit for bit, in the
  unfused, fused and tied layouts (lm head included, the embedding and the
  norms left float).
- The product (``weight_matmul``, the counterpart of ``weight_einsum``), over
  int8 leaves and float matrices: f32 at 1e-5 (the same products, another
  summation order); bf16 at one bf16 ulp of the output's scale (both sides
  round the product to bf16, then multiply by the scale cast to bf16 and
  round again).
- The quantized forward's logits against the JAX quantized forward: f32 at
  1e-4, the forward parity tests' own tolerance.
- Greedy tokens of the port's lock-step ``Generator`` and continuous engine
  on the int8 tree identical to the JAX ``Generator`` on the same tree (the
  reference's ``tests/test_quant.py`` scenario).
- The refusals: an unmerged LoRA tree, and the three backward seams over
  quantized leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ditl_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ditl_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from ditl_tpu.infer.engine import GenerateConfig as JaxGenerateConfig  # noqa: E402
from ditl_tpu.infer.engine import Generator as JaxGenerator  # noqa: E402
from ditl_tpu.models import llama as jllama  # noqa: E402
from ditl_tpu.ops import quant as jquant  # noqa: E402
from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from ditl_tpu_torch.infer.continuous import ContinuousEngine  # noqa: E402
from ditl_tpu_torch.infer.engine import GenerateConfig, Generator  # noqa: E402
from ditl_tpu_torch.models import llama  # noqa: E402
from ditl_tpu_torch.models.convert import params_from_jax  # noqa: E402
from ditl_tpu_torch.ops import quant  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
            dtype="float32", param_dtype="float32")
LAYOUTS = {"unfused": {}, "fused": {"fused_qkv": True, "fused_gate_up": True},
           "tied": {"tie_embeddings": True}}


def _jax_tree(layout: str, seed: int = 0):
    jcfg = JaxModelConfig(**TINY, **LAYOUTS[layout])
    return jcfg, jax.device_get(jllama.init_params(jax.random.key(seed), jcfg))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantize_weights_matches_jax_bitwise(layout):
    """On the JAX tree's own f32 leaves, and on the port's serving tree of
    the same weights (the tied head is the float transposed embedding there
    and stays float)."""
    jcfg, tree = _jax_tree(layout)
    ref = _flat(jax.device_get(jquant.quantize_weights(tree)))
    torch_tree = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)
    ours = _flat(quant.quantize_weights(torch_tree))
    assert ours.keys() == ref.keys()
    for path, want in ref.items():
        got = ours[path]
        assert got.dtype == {np.dtype(np.int8): torch.int8,
                             np.dtype(np.float32): torch.float32}[want.dtype], path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    assert "/embed/embedding" in ref and "/layers/attn_norm/scale" in ref
    cfg = ModelConfig(**TINY, **LAYOUTS[layout])
    serving = quant.quantize_weights(params_from_jax(tree, cfg, "cpu"),
                                     tie_embeddings=cfg.tie_embeddings)
    head = serving["lm_head"]["kernel"]
    if cfg.tie_embeddings:
        assert not quant.is_quantized_leaf(head)
    else:
        np.testing.assert_array_equal(head["q"].numpy(), ref["/lm_head/kernel/q"])
        np.testing.assert_array_equal(head["scale"].numpy(), ref["/lm_head/kernel/scale"])
    first = next(k for k in ("wq", "w_qkv") if k in serving["layers"]["attn"])
    np.testing.assert_array_equal(serving["layers"]["attn"][first]["q"].numpy(),
                                  ref[f"/layers/attn/{first}/q"])


def test_quantize_matrix_edge_values_match_jax():
    """Zero columns (scale 1.0), halves that round to even, the clip."""
    w = np.zeros((6, 5), np.float32)
    w[:, 1] = [127, -127, 63.5, 0.5, -1.5, 2.5]
    w[:, 2] = [1e-30, -2e-30, 0, 0, 0, 0]
    w[:, 3] = np.linspace(-3, 7, 6)
    w[:, 4] = [1, 1, 1, 1, 1, -1]
    ref = jquant._quantize_matrix(jnp.asarray(w))
    ours = quant._quantize_matrix(torch.from_numpy(w))
    np.testing.assert_array_equal(ours["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(ours["scale"].numpy(), np.asarray(ref["scale"]))
    assert float(ours["scale"][0, 0]) == 1.0


@pytest.mark.parametrize("leaf", ["int8", "float"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preferred", [None, "float32"])
def test_weight_matmul_matches_weight_einsum(dtype, preferred, leaf):
    """An int8 leaf, and a float matrix (the counterpart takes both)."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(3, 32, 48)) * 0.2).astype(np.float32)
    x = rng.normal(size=(3, 4, 32)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jw = jquant._quantize_matrix(jnp.asarray(w)) if leaf == "int8" else jnp.asarray(w)
    ref = jquant.weight_einsum("lsd,ldf->lsf", jnp.asarray(x, jdt), jw, compute_dtype=jdt,
                               preferred=jnp.float32 if preferred else None)
    tw = torch.from_numpy(w)
    tw = quant._quantize_matrix(tw) if leaf == "int8" else tw
    got = quant.weight_matmul(torch.from_numpy(x).to(tdt), tw, compute_dtype=tdt,
                              preferred=torch.float32 if preferred else None)
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == (torch.float32 if preferred else tdt)
    if dtype == "float32" or preferred:
        np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-5, rtol=1e-5)
    else:
        # One bf16 ulp (2^-8 relative) of the output's scale.
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=2**-8 * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantized_forward_matches_jax(layout):
    jcfg, tree = _jax_tree(layout)
    qtree = jax.device_get(jquant.quantize_weights(tree))
    ids = np.random.default_rng(1).integers(3, 500, size=(2, 24)).astype(np.int32)
    ref = np.asarray(jllama.forward(qtree, jnp.asarray(ids), jcfg))
    cfg = ModelConfig(**TINY, **LAYOUTS[layout])
    params = params_from_jax(qtree, cfg, "cpu")
    assert params["layers"]["mlp"]["w_down"]["q"].dtype == torch.int8
    out = llama.forward(params, torch.from_numpy(ids).long(), cfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


PROMPTS = ["hello quantized", "abc", "a somewhat longer prompt for the int8 tree"]


@pytest.fixture(scope="module")
def int8_tree():
    jcfg = JaxModelConfig(**{**TINY, "max_seq_len": 256})
    tree = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    qtree = jax.device_get(jquant.quantize_weights(tree))
    ref = JaxGenerator(qtree, jcfg, JaxByteTokenizer()).generate(
        PROMPTS, JaxGenerateConfig(max_new_tokens=12))
    cfg = ModelConfig(**{**TINY, "max_seq_len": 256})
    return cfg, params_from_jax(qtree, cfg, "cpu"), ref


def test_lockstep_generator_greedy_matches_jax_on_int8_tree(int8_tree):
    cfg, params, ref = int8_tree
    tok = ByteTokenizer()
    out = Generator(params, cfg, tok, device="cpu").generate_tokens(
        [[tok.bos_id] + tok.encode(p) for p in PROMPTS], GenerateConfig(max_new_tokens=12))
    assert [tok.decode(o) for o in out] == ref


def test_continuous_engine_greedy_matches_jax_on_int8_tree(int8_tree):
    cfg, params, ref = int8_tree
    eng = ContinuousEngine(params, cfg, ByteTokenizer(), n_slots=2, decode_chunk=3,
                           cache_mode="paged", page_size=16,
                           gen=GenerateConfig(max_new_tokens=12), device="cpu")
    assert eng.generate(PROMPTS) == ref


def test_quantize_rejects_unmerged_lora():
    with pytest.raises(ValueError, match="merge"):
        quant.quantize_weights({"layers": {"lora": {}}})


@pytest.mark.parametrize("flags", [{"proj_bwd_impl": "pallas"},
                                   {"mlp_custom_vjp": True, "fused_gate_up": True},
                                   {"mlp_bwd_impl": "pallas", "fused_gate_up": True}],
                         ids=["proj_bwd_pallas", "mlp_custom_vjp", "mlp_bwd_pallas"])
def test_backward_seams_refuse_quantized_leaves(flags):
    """As the reference: the hand-written backward seams need float weights
    (quantized serving never differentiates)."""
    cfg = ModelConfig(**TINY, **flags)
    params = quant.quantize_weights(llama.init_params(cfg, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="plain float weights"):
        llama.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)


def test_training_masters_refuse_int8_leaves():
    from ditl_tpu_torch.models.convert import train_params_from_jax

    jcfg, tree = _jax_tree("unfused")
    with pytest.raises(ValueError, match="float weights"):
        train_params_from_jax(jax.device_get(jquant.quantize_weights(tree)),
                              dataclasses.replace(ModelConfig(**TINY)), "cpu")
