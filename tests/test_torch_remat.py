"""The port's remat policies (``models/llama.py``): which forward products
each policy reruns in the backward, bitwise-equal losses and gradients
under every policy, and the tag op's pass-through gradient.

A policy changes only what the backward keeps and what it recomputes, never
the arithmetic, so every comparison here is exact. The recomputed products
are counted by a dispatch mode over the backward: a forward product is an
``aten.mm`` whose second operand is one of the layer weights the forward was
given, as it was given (the gradients' products read the weights
transposed, a view with other strides).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ditl_tpu_torch.config import ModelConfig  # noqa: E402
from ditl_tpu_torch.models import llama  # noqa: E402
from ditl_tpu_torch.train import state as tstate  # noqa: E402
from ditl_tpu_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=64, max_seq_len=128, dtype="float32")
# The recipe's flags (bench.py's one-chip run): the MLP and projection
# backward behind their seams, blocks that admit TINY's shapes.
RECIPE = dict(attention_impl="flash", fused_gate_up=True, fused_qkv=True,
              mlp_bwd_impl="pallas", proj_bwd_impl="pallas", mlp_bwd_block_n=64,
              mlp_bwd_block_f=128, mlp_bwd_block_d=128, proj_bwd_block_n=64,
              proj_bwd_block_d=128, loss_impl="fused", loss_block_tokens=200)
FLAVOURS = {"inline": dict(attention_impl="xla"), "recipe": RECIPE}
POLICIES = ("none", "full", "dots", "dots_inputs", "attn")
# Tags each policy applies per layer (attn_in, attn_out, mlp_in).
TAGS = {"none": 0, "full": 0, "dots": 0, "dots_inputs": 2, "attn": 1}


def _batch(seed=0, b=2, s=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, size=(b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[:, s // 2:] = 2  # two packed documents per row
    pos = np.concatenate([np.arange(s // 2), np.arange(s - s // 2)]).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[:, -3:] = 0.0
    return {"input_ids": torch.from_numpy(ids), "loss_mask": torch.from_numpy(mask),
            "segment_ids": torch.from_numpy(seg),
            "positions": torch.from_numpy(np.tile(pos, (b, 1)))}


class _Products(TorchDispatchMode):
    """Counts ``aten.mm`` calls whose second operand is one of ``weights``
    as given (same storage, shape and strides), and the tag op's calls."""

    def __init__(self, weights):
        super().__init__()
        self.weights = {(w.data_ptr(), tuple(w.shape), w.stride()) for w in weights}
        self.products = self.tags = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            w = args[1]
            self.products += (w.data_ptr(), tuple(w.shape), w.stride()) in self.weights
        elif func is torch.ops.ditl_torch.checkpoint_name.default:
            self.tags += 1
        return func(*args, **(kwargs or {}))


def _run(remat, flavour, seed=0):
    """One forward and backward under ``remat`` from masters drawn from
    ``seed``: (loss, gradients, forward products and tags, products rerun in
    the backward)."""
    cfg = ModelConfig(**TINY, remat=remat, **FLAVOURS[flavour])
    params = llama.init_train_params(cfg, seed=seed, device="cpu")
    st = tstate.TrainState(params, tstate.make_leaves(params))
    layers, top = st.model_views()
    weights = [w for lp in layers for group in ("attn", "mlp") for w in lp[group].values()]
    with _Products(weights) as fwd:
        loss, _ = tstep.loss_fn(layers, top, _batch(), cfg)
    with _Products(weights) as bwd:
        loss.backward()
    grads = [p.grad for leaf in st.leaves for p in leaf.parts]
    return loss.detach(), grads, (fwd.products, fwd.tags), bwd.products


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_policies_rerun_exactly_the_products_they_do_not_keep(flavour):
    """Every forward product the backward needs reruns under ``full`` and
    ``attn``, none under ``dots`` and ``dots_inputs`` (their outputs are
    kept), none without remat; each policy applies only its own tags. The
    inline layer's last product (w_down) is the one the backward does not
    need: the recompute stops once it holds every tensor the backward
    saved (``torch.utils.checkpoint``'s early stop). The recipe's MLP block
    saves its tensors when its whole forward has run, so there w_down
    reruns too."""
    n_layers = TINY["num_layers"]
    # wq, wk, wv, wo, w_gate, w_up, w_down; the recipe fuses q|k|v and gate|up.
    per_layer, not_needed = (4, 0) if flavour == "recipe" else (7, 1)
    for remat in POLICIES:
        _, _, (fwd_products, tags), rerun = _run(remat, flavour)
        assert fwd_products == per_layer * n_layers, remat
        assert tags == TAGS[remat] * n_layers, remat
        want = (per_layer - not_needed) * n_layers if remat in ("full", "attn") else 0
        assert rerun == want, (remat, rerun, want)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_policies_give_bitwise_the_loss_and_gradients_of_no_remat(flavour):
    loss0, grads0, _, _ = _run("none", flavour, seed=3)
    for remat in POLICIES[1:]:
        loss, grads, _, _ = _run(remat, flavour, seed=3)
        assert torch.equal(loss, loss0), remat
        assert len(grads) == len(grads0)
        for g, g0 in zip(grads, grads0):
            assert torch.equal(g, g0), remat


def test_tag_op_passes_values_and_gradients_through():
    cfg = ModelConfig(**TINY, remat="dots_inputs")
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = llama.checkpoint_name(x, "attn_in", cfg)
    assert y is not x and y.data_ptr() != x.data_ptr() and torch.equal(y, x)
    g = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(dx, g)
    # Names the policy does not keep, and no-grad forwards, are not tagged.
    assert llama.checkpoint_name(x, "attn_out", cfg) is x
    with torch.no_grad():
        assert llama.checkpoint_name(x, "attn_in", cfg) is x
    assert llama.checkpoint_name(x, "attn_in", ModelConfig(**TINY, remat="dots")) is x


class _Outputs(TorchDispatchMode):
    """Keeps (so no later tensor can take its address) the output of every
    forward product with ``w_gu`` and of every tag, by name."""

    def __init__(self, w_gu):
        super().__init__()
        self.w_gu = {w.data_ptr() for w in w_gu}
        self.kept: dict[str, list] = {"gu": [], "attn_in": [], "mlp_in": [], "attn_out": []}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.mm.default and args[1].data_ptr() in self.w_gu:
            self.kept["gu"].append(out)
        elif func is torch.ops.ditl_torch.checkpoint_name.default:
            self.kept[args[1]].append(out)
        return out


@pytest.mark.parametrize("remat", ["full", "dots", "dots_inputs", "attn"])
def test_kernel_backwards_read_the_kept_buffers(remat, monkeypatch):
    """The MLP backward (K5a/K5b's wrapper) reads ``gu`` and ``h``, and the
    projection backward (K6's) reads each product's input: under a policy
    that keeps them these are the forward's own buffers, replayed; under
    ``full`` they are recomputed."""
    from ditl_tpu_torch.ops import mlp_bwd, projection

    cfg = ModelConfig(**TINY, remat=remat, **RECIPE)
    params = llama.init_train_params(cfg, seed=0, device="cpu")
    st = tstate.TrainState(params, tstate.make_leaves(params))
    layers, top = st.model_views()
    read = {"mlp_h": [], "gu": [], "proj_x": []}
    real_mlp, real_proj = mlp_bwd.fused_mlp_bwd, projection.projection_bwd

    def mlp(h, w_gu, w_down, gate, up, g, blocks=None):
        read["mlp_h"].append(h.data_ptr())
        read["gu"].append(gate.data_ptr())  # gate is the first half of gu
        return real_mlp(h, w_gu, w_down, gate, up, g, blocks=blocks)

    def proj(x, w, g, blocks=None):
        read["proj_x"].append(x.data_ptr())
        return real_proj(x, w, g, blocks=blocks)

    monkeypatch.setattr(mlp_bwd, "fused_mlp_bwd", mlp)
    monkeypatch.setattr(projection, "projection_bwd", proj)
    with _Outputs([lp["mlp"]["w_gu"] for lp in layers]) as fwd:
        loss, _ = tstep.loss_fn(layers, top, _batch(), cfg)
    loss.backward()
    kept = {k: {t.data_ptr() for t in v} for k, v in fwd.kept.items()}
    n = TINY["num_layers"]
    assert len(read["gu"]) == len(read["mlp_h"]) == n and len(read["proj_x"]) == 2 * n
    keeps_products = remat in ("dots", "dots_inputs")
    assert all((p in kept["gu"]) == keeps_products for p in read["gu"])
    if remat == "dots_inputs":
        assert set(read["mlp_h"]) == kept["mlp_in"] and len(kept["mlp_in"]) == n
        assert len(kept["attn_in"]) == n
        assert kept["attn_in"] <= set(read["proj_x"])  # the fused q|k|v product's input
    else:
        assert not kept["mlp_in"] and not kept["attn_in"]
    if remat == "attn":
        assert len(kept["attn_out"]) == n
        assert kept["attn_out"] <= set(read["proj_x"])  # wo's input
    else:
        assert not kept["attn_out"]
