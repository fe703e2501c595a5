"""Llama-3.1-family decoder (inference and training forwards) in PyTorch.

Counterpart of the JAX package's ``models/llama.py``. Parameters are a nested
dict of tensors in the JAX package's ``init_params`` layout: layers stacked on
axis 0, projections stored (d_in, d_out) so ``x @ w`` is the reference's
``einsum("bsd,df->bsf")``. ``models/convert.py`` builds it from a JAX tree;
``init_params`` builds one from a seed.

Storage and arithmetic follow the reference, which keeps f32 masters and
casts them to the compute dtype at every use:
- projection weights, biases and the embedding table are stored in
  ``cfg.dtype`` (the cast done once);
- RMSNorm scales stay f32, because the reference reads them in f32;
- the lm head is stored in f32 holding the compute-dtype values. The
  reference takes bf16 x bf16 products with f32 output for the logits;
  ``x.float() @ head`` gives the same exact products and f32 sums, where a
  bf16 ``matmul`` would round the logits to bf16 and could flip greedy ties.
  It needs full-f32 GEMMs on the card (``torch.backends.cuda.matmul.
  allow_tf32 = False``, PyTorch's default).

The inference ``forward`` runs under ``torch.no_grad``. ``train_forward`` is
the differentiable forward the training loss runs (``train/step.py``): it
takes the layers' weights one dict per layer (each layer's slices of the
stacked masters, so the backward writes each layer's gradients into that
layer's own tensors instead of a zero-filled copy of the whole stack) and
wraps each decoder layer in ``torch.utils.checkpoint`` under every
``cfg.remat`` but ``"none"`` (``_apply_remat``). Training masters keep the
JAX tree exactly (``init_train_params``, every leaf in ``cfg.param_dtype``,
no separate f32 head); ``serving_params`` turns them into the serving tree.
MoE and LoRA raise.

int8 serving, as the reference: weight-only int8 leaves (``{"q", "scale"}``,
``ops/quant.py``) go through ``weight_matmul`` in every projection, the MLP
and the lm head (f32 logits), one matrix converted per product; the
backward seams refuse them. ``kv_cache_dtype="int8"`` makes the caches int8
with f32 scales: the lock-step decode hands the raw int8 cache and its
scales to attention, and the paged decode tick hands the int8 pools and
their scales to K3.

Remat, as the reference's ``_apply_remat``: ``"full"`` keeps nothing of a
layer; the other policies run selective checkpointing, whose policy sees
each dispatcher op of the layer's forward and keeps the outputs it names,
recomputing the rest in the backward. ``"dots"`` keeps the weight products
(``aten.mm``/``aten.addmm``: ``t @ w`` with 3-D ``t`` folds to ``mm``), never
attention's batched ``aten.bmm``, as ``checkpoint_dots_with_no_batch_dims``
keeps only products without batch dims; ``"dots_inputs"`` adds the tensors
tagged ``attn_in`` and ``mlp_in``; ``"attn"`` keeps only ``attn_out``. A tag
is the op ``ditl_torch::checkpoint_name``, a copy the policy can see (a
custom op's output may not alias its input), applied only where the policy
names it. The hand-written kernels are ``ctypes`` launches, not dispatcher
ops: the policy cannot keep their outputs, so the recompute relaunches K1
under every policy (``_FlashAttention`` saves its ``o`` and ``lse``).

The hand-written backward kernels sit behind the reference's seams: under
``proj_bwd_impl="pallas"`` every attention projection (``wq``, ``wk``,
``wv``, ``wo``, or ``w_qkv``) goes through ``ops/projection.projection`` (K6),
and under ``mlp_bwd_impl="pallas"`` or ``mlp_custom_vjp`` the MLP block goes
through ``ops/mlp.mlp_block`` (K5a/K5b). Their forwards are the same
products, so serving with these flags set gives the same outputs.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ditl_tpu_torch.config import ModelConfig
from ditl_tpu_torch.ops.attention import dot_product_attention
from ditl_tpu_torch.ops.quant import is_quantized_leaf, weight_matmul

Params = dict[str, Any]

__all__ = ["init_params", "init_train_params", "serving_params", "forward",
           "train_forward", "head_weights", "logits_from_hidden", "rms_norm",
           "rope_frequencies", "apply_rope", "check_supported", "torch_dtype",
           "checkpoint_name"]


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model features this slice of the port does not run."""
    missing = []
    if cfg.num_experts > 0:
        missing.append(f"MoE (num_experts={cfg.num_experts})")
    if cfg.lora_rank > 0:
        missing.append(f"LoRA (lora_rank={cfg.lora_rank})")
    if cfg.kv_cache_dtype not in ("", "model", "int8"):
        raise ValueError(
            f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r} ('', 'model', 'int8')"
        )
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(missing)
            + " (see ROADMAP.md)"
        )


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _init_tree(cfg: ModelConfig, seed: int, device, weight_dtype: torch.dtype,
               norm_dtype: torch.dtype) -> Params:
    """The JAX ``init_params`` tree (no ``lm_head`` when tied), drawn with a
    torch generator one layer at a time, so an 8B model never holds an f32
    copy of more than one layer. On the ``meta`` device: shapes and dtypes
    only (what a checkpoint is checked against)."""
    from ditl_tpu_torch.utils.device import resolve_device

    check_supported(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    d, hd = cfg.hidden_size, cfg.head_dim
    nh, nkv, f, n_layers = (cfg.num_heads, cfg.num_kv_heads,
                            cfg.intermediate_size, cfg.num_layers)
    if nh % nkv:
        raise ValueError(f"num_heads {nh} must be divisible by num_kv_heads {nkv}")
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(weight_dtype)

    def stacked(shape, fan_in):
        out = torch.empty((n_layers, *shape), dtype=weight_dtype, device=dev)
        for i in range(n_layers):
            out[i] = normal(shape, 1.0 / math.sqrt(fan_in))
        return out

    if cfg.fused_qkv:
        attn = {"w_qkv": stacked((d, (nh + 2 * nkv) * hd), d)}
    else:
        attn = {"wq": stacked((d, nh * hd), d),
                "wk": stacked((d, nkv * hd), d),
                "wv": stacked((d, nkv * hd), d)}
    attn["wo"] = stacked((nh * hd, d), nh * hd)
    if cfg.attention_bias:
        attn.update({
            "bq": torch.zeros((n_layers, nh * hd), dtype=weight_dtype, device=dev),
            "bk": torch.zeros((n_layers, nkv * hd), dtype=weight_dtype, device=dev),
            "bv": torch.zeros((n_layers, nkv * hd), dtype=weight_dtype, device=dev),
        })
    if cfg.fused_gate_up:
        mlp = {"w_gu": stacked((d, 2 * f), d), "w_down": stacked((f, d), f)}
    else:
        mlp = {"w_gate": stacked((d, f), d), "w_up": stacked((d, f), d),
               "w_down": stacked((f, d), f)}
    ones = torch.ones((n_layers, d), dtype=norm_dtype, device=dev)
    tree: Params = {
        "embed": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "layers": {
            "attn_norm": {"scale": ones},
            "attn": attn,
            "mlp_norm": {"scale": ones.clone()},
            "mlp": mlp,
        },
        "final_norm": {"scale": torch.ones((d,), dtype=norm_dtype, device=dev)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))}
    return tree


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> Params:
    """Seed-initialised serving weights in the port's layout (the JAX
    ``init_params`` distributions; a torch generator cannot draw the JAX
    numbers): weights in ``cfg.dtype``, norms and the head in f32."""
    return serving_params(_init_tree(cfg, seed, device, torch_dtype(cfg.dtype),
                                     torch.float32), cfg)


def init_train_params(cfg: ModelConfig, *, seed: int = 0,
                      device: str | torch.device = "cuda") -> Params:
    """Seed-initialised training masters: the JAX ``init_params`` tree with
    every leaf in ``cfg.param_dtype``."""
    pd = torch_dtype(cfg.param_dtype)
    return _init_tree(cfg, seed, device, pd, pd)


def serving_params(tree: Params, cfg: ModelConfig,
                   device: str | torch.device | None = None) -> Params:
    """A tree in the JAX ``init_params`` layout (training masters in any
    dtype) -> the serving tree, the storage rules of the module note:
    weights and the embedding in ``cfg.dtype``, norm scales in f32, and the
    head in f32 holding compute-dtype values (the transposed embedding when
    tied). Leaves already in their serving dtype are kept, not copied, and
    weight-only int8 leaves stay as they are (moved to ``device``)."""
    cd = torch_dtype(cfg.dtype)

    def conv(node, norm: bool):
        if is_quantized_leaf(node):
            return node if device is None else {k: t.to(device) for k, t in node.items()}
        if isinstance(node, dict):
            return {k: conv(v, norm or "norm" in k) for k, v in node.items()}
        t = node if device is None else node.to(device)
        return t.float() if norm else t.to(cd)

    out = {k: conv(v, "norm" in k) for k, v in tree.items() if k != "lm_head"}
    if cfg.tie_embeddings:
        head = out["embed"]["embedding"].float().T.contiguous()
    else:
        head = conv(tree["lm_head"]["kernel"], False)
        head = head if is_quantized_leaf(head) else head.float()
    out["lm_head"] = {"kernel": head}
    return out


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

# The tags each policy keeps (the reference's checkpoint_name calls).
_KEPT_NAMES = {"dots_inputs": ("attn_in", "mlp_in"), "attn": ("attn_out",)}


@torch.library.custom_op("ditl_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_checkpoint_name.register_fake
def _(x: torch.Tensor, name: str) -> torch.Tensor:
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


def checkpoint_name(x: torch.Tensor, name: str, cfg: ModelConfig) -> torch.Tensor:
    """``x`` tagged ``name`` for the remat policy (``jax.ad_checkpoint.
    checkpoint_name``): a copy through ``ditl_torch::checkpoint_name`` where
    the training forward runs under a policy that keeps that name, else
    ``x`` itself (the copy would buy nothing)."""
    if name in _KEPT_NAMES.get(cfg.remat, ()) and torch.is_grad_enabled():
        return torch.ops.ditl_torch.checkpoint_name(x, name)
    return x


def _remat_policy(remat: str):
    """The selective-checkpoint policy of ``remat`` ("dots", "dots_inputs"
    or "attn"): ``(ctx, op, *args) -> CheckpointPolicy``."""
    from torch.utils.checkpoint import CheckpointPolicy

    dots = remat in ("dots", "dots_inputs")
    names = _KEPT_NAMES.get(remat, ())
    products = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    tag = torch.ops.ditl_torch.checkpoint_name.default

    def policy(ctx, op, *args, **kwargs):
        if (dots and op in products) or (op == tag and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _apply_remat(layer_fn, cfg: ModelConfig):
    """``layer_fn`` under ``cfg.remat`` (the reference's ``_apply_remat``):
    non-reentrant ``torch.utils.checkpoint``, selective for the policies
    that keep something."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer_fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if cfg.remat != "full":
        policy = _remat_policy(cfg.remat)
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(policy)

    def wrapped(*args):
        return checkpoint(layer_fn, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, cfg: ModelConfig,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse RoPE frequencies (f32) with Llama-3.1 "llama3" scaling when
    ``cfg.rope_scaling_factor > 0``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    if cfg.rope_scaling_factor <= 0:
        return inv_freq
    factor = cfg.rope_scaling_factor
    low_f, high_f = cfg.rope_scaling_low_freq_factor, cfg.rope_scaling_high_freq_factor
    old_len = cfg.rope_scaling_original_max_len
    wavelen = 2.0 * math.pi / inv_freq
    scaled = torch.where(wavelen > old_len / low_f, inv_freq / factor, inv_freq)
    smooth = (old_len / wavelen - low_f) / (high_f - low_f)
    smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
    medium = (wavelen >= old_len / high_f) & (wavelen <= old_len / low_f)
    return torch.where(medium, smoothed, scaled)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Rotary embedding on split halves. x (B, S, H, D); positions (B, S)."""
    freqs = rope_frequencies(x.shape[-1], cfg, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _paged_decode_attention(q, k, v, layer_cache: dict, paged: dict,
                            cfg: ModelConfig) -> torch.Tensor:
    """The paged decode tick's attention. One token per slot (the plain
    tick): its K/V go into tail column ``paged["t"]`` in place (the
    reference returns new tails). A multi-token chunk (the speculative
    verify, S = k + 1): its K/V go into the tail at per-row offsets
    ``paged["off"]`` (= pos - starts), since slots advance by their own
    acceptance. The pools are read-only here, and the engine flushes the
    tail into pages once per tick. Attention reads pages + tail through
    ``paged_attention`` (4-D q for the verify) whatever ``attention_impl``
    is, as in the reference: the CUDA kernels (K3, its verify form) on the
    card."""
    from ditl_tpu_torch.ops.paged_attention import paged_attention

    tk, tv = layer_cache["tk"], layer_cache["tv"]
    if q.shape[1] == 1:
        tk[:, :, paged["t"]] = k[:, 0]
        tv[:, :, paged["t"]] = v[:, 0]
        q = q[:, 0]
    else:
        from ditl_tpu_torch.infer.cache import scatter_tail

        scatter_tail(tk, k.transpose(1, 2), paged["off"])
        scatter_tail(tv, v.transpose(1, 2), paged["off"])
    out = paged_attention(
        q.contiguous(), layer_cache["kp"], layer_cache["vp"],
        paged["table"], paged["lengths"], tail_k=tk, tail_v=tv,
        starts=paged["starts"], k_scale=layer_cache.get("ks"),
        v_scale=layer_cache.get("vs"),
    )
    return out[:, None] if out.dim() == 3 else out


def _decoder_layer(
    lp: Params,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,
    segment_ids: torch.Tensor | None,
    layer_cache: dict | None,
    cache_index: int | torch.Tensor,
    attn_mask: torch.Tensor | None,
    prefill_causal: bool,
    paged: dict | None,
) -> torch.Tensor:
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = lp["attn"]
    cd = x.dtype

    def matmul(t: torch.Tensor, w) -> torch.Tensor:
        if is_quantized_leaf(w):
            return weight_matmul(t, w, compute_dtype=cd)
        return t @ w

    def proj(t: torch.Tensor, w) -> torch.Tensor:
        """The attention projections' product: the ``proj_bwd_impl`` seam.
        ``"pallas"`` keeps the forward bit-identical and swaps the backward
        for the kernel K6 (ops/projection.py); a weight-only int8 leaf goes
        through ``weight_matmul``."""
        if cfg.proj_bwd_impl == "pallas":
            if is_quantized_leaf(w):
                raise ValueError(
                    "proj_bwd_impl='pallas' needs plain float weights "
                    "(quantized serving never differentiates — leave it off)"
                )
            from ditl_tpu_torch.ops.projection import projection

            return projection(t, w, bwd_impl="pallas",
                              blocks=(cfg.proj_bwd_block_n, cfg.proj_bwd_block_d))
        return matmul(t, w)

    h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
    h = checkpoint_name(h, "attn_in", cfg)  # the q/k/v products' wgrad operand
    if "w_qkv" in attn:
        q, k, v = proj(h, attn["w_qkv"]).split([nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = proj(h, attn["wq"]), proj(h, attn["wk"]), proj(h, attn["wv"])
    if "bq" in attn:  # Qwen2-family q/k/v bias
        q, k, v = q + attn["bq"], k + attn["bk"], v + attn["bv"]
    q = apply_rope(q.reshape(b, s, nh, hd), positions, cfg)
    k = apply_rope(k.reshape(b, s, nkv, hd), positions, cfg)
    v = v.reshape(b, s, nkv, hd).contiguous()

    if layer_cache is not None and paged is None:
        from ditl_tpu_torch.infer.cache import read_kv, write_kv

        write_kv(layer_cache, k, v, cache_index)
    if paged is not None:
        attn_out = _paged_decode_attention(q, k, v, layer_cache, paged, cfg)
    elif layer_cache is not None and not prefill_causal and "k_scale" in layer_cache:
        # Decode over an int8 cache: the raw int8 values and their scales go
        # to attention, which factors the scales out of the products.
        attn_out = dot_product_attention(
            q, layer_cache["k"], layer_cache["v"], causal=False, mask=attn_mask,
            impl=cfg.attention_impl, k_scale=layer_cache["k_scale"],
            v_scale=layer_cache["v_scale"],
        )
    elif layer_cache is not None and not prefill_causal:
        # Decode: attend the whole cache under the per-slot mask.
        k_full, v_full = read_kv(layer_cache, x.dtype)
        attn_out = dot_product_attention(
            q, k_full, v_full, causal=False, mask=attn_mask,
            impl=cfg.attention_impl,
        )
    else:
        # No cache, or a prefill from an empty cache at offset 0: causal
        # self-attention over the chunk, validity via segment ids — the
        # flash kernel's path.
        attn_out = dot_product_attention(
            q, k, v, causal=True, segment_ids=segment_ids,
            impl=cfg.attention_impl,
        )
    attn_out = checkpoint_name(attn_out.reshape(b, s, nh * hd), "attn_out", cfg)
    x = x + proj(attn_out, attn["wo"])

    h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
    h = checkpoint_name(h, "mlp_in", cfg)  # the gate/up products' wgrad operand
    mlp = lp["mlp"]
    if cfg.mlp_custom_vjp or cfg.mlp_bwd_impl == "pallas":
        # The hand-written backward (ops/mlp.py): the kernels K5a/K5b under
        # "pallas", the einsum spelling otherwise.
        if "w_gu" not in mlp:
            raise ValueError(
                "mlp_custom_vjp/mlp_bwd_impl='pallas' require fused_gate_up=True "
                "(the hand-written backward targets the fused w_gu layout)"
            )
        if is_quantized_leaf(mlp["w_gu"]) or is_quantized_leaf(mlp["w_down"]):
            raise ValueError(
                "mlp_custom_vjp/mlp_bwd_impl need plain float weights "
                "(quantized serving never differentiates — leave it off)"
            )
        from ditl_tpu_torch.ops.mlp import mlp_block

        return x + mlp_block(
            h, mlp["w_gu"], mlp["w_down"], bwd_impl=cfg.mlp_bwd_impl,
            bwd_blocks=(cfg.mlp_bwd_block_n, cfg.mlp_bwd_block_f, cfg.mlp_bwd_block_d),
        )
    if "w_gu" in mlp:
        gate, up = matmul(h, mlp["w_gu"]).chunk(2, dim=-1)
    else:
        gate, up = matmul(h, mlp["w_gate"]), matmul(h, mlp["w_up"])
    return x + matmul(F.silu(gate) * up, mlp["w_down"])


@torch.no_grad()
def forward(
    params: Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    cache: dict[str, torch.Tensor] | None = None,
    cache_index: int | torch.Tensor = 0,
    attn_mask: torch.Tensor | None = None,
    prefill_causal: bool = False,
    paged: dict | None = None,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Token ids (B, S) -> f32 logits (B, S, V), or the final-normed hidden
    states (B, S, D) with ``return_hidden=True``.

    ``cache`` (``{"k", "v"}`` of shape (L, B, Smax, K, D), infer/cache.py)
    makes this the incremental forward: the chunk's K/V are written into the
    cache at slot ``cache_index`` **in place** (the reference returns a new
    cache; in PyTorch an in-place write saves a copy of the cache per step),
    and attention reads the whole cache under ``attn_mask`` (B, S, Smax).
    ``cache_index`` is an int (every row at one depth) or a (B,) tensor of
    per-row slots (the speculative verify's chunk).
    ``prefill_causal=True`` with a cache: the chunk fills an empty cache from
    slot 0, so attention is causal over the chunk with validity from
    ``segment_ids`` — the serving prefill, which runs the flash kernel when
    ``cfg.attention_impl == "flash"``.

    ``paged`` (``{"table", "lengths", "starts", "t"}``) with a cache of
    ``{"kp", "vp", "tk", "tv"}`` (pools (L, P, K, ps, D), tails
    (L, B, K, T, D)) is the paged decode tick's step: one token per slot,
    whose K/V are written into tail column ``t`` in place, attending the
    pages through ``table`` plus the tail (``ops/paged_attention.py``). A
    chunk of S > 1 tokens per slot (the speculative verify) takes
    ``paged["off"]`` (B,) in place of ``t``: its K/V land in the tail at
    those per-row offsets, and query qi sees the tail below ``lengths +
    qi``."""
    check_supported(cfg)
    cd = torch_dtype(cfg.dtype)
    b, s = input_ids.shape
    if positions is None:
        positions = torch.arange(s, device=input_ids.device).expand(b, s)
    if paged is not None and (cache is None or "kp" not in cache):
        raise ValueError("a paged step needs the pools and tails as its cache")
    if cache is not None and not prefill_causal and attn_mask is None and paged is None:
        raise ValueError("a cached decode step needs attn_mask")
    x = params["embed"]["embedding"][input_ids].to(cd)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: {key: _layer_slice(w, i) for key, w in group.items()}
              for name, group in layers.items()}
        layer_cache = None
        if cache is not None:
            layer_cache = {key: c[i] for key, c in cache.items()}
        x = _decoder_layer(
            lp, x, cfg=cfg, positions=positions, segment_ids=segment_ids,
            layer_cache=layer_cache, cache_index=cache_index,
            attn_mask=attn_mask, prefill_causal=prefill_causal, paged=paged,
        )
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    if return_hidden:
        return x
    return logits_from_hidden(params, x)


def _layer_slice(w, i: int):
    """Layer ``i`` of a stacked weight, or of both tensors of an int8 leaf."""
    if is_quantized_leaf(w):
        return {"q": w["q"][i], "scale": w["scale"][i]}
    return w[i]


def logits_from_hidden(params: Params, x: torch.Tensor) -> torch.Tensor:
    """f32 logits from final-normed hidden states: exact products of the
    compute-dtype values, summed in f32 (see the module note); an int8 head
    as the reference's ``weight_einsum(..., preferred=f32)``."""
    head = params["lm_head"]["kernel"]
    if is_quantized_leaf(head):
        return weight_matmul(x, head, compute_dtype=x.dtype, preferred=torch.float32)
    return x.float() @ head


def head_weights(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The (D, V) lm-head matrix of a training tree (the transposed
    embedding when tied)."""
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].t()
    return params["lm_head"]["kernel"]


def _train_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, segment_ids: torch.Tensor | None
                 ) -> torch.Tensor:
    return _decoder_layer(
        lp, x, cfg=cfg, positions=positions, segment_ids=segment_ids,
        layer_cache=None, cache_index=0, attn_mask=None, prefill_causal=False,
        paged=None,
    )


def train_forward(
    layers: list[Params],
    top: Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Differentiable forward: token ids (B, S) -> f32 logits (B, S, V), or
    the final-normed hidden states with ``return_hidden=True`` (the fused
    loss applies the head itself). ``layers`` holds one dict per decoder
    layer (``{"attn_norm": {"scale"}, "attn": {...}, ...}`` without the
    layer axis); ``top`` holds ``embed``, ``final_norm`` and, untied,
    ``lm_head``. Weights arrive already in the compute dtype (the step casts
    f32 masters once, as the reference's step does)."""
    check_supported(cfg)
    cd = torch_dtype(cfg.dtype)
    b, s = input_ids.shape
    if positions is None:
        positions = torch.arange(s, device=input_ids.device).expand(b, s)
    # F.embedding rather than indexing: on CUDA its backward sums each token's
    # rows in f32 and rounds once, where indexing's adds them into the bf16
    # gradient one occurrence at a time (a frequent token's row then carries
    # hundreds of roundings).
    x = torch.nn.functional.embedding(input_ids.long(), top["embed"]["embedding"].to(cd))
    layer_fn = _apply_remat(_train_layer, cfg)
    for lp in layers:
        x = layer_fn(lp, x, cfg, positions, segment_ids)
    x = rms_norm(x, top["final_norm"]["scale"], cfg.rms_norm_eps)
    if return_hidden:
        return x
    # Exact products of the compute-dtype values, summed in f32, as the
    # reference's f32-output logits (autograd rounds the gradients back).
    return x.float() @ head_weights(top, cfg).to(cd).float()
