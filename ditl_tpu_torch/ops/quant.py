"""Weight-only int8 quantization for serving.

Counterpart of the JAX package's ``ops/quant.py``, with its names and its
arithmetic: symmetric per-output-channel int8 over the contraction axis
(-2), quantized from the f32 value of each weight, scale ``amax / 127``
(1.0 for an all-zero column), round half to even, clip to +-127.

Quantized leaves are ``{"q": int8 (..., d_in, d_out), "scale": f32
(..., 1, d_out)}`` dicts. ``weight_matmul`` (the counterpart of
``weight_einsum``) takes a float matrix or such a leaf. The JAX package
feeds the int8 tensor to the dot and lets XLA fuse the int8 -> bf16
convert into the dot's operand read, so device memory sees int8. PyTorch
fuses nothing here: the product converts ``q`` to the compute dtype as a
transient tensor (one matrix per product, never the whole tree), then
multiplies the output by the per-column scale. So int8 halves the weights
resident on the card but not the bytes a decode step moves (ROADMAP.md
lists a fused weight-only int8 product kernel as speed work).

The embedding table and the norm scales stay float (the embedding is a
gather, the norms are tiny). LoRA trees must be merged first.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["quantize_weights", "is_quantized_leaf", "weight_matmul"]

# Parameter-tree leaves that are (..., d_in, d_out) matmul weights.
_QUANT_KEYS = ("wq", "wk", "wv", "w_qkv", "wo", "w_gate", "w_up", "w_gu", "w_down", "kernel")


def is_quantized_leaf(w: Any) -> bool:
    return isinstance(w, dict) and set(w) == {"q", "scale"}


def _quantize_matrix(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 over the input (contraction) dim.
    A stacked (L, d_in, d_out) weight is quantized one layer at a time, so
    the f32 transient is one layer's (each column's amax lies within a
    layer: the same numbers)."""
    if w.dim() > 2:
        parts = [_quantize_matrix(w[i]) for i in range(w.shape[0])]
        return {"q": torch.stack([p["q"] for p in parts]),
                "scale": torch.stack([p["scale"] for p in parts])}
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, d_out)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def weight_matmul(x: torch.Tensor, w: Any, *, compute_dtype: torch.dtype,
                  preferred: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` where ``w`` is a float matrix or a quantized ``{"q",
    "scale"}`` leaf: the counterpart of ``weight_einsum("...d,df->...f")``.
    The product runs in ``compute_dtype`` (``preferred``: the output dtype,
    f32 for the logits, where ``x`` and the converted weight go up to f32 and
    the products of their compute-dtype values are exact); a quantized
    leaf's scale, cast to the output's dtype, multiplies the output."""
    out_dtype = preferred or compute_dtype
    if is_quantized_leaf(w):
        # |q| <= 127: exact in bf16 and f32, so q goes to the output's dtype
        # in one step.
        out = x.to(out_dtype) @ w["q"].to(out_dtype)
        return out * w["scale"].to(out.dtype)
    return x.to(out_dtype) @ w.to(compute_dtype).to(out_dtype)


def quantize_weights(params: Any, *, tie_embeddings: bool = False,
                     device: str | torch.device | None = None) -> Any:
    """Quantize the projection, MLP and lm-head weights of a dense tree (the
    JAX package's layout, or the port's serving tree). ``device``: each
    matrix moves there before it is quantized (one leaf at a time; its f32
    transient one layer at a time), the rest of the tree stays where it is.

    The port's serving tree holds a tied model's head as a float copy of the
    transposed embedding (``models/llama.py::serving_params``); with
    ``tie_embeddings=True`` it stays float, as the JAX package's tied head
    (the embedding itself) does."""
    if "lora" in params.get("layers", {}):
        raise ValueError(
            "merge LoRA adapters before quantizing (models.lora.merge_lora)"
        )

    def walk(tree: Any, keep: bool = False) -> Any:
        if isinstance(tree, dict):
            return {
                k: _quantize_matrix(v if device is None else v.to(device))
                if k in _QUANT_KEYS and not isinstance(v, dict) and not keep
                else walk(v, keep or (tie_embeddings and k == "lm_head"))
                for k, v in tree.items()
            }
        return tree

    return walk(params)
