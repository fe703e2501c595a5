"""Model configuration for the PyTorch port.

A copy of ``ModelConfig`` from the JAX package's ``config.py``, cut to the
fields the port's forward and serving read, with the same names and
defaults, so a preset or an ``--override`` means the same model in both
packages. The port never imports the JAX package, so it keeps its own copy
(``tests/test_torch_imports.py`` holds the two together). The training-only
fields (remat, backward-kernel knobs, loss head, pipeline) come with the
training slice. ``num_experts``, ``lora_rank`` and ``kv_cache_dtype`` are
kept so the features this slice does not run (MoE, LoRA, int8 caches) raise
where they would be used.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ModelConfig", "parse_model_overrides"]

# attention_impl values the port runs; the others wait for later slices.
PORTED_ATTENTION_IMPLS = ("xla", "flash")


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture hyperparameters (defaults describe a tiny
    debug model; ``models/presets.py`` holds the published shapes)."""

    name: str = "tiny-llama"
    vocab_size: int = 32000
    hidden_size: int = 256
    intermediate_size: int = 688
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 32
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    # Llama-3.1 "llama3" RoPE scaling; factor 0 disables.
    rope_scaling_factor: float = 0.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_len: int = 8192
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Qwen2-style bias on the q/k/v projections.
    attention_bias: bool = False
    dtype: str = "bfloat16"  # compute dtype; the port also stores weights in it
    num_experts: int = 0  # MoE: > 0 raises (not ported)
    lora_rank: int = 0  # LoRA: > 0 raises (not ported)
    # "xla" (plain PyTorch attention) | "flash" (the hand-written CUDA kernel
    # for causal prefill, ops/flash_attention.py).
    attention_impl: str = "xla"
    kv_cache_dtype: str = ""  # "" / "model"; "int8" raises (not ported)
    fused_gate_up: bool = False  # gate|up stored as one (D, 2F) matrix
    fused_qkv: bool = False  # q|k|v stored as one (D, (H + 2K) * hd) matrix

    def __post_init__(self):
        if self.attention_impl not in PORTED_ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r} is not ported to "
                f"PyTorch yet (ported: {', '.join(PORTED_ATTENTION_IMPLS)}); "
                "see ROADMAP.md for the slice that brings it"
            )


def _coerce(field: dataclasses.Field, raw: str):
    kind = field.type if isinstance(field.type, str) else field.type.__name__
    if kind == "bool":
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{field.name} wants a boolean, got {raw!r}")
    if kind == "int":
        return int(raw)
    if kind == "float":
        return float(raw)
    return raw


def parse_model_overrides(cfg: ModelConfig, overrides: list[str]) -> ModelConfig:
    """Apply ``key=value`` overrides (the server's ``--override``), typed by
    the field they name."""
    by_name = {f.name: f for f in dataclasses.fields(ModelConfig)}
    changes = {}
    for item in overrides:
        key, sep, raw = item.partition("=")
        key = key.strip()
        if key.startswith("model."):
            key = key[len("model."):]
        if not sep or key not in by_name:
            raise ValueError(
                f"bad override {item!r}: want FIELD=VALUE with FIELD one of "
                f"ModelConfig's fields"
            )
        changes[key] = _coerce(by_name[key], raw.strip())
    return dataclasses.replace(cfg, **changes)
