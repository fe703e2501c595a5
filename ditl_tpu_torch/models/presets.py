"""Named model presets: the JAX package's ``models/presets.py`` with the same
names and values on the port's ``ModelConfig`` fields (the MoE presets'
``num_experts_per_tok=2`` is the JAX default and has no port field yet;
``tests/test_torch_imports.py`` holds them equal).

Treat existing preset names as frozen: new variants get new names, because
RoPE scaling and context length are not stored with the weights.
"""

from __future__ import annotations

from dataclasses import replace

from ditl_tpu_torch.config import ModelConfig

__all__ = ["PRESETS", "get_preset"]

PRESETS: dict[str, ModelConfig] = {
    "tiny-llama": ModelConfig(),
    "tiny-moe": ModelConfig(
        name="tiny-moe", num_experts=8, intermediate_size=344
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=8192,
        rope_theta=500000.0,
    ),
    "llama3-70b": ModelConfig(
        name="llama3-70b",
        vocab_size=128256,
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=8192,
        rope_theta=500000.0,
    ),
    "llama31-8b": ModelConfig(
        name="llama31-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=131072,
        rope_theta=500000.0,
        rope_scaling_factor=8.0,
    ),
    "llama31-70b": ModelConfig(
        name="llama31-70b",
        vocab_size=128256,
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=131072,
        rope_theta=500000.0,
        rope_scaling_factor=8.0,
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        max_seq_len=32768,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        attention_bias=True,
    ),
    "qwen2-0.5b": ModelConfig(
        name="qwen2-0.5b",
        vocab_size=151936,
        hidden_size=896,
        intermediate_size=4864,
        num_layers=24,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        max_seq_len=32768,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        attention_bias=True,
        tie_embeddings=True,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=32768,
        rope_theta=1000000.0,
        num_experts=8,
    ),
}


def get_preset(name: str, **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg
