"""qwen3-14b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512)
