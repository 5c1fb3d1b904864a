"""qwen2-72b [dense] — GQA, QKV bias. [arXiv:2407.10671]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512)
