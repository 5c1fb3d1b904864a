"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP, LayerNorm. [arXiv:2402.16819]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    mlp_act="squared_relu",
    norm_type="layernorm",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="nemotron-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512)
