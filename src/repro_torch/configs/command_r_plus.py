"""command-r-plus-104b [dense] — GQA, no bias, parallel block. [hf:CohereForAI/c4ai-command-r-v01]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    parallel_block=True,
    mlp_act="swiglu",
    norm_type="layernorm",
    rope_theta=75_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-plus",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="commandr-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512)
