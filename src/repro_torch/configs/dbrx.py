"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE. [hf:databricks/dbrx-base]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    mlp_act="swiglu",
    norm_type="layernorm",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752, every=1),
    source="hf:databricks/dbrx-base",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="dbrx-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512, every=1))
