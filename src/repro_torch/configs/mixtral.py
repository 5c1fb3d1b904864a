"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    sliding_window=4096,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384, every=1),
    source="arXiv:2401.04088",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
        sliding_window=64,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512, every=1))
