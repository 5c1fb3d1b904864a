"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887]. Layer pattern: period 8, attention at offset 3 (1:7
attn:mamba), MoE on every other layer (offset 1 mod 2). NOTE (DESIGN.md §4):
the original uses Mamba-1 mixers; we use Mamba-2/SSD mixers for a single,
kernel-accelerated SSM substrate — an explicit, documented deviation.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    use_rope=False,               # jamba uses no positional encoding
    mlp_act="swiglu",
    norm_type="rmsnorm",
    layer_period=8,
    attn_layer_offsets=(3,),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, conv_width=4),
    source="arXiv:2403.19887",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-smoke", n_layers=8, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512, every=2),
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, n_groups=1,
                      conv_width=4, chunk=32))
