"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                       # mamba block doubles as mixer+mlp
    vocab=50280,
    use_rope=False,
    norm_type="rmsnorm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, conv_width=4),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=256, vocab=512,
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, n_groups=1,
                      conv_width=4, chunk=32))
