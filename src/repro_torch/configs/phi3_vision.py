"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUBBED.

[hf:microsoft/Phi-3-vision-128k-instruct]. Per the brief, the ViT/CLIP vision
encoder is a stub: ``input_specs()`` supplies precomputed patch embeddings
(batch, 256, 1024); a learned linear projector maps them into d_model and the
embeddings replace the first 256 token positions.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    vision=VisionConfig(n_img_tokens=256, d_vision=1024),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi3v-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=8, head_dim=32, d_ff=512, vocab=512,
        vision=VisionConfig(n_img_tokens=16, d_vision=64))
