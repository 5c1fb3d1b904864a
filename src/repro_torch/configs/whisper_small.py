"""whisper-small [audio] — enc-dec transformer, conv frontend STUBBED.

[arXiv:2212.04356]. Per the brief, the mel-spectrogram + conv feature
extractor is a stub: ``input_specs()`` supplies precomputed frame embeddings
(batch, 1500, d_model); this config implements the encoder/decoder backbone.
"""
import dataclasses

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    n_layers=12,                  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    qkv_bias=True,
    use_rope=False,               # whisper uses learned/sinusoidal absolute
    mlp_act="gelu",
    norm_type="layernorm",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    source="arXiv:2212.04356",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        encoder=EncoderConfig(n_layers=2, n_frames=64))
