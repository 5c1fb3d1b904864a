"""Config system: frozen dataclasses describing every selectable architecture.

Each assigned architecture gets one module in this package exporting
``CONFIG`` (the exact full-size config) and ``smoke()`` (a reduced variant of
the same family: <=2 layers, d_model<=512, <=4 experts) for CPU smoke tests.

``registry()`` maps ``--arch <id>`` to the full config.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned; see system brief)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1          # MoE on layers with (i % every == every-1)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64      # P in SSD
    expand: int = 2         # d_inner = expand * d_model
    n_groups: int = 1       # G (B/C groups)
    conv_width: int = 4
    chunk: int = 256        # SSD chunk length
    dt_min: float = 1e-3
    dt_max: float = 1e-1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder over stubbed (precomputed) frame embeddings."""
    n_layers: int
    n_frames: int = 1500
    d_frontend: int = 0     # 0 => frames already at d_model (stub carve-out)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """VLM frontend stub: precomputed patch embeddings + linear projector."""
    n_img_tokens: int = 256
    d_vision: int = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 => d_model // n_heads
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0         # 0 => full attention
    parallel_block: bool = False    # command-r style parallel attn+mlp
    rope_theta: float = 1_000_000.0
    use_rope: bool = True
    # mlp flavour
    mlp_act: str = "swiglu"         # swiglu | gelu | squared_relu
    # norms
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"  # activations/matmuls; params stay f32
    attn_impl: str = "naive"         # naive | flash (Pallas swa_attention)
    ssm_impl: str = "jnp"            # jnp | pallas (Pallas ssd_scan)
    remat: str = "full"              # full | dots | none
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # sub-systems
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # layer pattern for hybrids: period and which offsets are attention.
    # dense archs: every layer attention. ssm: none.
    layer_period: int = 1
    attn_layer_offsets: Tuple[int, ...] = (0,)
    # citation
    source: str = ""

    # ------------------------------------------------------------------
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def is_attn_layer(self, i: int) -> bool:
        if self.arch_type == "ssm":
            return False
        return (i % self.layer_period) in self.attn_layer_offsets

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.every) == self.moe.every - 1

    def supports_long_context(self) -> bool:
        """True iff long_500k decode is meaningful (sub-quadratic state)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd()
        total = V * D                       # embed
        if not self.tie_embeddings:
            total += D * V                  # unembed
        for i in range(self.n_layers):
            total += D                      # pre-norm scale
            if self.norm_type == "layernorm":
                total += D
            if self.is_attn_layer(i):
                total += D * self.n_heads * hd          # wq
                total += 2 * D * self.n_kv_heads * hd   # wk, wv
                total += self.n_heads * hd * D          # wo
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
                if self.qk_norm:
                    total += 2 * hd
            elif self.arch_type in ("ssm", "hybrid") and self.ssm is not None:
                s = self.ssm
                d_in = s.d_inner(D)
                H = s.n_heads(D)
                conv_ch = d_in + 2 * s.n_groups * s.d_state
                total += D * (2 * d_in + 2 * s.n_groups * s.d_state + H)  # in_proj
                total += s.conv_width * conv_ch + conv_ch                  # conv + bias
                total += H * 3                                             # A_log, D, dt_bias
                total += d_in * D                                          # out_proj
                total += d_in                                              # gate norm scale
            has_ffn = self.is_moe_layer(i) or (self.d_ff > 0
                                               and self.arch_type != "ssm")
            if not self.parallel_block and has_ffn:
                total += D                  # post/mlp norm scale
                if self.norm_type == "layernorm":
                    total += D
            if self.arch_type == "ssm":
                continue
            if self.is_moe_layer(i):
                m = self.moe
                total += D * m.n_experts                      # router
                n_mats = 3 if self.mlp_act == "swiglu" else 2
                total += m.n_experts * n_mats * D * m.d_ff_expert
            elif F > 0:
                n_mats = 3 if self.mlp_act == "swiglu" else 2
                total += n_mats * D * F
        total += D                          # final norm
        if self.norm_type == "layernorm":
            total += D
        if self.encoder is not None:
            e = self.encoder
            attn_p = (D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                      + self.n_heads * hd * D)
            bias_p = ((self.n_heads + 2 * self.n_kv_heads) * hd
                      if self.qkv_bias else 0)
            norm_p = 2 * D if self.norm_type == "layernorm" else D
            n_mats = 3 if self.mlp_act == "swiglu" else 2
            total += e.n_layers * (attn_p + bias_p + 2 * norm_p
                                   + n_mats * D * F)
            total += norm_p                              # encoder final norm
            # decoder cross-attn (per decoder layer): attn + bias + norm_x
            total += self.n_layers * (attn_p + bias_p + norm_p)
        if self.vision is not None:
            total += self.vision.d_vision * D + D
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        n_moe_layers = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        inactive = n_moe_layers * (m.n_experts - m.top_k) * n_mats * self.d_model * m.d_ff_expert
        return self.n_params() - inactive


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "phi-3-vision-4.2b",
    "qwen2-72b",
    "jamba-v0.1-52b",
    "dbrx-132b",
    "mixtral-8x22b",
    "whisper-small",
    "qwen3-14b",
    "nemotron-4-15b",
    "command-r-plus-104b",
    "mamba2-1.3b",
)

_MODULES = {
    "phi-3-vision-4.2b": "phi3_vision",
    "qwen2-72b": "qwen2_72b",
    "jamba-v0.1-52b": "jamba",
    "dbrx-132b": "dbrx",
    "mixtral-8x22b": "mixtral",
    "whisper-small": "whisper_small",
    "qwen3-14b": "qwen3_14b",
    "nemotron-4-15b": "nemotron4_15b",
    "command-r-plus-104b": "command_r_plus",
    "mamba2-1.3b": "mamba2_1p3b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.smoke()


def registry():
    return {a: get_config(a) for a in ARCH_IDS}
