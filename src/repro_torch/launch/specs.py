"""Shape stand-ins for every model input, on the ``meta`` device (no
storage). Port of the JAX package's ``launch/specs.py``, with ``meta``
tensors where it has ``ShapeDtypeStruct``s.

``input_specs(cfg, shape)`` returns the arguments of the step:
  train    -> {"batch": {tokens, labels[, frames|patches]}}
  prefill  -> {"batch": {tokens[, frames|patches]}}
  decode   -> {"cache": ..., "tokens": (B,1), "pos": (B,)}

Integer inputs are int32 and float inputs the compute dtype, as the
reference's; the dry run turns them into sharded fake tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import cdtype
from repro_torch.optim.optimizers import tree_map


def S(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _modality_inputs(cfg: ModelConfig, b: int):
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = S((b, cfg.encoder.n_frames, cfg.d_model),
                            cdtype(cfg))
    if cfg.vision is not None:
        extra["patches"] = S((b, cfg.vision.n_img_tokens, cfg.vision.d_vision),
                             cdtype(cfg))
    return extra


def train_batch_specs(cfg: ModelConfig, shape: InputShape):
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": S((b, s), torch.int32),
             "labels": S((b, s), torch.int32)}
    batch.update(_modality_inputs(cfg, b))
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape):
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": S((b, s), torch.int32)}
    batch.update(_modality_inputs(cfg, b))
    return batch


def decode_specs(cfg: ModelConfig, shape: InputShape):
    b, s = shape.global_batch, shape.seq_len
    return {"cache": M.init_cache(cfg, b, s, device="meta"),
            "tokens": S((b, 1), torch.int32),
            "pos": S((b,), torch.int32)}


def input_specs(cfg: ModelConfig, shape: InputShape):
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    raise ValueError(shape.kind)


def concrete_inputs(cfg: ModelConfig, shape: InputShape, generator,
                    device="cuda"):
    """Inputs matching ``input_specs`` on ``device``: tokens drawn from
    ``generator`` (on the CPU) uniformly below the vocab, labels the
    tokens rolled by -1, frames / patches N(0, 0.02), caches and decode
    positions zero."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    concrete = tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        input_specs(cfg, shape))
    if "batch" in concrete:
        b = concrete["batch"]
        tk = torch.randint(0, cfg.vocab, tuple(b["tokens"].shape),
                           generator=generator, dtype=torch.int32)
        b["tokens"] = tk.to(device)
        if "labels" in b:
            b["labels"] = torch.roll(tk, -1, dims=1).to(device)
        for name in ("frames", "patches"):
            if name in b:
                b[name] = (torch.randn(tuple(b[name].shape),
                                       generator=generator) * 0.02
                           ).to(device=device, dtype=b[name].dtype)
    return concrete
