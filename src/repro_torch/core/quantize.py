"""QuAFL-style uniform quantization of model parameters for transmission
(paper App. C.5, Table 3: 8/10-bit communication vs 32-bit full precision).

Per-tensor symmetric uniform quantization: q = round(x / scale), scale =
max|x| / (2^(bits-1) - 1). Ints are carried in int32; ``quantized_bytes``
bills ``bits`` per value, which is what the data-rate model charges.

Port of the JAX package's ``core/quantize.py``. Both ``jnp.round`` and
``torch.round`` round half to even, and ``x / scale`` is a float32 division
of two tensors on one device (never a tensor by a host scalar, which CUDA
turns into a multiply by the reciprocal), so the integers agree bitwise
with the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import pytree_bytes
from repro_torch.optim.optimizers import tree_leaves


def _qmax(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def _q_leaf(x, bits):
    qmax = _qmax(bits)
    absmax = x.abs().max().to(torch.float32)
    scale = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, qmax)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax, qmax)
    return q.to(torch.int32), scale


def quantize_pytree(params, bits: int):
    """Quantize every tensor of ``params``: (dict of int32 q, dict of
    0-d float32 scales), one symmetric scale per tensor."""
    qs, scales = {}, {}
    for name, leaf in params.items():
        qs[name], scales[name] = _q_leaf(leaf, bits)
    return qs, scales


def dequantize_pytree(q, scales, dtype=torch.float32):
    """Inverse of :func:`quantize_pytree`: float(q) * scale per tensor."""
    return {name: (qi.to(torch.float32) * scales[name]).to(dtype)
            for name, qi in q.items()}


def quantize_stacked(x, bits: int):
    """Per-client per-tensor quantization of one stacked leaf (K, ...).

    Returns (q (K, ...) int32, scale (K,) float32) — each client row gets
    its own symmetric scale."""
    qmax = _qmax(bits)
    xf = x.to(torch.float32)
    absmax = xf.abs().reshape(x.shape[0], -1).amax(1)
    scale = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, qmax)
    sb = scale.reshape((-1,) + (1,) * (x.dim() - 1))
    q = torch.clamp(torch.round(xf / sb), -qmax, qmax)
    return q.to(torch.int32), scale


def quantize_roundtrip(params, bits: int):
    """What the receiver of a ``bits``-bit transmission actually sees:
    quantize + dequantize every tensor (the live QuAFL wire format)."""
    q, s = quantize_pytree(params, bits)
    return dequantize_pytree(q, s)


def quantize_roundtrip_stacked(stacked_params, bits: int):
    """Round-trip a dict of stacked leaves (K, ...) through the wire
    format, one scale per model per tensor."""
    out = {}
    for name, leaf in stacked_params.items():
        q, s = quantize_stacked(leaf, bits)
        sb = s.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out[name] = (q.to(torch.float32) * sb).to(leaf.dtype)
    return out


def transmit_bytes(params, quant_bits: int = 0) -> float:
    """Wire-format size of one transmitted model — the byte count every
    link type (uplink/downlink/ISL) bills."""
    if quant_bits:
        return quantized_bytes(params, quant_bits)
    return pytree_bytes(params, 32)


def quantized_bytes(params, bits: int) -> float:
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    n_tensors = len(leaves)
    return n * bits / 8 + n_tensors * 4          # + one f32 scale per tensor


def roundtrip_error(params, bits: int) -> float:
    """Relative L2 error of a ``bits``-bit round trip over all tensors of
    ``params`` (a flat dict or a nested tree)."""
    leaves = tree_leaves(params)
    deq = []
    for x in leaves:
        q, s = _q_leaf(x, bits)
        deq.append(q.to(torch.float32) * s)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(leaves, deq))
    den = sum(float((a ** 2).sum()) for a in leaves)
    return (num / max(den, 1e-12)) ** 0.5
