"""Model aggregation over a stacked cohort (plain half).

Port of the plain half of the JAX package's ``core/aggregation.py``:
weighted and quantized weighted averages, segment means (AutoFLSat tier
1) and the FedBuff delta flush. Parameters are dicts of tensors; a
stacked dict carries a leading client axis (K, ...). The robust
estimators of the reference (norm clip, trimmed mean, median, Krum) come
with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch


def _device(params) -> torch.device:
    return next(iter(params.values())).device


def _normalized(weights, device) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=device)
    return w / torch.clamp_min(w.sum(), 1e-9)


def weighted_average(stacked_params, weights):
    """stacked_params: dict of (K, ...) leaves; weights (K,)."""
    w = _normalized(weights, _device(stacked_params))
    out = {}
    for name, leaf in stacked_params.items():
        wb = w.reshape((-1,) + (1,) * (leaf.dim() - 1))
        # zero-weight rows (padded cohort slots) are forced to exact +0.0
        # rather than relying on 0*x: a non-finite pad row (0*inf = NaN)
        # must not poison the aggregate of the real cohort members.
        terms = torch.where(wb > 0, leaf.to(torch.float32) * wb, 0.0)
        # strictly ordered fold, as the reference's fori_loop: appending
        # zero-weight rows is an exact IEEE no-op, so the result is
        # bitwise independent of the padding width.
        acc = torch.zeros(leaf.shape[1:], dtype=torch.float32,
                          device=leaf.device)
        for i in range(leaf.shape[0]):
            acc = acc + terms[i]
        out[name] = acc.to(leaf.dtype)
    return out


def quantized_weighted_average(stacked_params, weights, bits: int):
    """Weighted average over the QuAFL wire format: each client row of
    each leaf is quantized to ``bits`` with its own per-tensor scale, then
    the server dequantizes + accumulates the whole cohort in one call of
    kernel K1 (``repro_torch.kernels.quant_agg.quant_agg_stacked``) per
    leaf. The tensors' device decides the route: the CUDA kernel on the
    card, its plain version on the CPU.

    Zero-weight rows (padded cohort slots) contribute nothing: their
    weight*scale product is 0, even where their scale is not finite."""
    from repro_torch.core.quantize import quantize_stacked
    from repro_torch.kernels.quant_agg import quant_agg_stacked

    w = _normalized(weights, _device(stacked_params))
    out = {}
    for name, leaf in stacked_params.items():
        q, scale = quantize_stacked(leaf, bits)
        acc = torch.zeros(leaf.shape[1:], dtype=torch.float32,
                          device=leaf.device)
        sw = torch.where(w > 0, w * scale, 0.0)
        out[name] = quant_agg_stacked(acc, q, sw).to(leaf.dtype)
    return out


def apply_buffered_deltas(global_params, stacked_new, stacked_base, weights):
    """FedBuff flush as one stacked reduction: global += mean_k of
    weights[k] * (new_k - base_k), with a leading buffer axis (D, ...)."""
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=_device(global_params))
    out = {}
    for name, g in global_params.items():
        n, b = stacked_new[name], stacked_base[name]
        wb = w.reshape((-1,) + (1,) * (n.dim() - 1))
        d = (wb * (n.to(torch.float32) - b.to(torch.float32))).mean(0)
        out[name] = (g.to(torch.float32) + d).to(g.dtype)
    return out


def segment_mean(stacked_params, n_segments: int):
    """Mean over contiguous equal-size segments of the leading axis:
    (S*m, ...) -> (S, ...). The tier-1 AutoFLSat cluster aggregation for
    all clusters at once."""
    return {name: leaf.reshape((n_segments, -1) + leaf.shape[1:])
            .to(torch.float32).mean(1).to(leaf.dtype)
            for name, leaf in stacked_params.items()}


def segment_weighted_mean(stacked_params, weights, n_segments: int):
    """``segment_mean`` with per-row weights (K,): zero-weight rows are
    excluded from their segment's mean; an all-zero segment yields zeros."""
    w_all = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                            device=_device(stacked_params))
    out = {}
    for name, leaf in stacked_params.items():
        seg = leaf.reshape((n_segments, -1) + leaf.shape[1:])
        w = w_all.reshape((n_segments, -1) + (1,) * (leaf.dim() - 1))
        num = torch.where(w > 0, seg.to(torch.float32) * w, 0.0).sum(1)
        den = torch.clamp_min(w.sum(1), 1e-9)
        out[name] = (num / den).to(leaf.dtype)
    return out


def pytree_bytes(params, bits=32):
    return sum(p.numel() for p in params.values()) * bits / 8
