"""Model aggregation over a stacked cohort, and the Byzantine-robust
aggregation layer.

Port of the JAX package's ``core/aggregation.py``: weighted and quantized
weighted averages (kernel K1), the streamed in-place average, segment
means (AutoFLSat tier 1), the FedBuff delta flush, and the robust
estimators selected by ``FLConfig.aggregator``:

  * ``norm_clip`` — each row's delta from the broadcast reference is
    clipped to ``multiplier`` x the cohort's median delta norm before the
    weighted mean;
  * ``trimmed_mean`` — coordinate-wise: sort the valid rows, drop the
    ``trim`` fraction from each end, average the rest (unweighted);
  * ``median`` — coordinate-wise median;
  * ``krum`` — the row with the least summed squared distance to its
    m - f - 2 nearest peers becomes the aggregate.

Parameters are dicts of tensors; a stacked dict carries a leading client
axis (K, ...). Every estimator is pad-row-safe: a zero-weight row, even a
non-finite one, never reaches the output. The rank-based pair runs through
kernel K2 (``kernels/trimmed_agg.py``), one launch per aggregation, which
sorts such rows last as +inf without reading them.
Cohort weights are host arrays, so the valid count, the rank weights and
the attenuated-row count are host integers; the norm clip and Krum read
one device value back per aggregation, never one per leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_leaves


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


def inplace_aggregate(updates: Iterable[Tuple]):
    """Accumulate a stream of (params, weight) in fixed memory: the
    weighted average without holding more than one accumulator and one
    incoming model (Flower in-place semantics)."""
    acc = None
    total = 0.0
    for params, w in updates:
        w = float(w)
        if acc is None:
            acc = {k: p.to(torch.float32) * w for k, p in params.items()}
        else:
            acc = {k: a + params[k].to(torch.float32) * w
                   for k, a in acc.items()}
        total += w
    if acc is None:
        raise ValueError("no updates")
    return {k: a / total for k, a in acc.items()}


def quantized_weighted_average(stacked_params, weights, bits: int):
    """Weighted average over the QuAFL wire format: each client row of
    each leaf is quantized to ``bits`` with its own per-tensor scale, then
    the server dequantizes + accumulates the whole cohort, every leaf, in
    one call of kernel K1 (``repro_torch.kernels.quant_agg.
    quant_agg_stacked_inplace``). The accumulators are one zeroed float32
    buffer, each leaf at a 16-byte offset; float32 leaves come back as
    views of it. The tensors' device decides the route: the CUDA kernel on
    the card, its plain version on the CPU.

    Zero-weight rows (padded cohort slots) contribute nothing: their
    weight*scale product is 0, even where their scale is not finite."""
    from repro_torch.core.quantize import quantize_stacked
    from repro_torch.kernels.ops import quantized_stacked_accumulate_inplace

    dev = _device(stacked_params)
    w = _normalized(weights, dev)
    names = list(stacked_params)
    qs, scales = zip(*(quantize_stacked(stacked_params[k], bits)
                       for k in names))
    # (L, K): the same float32 products w * scale as one leaf at a time
    sw = torch.where(w > 0, w * torch.stack(scales), 0.0)
    spans = [(q[0].numel() + 3) // 4 * 4 for q in qs]
    buf = torch.zeros(sum(spans), dtype=torch.float32, device=dev)
    accs, off = [], 0
    for q, span in zip(qs, spans):
        accs.append(buf[off:off + q[0].numel()].view(q.shape[1:]))
        off += span
    quantized_stacked_accumulate_inplace(accs, list(qs), list(sw))
    return {k: acc.to(stacked_params[k].dtype) for k, acc in zip(names, accs)}


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


# ---------------------------------------------------------------------------
# Byzantine-robust aggregation layer
# ---------------------------------------------------------------------------


def _row_delta_norms(stacked_params, reference):
    """L2 norm of each client row's delta from ``reference``, over every
    leaf: (K,) float32. Non-finite pad rows give non-finite norms; callers
    mask by validity before using them."""
    sq = None
    for name, leaf in stacked_params.items():
        k = leaf.shape[0]
        d = leaf.to(torch.float32).reshape(k, -1) \
            - reference[name].to(torch.float32).reshape(1, -1)
        s = (d * d).sum(1)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _flatten_rows(stacked_params):
    """Concat-ravel every leaf into one (K, N) float32 matrix of rows."""
    return torch.cat([leaf.to(torch.float32).reshape(leaf.shape[0], -1)
                      for leaf in stacked_params.values()], dim=1)


def _valid(weights):
    """Host validity mask (weight > 0) and its count."""
    valid = np.asarray(weights, np.float32) > 0
    return valid, int(valid.sum())


class RobustAggregator:
    """Interface for Byzantine-robust cohort aggregation.

    ``aggregate(stacked_params, weights, reference)`` reduces a stacked
    cohort (leading client axis K, zero-weight rows = padded slots) to one
    model and reports how many rows the estimator attenuated or rejected.
    ``reference`` is the broadcast global model the cohort trained from.
    Implementations must be pad-row-safe."""

    name = "base"

    def aggregate(self, stacked_params, weights, reference):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NormClipAggregator(RobustAggregator):
    """Clip each row's update norm to ``multiplier`` x the cohort median
    delta norm, then take the usual data-weighted mean."""

    multiplier: float = 2.0
    name = "norm_clip"

    def aggregate(self, stacked_params, weights, reference):
        valid_np, m = _valid(weights)
        dev = _device(stacked_params)
        valid = torch.as_tensor(valid_np, device=dev)
        norms = _row_delta_norms(stacked_params, reference)
        srt = torch.sort(torch.where(valid, norms, torch.inf)).values
        med = 0.5 * (srt[(m - 1) // 2] + srt[m // 2])
        limit = self.multiplier * med
        factor = torch.where(
            valid, torch.clamp(limit / torch.clamp_min(norms, 1e-12),
                               max=1.0), 0.0)
        n_att = int(torch.sum(valid & (norms > limit)))
        rows = {}
        for name, leaf in stacked_params.items():
            fb = factor.reshape((-1,) + (1,) * (leaf.dim() - 1))
            rf = reference[name].to(torch.float32)[None]
            # select, don't rely on 0 * x: a non-finite pad row must not
            # leak NaN into its (excluded, but materialized) clipped row
            rows[name] = torch.where(
                fb > 0, rf + fb * (leaf.to(torch.float32) - rf),
                0.0).to(leaf.dtype)
        return weighted_average(rows, weights), n_att


def _rank_combine(stacked_params, valid, rank_weights):
    """``trimmed_stacked_combine_leaves`` (kernel K2) over every leaf at
    once, the host mask ``valid`` and rank weights passed as they are:
    invalid rows sort last as +inf under exact-0 rank weight."""
    from repro_torch.kernels.ops import trimmed_stacked_combine_leaves

    leaves = stacked_params.values()
    outs = trimmed_stacked_combine_leaves(
        [leaf.to(torch.float32).contiguous() for leaf in leaves],
        rank_weights, valid)
    return {name: out.to(leaf.dtype)
            for (name, leaf), out in zip(stacked_params.items(), outs)}


@dataclasses.dataclass(frozen=True)
class TrimmedMeanAggregator(RobustAggregator):
    """Coordinate-wise trimmed mean: per coordinate, sort the m valid
    rows, drop ``floor(trim * m)`` from each end, average the rest
    (rank-based and unweighted)."""

    trim: float = 0.2
    name = "trimmed_mean"

    def aggregate(self, stacked_params, weights, reference):
        valid, m = _valid(weights)
        lo = min(int(self.trim * m), max((m - 1) // 2, 0))
        kept = m - 2 * lo
        rw = np.zeros(len(valid), np.float32)
        rw[lo:m - lo] = 1.0 / kept
        return _rank_combine(stacked_params, valid, rw), 2 * lo


@dataclasses.dataclass(frozen=True)
class MedianAggregator(RobustAggregator):
    """Coordinate-wise median (the maximally trimmed mean)."""

    name = "median"

    def aggregate(self, stacked_params, weights, reference):
        valid, m = _valid(weights)
        rw = np.zeros(len(valid), np.float32)
        rw[(m - 1) // 2] += 0.5
        rw[m // 2] += 0.5
        return _rank_combine(stacked_params, valid, rw), max(m - 2, 0)


@dataclasses.dataclass(frozen=True)
class KrumAggregator(RobustAggregator):
    """Krum (Blanchard et al., NeurIPS'17): score each row by the summed
    squared distance to its m - f - 2 nearest cohort peers and adopt the
    single best-scoring row."""

    byzantine_f: int = 1
    name = "krum"

    def aggregate(self, stacked_params, weights, reference):
        valid_np, m = _valid(weights)
        valid = torch.as_tensor(valid_np, device=_device(stacked_params))
        rows = torch.where(valid[:, None], _flatten_rows(stacked_params), 0.0)
        sq = (rows * rows).sum(1)
        # a plain matrix product, left to the library as the reference
        # leaves it to XLA (TF32 must be off on the card)
        d2 = torch.clamp_min(sq[:, None] + sq[None, :]
                             - 2.0 * (rows @ rows.T), 0.0)
        eye = torch.eye(d2.shape[0], dtype=torch.bool, device=d2.device)
        pair_ok = valid[:, None] & valid[None, :] & ~eye
        d2 = torch.where(pair_ok, d2, torch.inf)
        n_nb = max(min(m - self.byzantine_f - 2, m - 1), min(1, m - 1))
        srt = torch.sort(d2, dim=1).values
        score = srt[:, :n_nb].sum(1) if n_nb > 0 \
            else torch.zeros(d2.shape[0], device=d2.device)
        winner = int(torch.argmin(torch.where(valid, score, torch.inf)))
        out = {name: leaf[winner] for name, leaf in stacked_params.items()}
        return out, max(m - 1, 0)


ROBUST_AGGREGATORS = {
    "norm_clip": NormClipAggregator,
    "trimmed_mean": TrimmedMeanAggregator,
    "median": MedianAggregator,
    "krum": KrumAggregator,
}


def make_robust_aggregator(spec):
    """Resolve ``FLConfig.aggregator``: None / "mean" -> None (the plain
    weighted mean), a registry name -> default-configured instance, an
    instance -> itself."""
    if spec is None or spec == "mean":
        return None
    if isinstance(spec, str):
        try:
            return ROBUST_AGGREGATORS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown aggregator {spec!r}; expected one of "
                f"{sorted(ROBUST_AGGREGATORS)} or a RobustAggregator "
                "instance") from None
    if isinstance(spec, RobustAggregator):
        return spec
    raise TypeError(f"aggregator must be None, str or RobustAggregator, "
                    f"got {type(spec).__name__}")


def robust_apply_buffered_deltas(global_params, stacked_new, stacked_base,
                                 weights, aggregator):
    """FedBuff flush through a robust estimator: the buffered rows become
    weighted deltas ``weights[k] * (new_k - base_k)`` and the estimator
    aggregates them against a zero reference; global += the result.
    Returns (params, n_attenuated)."""
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=_device(global_params))
    deltas = {}
    for name, n in stacked_new.items():
        wb = w.reshape((-1,) + (1,) * (n.dim() - 1))
        deltas[name] = wb * (n.to(torch.float32)
                             - stacked_base[name].to(torch.float32))
    zeros = {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
             for name, g in global_params.items()}
    upd, n_att = aggregator.aggregate(deltas, np.ones(len(w)), zeros)
    out = {name: (g.to(torch.float32) + upd[name].to(torch.float32))
           .to(g.dtype) for name, g in global_params.items()}
    return out, n_att


def pytree_bytes(params, bits=32):
    """Bytes of every tensor of ``params`` (a flat dict or a nested tree,
    such as the LM params) at ``bits`` a value."""
    return sum(p.numel() for p in tree_leaves(params)) * bits / 8
