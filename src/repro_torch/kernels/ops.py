"""Public wrappers over the port's kernels: the counterpart of the JAX
package's ``kernels/ops.py`` for the aggregation kernels K1-K3.

There is no ``mode`` or ``interpret`` argument: the tensors' device picks
the route (the CUDA kernel on the card, its plain version on the CPU).
Parameter trees are dicts of tensors, as everywhere in the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_agg import quant_agg, quant_agg_stacked
from repro_torch.kernels.trimmed_agg import trimmed_agg_stacked


def quantized_weighted_accumulate(acc, q, scale, weight):
    """acc + weight * scale * q for one tensor of any shape (kernel K3)."""
    return quant_agg(acc, q, scale, weight)


def quantized_stacked_accumulate(acc, q, sw):
    """acc + sum_k sw[k] * q[k] for a whole stacked cohort of quantized
    models (kernel K1)."""
    return quant_agg_stacked(acc, q, sw)


def trimmed_stacked_combine(x, rank_weights):
    """sum_r rw[r] * sort_over_clients(x)[r] for a whole stacked cohort —
    the rank-based robust-aggregation hot path (kernel K2). Invalid and
    pad rows must be pre-set to +inf so they sort last under zero rank
    weight."""
    return trimmed_agg_stacked(x, rank_weights)


def quantized_inplace_aggregate(q_models, scales, weights):
    """Aggregate a stream of quantized models into one float32 model, one
    K3 launch per leaf and model (paper Fig. 7 in-place semantics, QuAFL
    wire format). ``q_models``: list of dicts of int32 tensors; ``scales``:
    list of dicts of scalars; ``weights``: list of floats (normalized
    here)."""
    tot = sum(weights)
    acc = {k: torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for k, q in q_models[0].items()}
    for qm, sc, w in zip(q_models, scales, weights):
        acc = {k: quantized_weighted_accumulate(a, qm[k], sc[k], w / tot)
               for k, a in acc.items()}
    return acc
