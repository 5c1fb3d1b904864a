"""Public wrappers over the port's kernels: the counterpart of the JAX
package's ``kernels/ops.py`` for the aggregation kernels K1-K3, the SSD
scan (K4) and the sliding-window attention (K5).

There is no ``mode`` or ``interpret`` argument: the tensors' device picks
the route (the CUDA kernel on the card, its plain version on the CPU).
Parameter trees are dicts of tensors, as everywhere in the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_agg import (quant_agg, quant_agg_inplace,
                                          quant_agg_stacked,
                                          quant_agg_stacked_inplace)
from repro_torch.kernels.ssd_scan import ssd_chunk
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.kernels.trimmed_agg import (trimmed_agg_stacked,
                                             trimmed_agg_stacked_leaves)


def quantized_weighted_accumulate(acc, q, scale, weight):
    """acc + weight * scale * q for one tensor of any shape (kernel K3)."""
    return quant_agg(acc, q, scale, weight)


def quantized_stacked_accumulate(acc, q, sw):
    """acc + sum_k sw[k] * q[k] for a whole stacked cohort of quantized
    models (kernel K1)."""
    return quant_agg_stacked(acc, q, sw)


def quantized_stacked_accumulate_inplace(accs, qs, sws):
    """accs[i] += sum_k sws[i][k] * qs[i][k] in place for every leaf of a
    stacked quantized cohort, one K1 launch for all of them (kernel K1)."""
    quant_agg_stacked_inplace(accs, qs, sws)


def trimmed_stacked_combine(x, rank_weights):
    """sum_r rw[r] * sort_over_clients(x)[r] for one stacked leaf (kernel
    K2, a table of one). Invalid and pad rows must be pre-set to +inf so
    they sort last under zero rank weight."""
    return trimmed_agg_stacked(x, rank_weights)


def trimmed_stacked_combine_leaves(xs, rank_weights, valid=None):
    """sum_r rw[r] * sort_over_clients(where(valid, x, inf))[r] for every
    leaf of a stacked cohort — the rank-based robust-aggregation hot path,
    one K2 launch for all of them. The rows that ``valid`` (K host
    booleans; None: all) marks invalid sort last, as +inf, under zero rank
    weight, and are never read."""
    return trimmed_agg_stacked_leaves(xs, rank_weights, valid)


def quantized_inplace_aggregate(q_models, scales, weights):
    """Aggregate a stream of quantized models into one float32 model (paper
    Fig. 7 in-place semantics, QuAFL wire format). ``q_models``: list of
    dicts of int32 tensors; ``scales``: list of dicts of scalars;
    ``weights``: list of floats (normalized here).

    The float32 accumulators are allocated once (one zeroed buffer, each
    leaf at a 16-byte boundary) and updated in place, one K3 launch per
    model for all its leaves; the returned dict holds views of that buffer.
    No tensor the caller passed in is modified."""
    tot = sum(weights)
    keys = list(q_models[0])
    first = [q_models[0][k] for k in keys]
    spans = [(q.numel() + 3) // 4 * 4 for q in first]
    buf = torch.zeros(sum(spans), dtype=torch.float32, device=first[0].device)
    acc, off = {}, 0
    for k, q, span in zip(keys, first, spans):
        acc[k] = buf[off:off + q.numel()].view(q.shape)
        off += span
    for qm, sc, w in zip(q_models, scales, weights):
        quant_agg_inplace([acc[k] for k in keys], [qm[k] for k in keys],
                          [sc[k] for k in keys], w / tot)
    return acc


def ssd_chunked_kernel(x, dt, A, B, C, chunk, init_state=None):
    """Chunked SSD with the intra-chunk stage in kernel K4; the same
    contract as ``repro_torch.models.ssm.ssd_chunked``.

    x (b, l, h, p); dt (b, l, h) post-softplus; A (h,); B, C (b, l, g, n).
    Returns (y (b, l, h, p) float32, final_state (b, h, p, n)). B and C stay
    at group width: K4 reads each head's group, and the carried-state term
    contracts C per group, so no head-repeated copy is made.
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}")
    nc, rep = l // chunk, h // g
    xr = x.reshape(b, nc, chunk, h, p).to(torch.float32)
    dtr = dt.reshape(b, nc, chunk, h).to(torch.float32)
    Br = B.reshape(b, nc, chunk, g, n).to(torch.float32)
    Cr = C.reshape(b, nc, chunk, g, n).to(torch.float32)
    A = A.to(torch.float32).contiguous()
    y_diag, states = ssd_chunk(xr, dtr, A, Br, Cr)

    # inter-chunk recurrence + carried-state output term (linear, torch)
    dA_cs = torch.cumsum(dtr * A, dim=2)                 # (b,nc,c,h)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])          # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    prev = []
    for z in range(nc):                                  # state BEFORE chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev = torch.stack(prev, dim=1).reshape(b, nc, g, rep, p, n)
    y_off = torch.einsum("bzcgn,bzgrpn->bzcgrp", Cr, prev).reshape(
        b, nc, chunk, h, p) * torch.exp(dA_cs)[..., None]
    return (y_diag + y_off).reshape(b, l, h, p), carry


def swa_flash_attention(q, k, v, window=0, causal=True):
    """q (B, L, H, hd); k, v (B, L, KH, hd) GQA. Returns (B, L, H, hd) in
    q's type (kernel K5, which reads each head's kv head in place)."""
    return swa_attention(q, k, v, window=window, causal=causal)
