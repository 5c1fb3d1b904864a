"""Mixture-of-Experts with static-shape, sort-based token dispatch, as plain
functions on dicts of tensors. Port of the JAX package's ``models/moe.py``.

Dispatch never materialises a (tokens, experts, capacity) one-hot: the
token->slot assignment is a stable argsort over expert ids plus each
assignment's rank within its expert, then a gather into an (E, capacity, D)
buffer, batched expert matmuls, and a scatter-add combine.

Router: softmax over experts then top-k (ties to the lower expert index, as
``lax.top_k``), renormalised (Mixtral-style), with the Switch-style
load-balance auxiliary loss. On the card the two scatter-adds
(``index_add``) use atomics: kept rows own distinct slots and dropped rows
add exact zeros, so the dispatch is exact; the combine adds top_k terms per
token in no fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import activate, cx, normal


def init_moe(gen, cfg, d, device, lead=()):
    m = cfg.moe
    s_in = d ** -0.5
    s_out = m.d_ff_expert ** -0.5
    p = {
        "router": normal(gen, (*lead, d, m.n_experts), s_in, device),
        "wi": normal(gen, (*lead, m.n_experts, d, m.d_ff_expert), s_in,
                     device),
        "wo": normal(gen, (*lead, m.n_experts, m.d_ff_expert, d), s_out,
                     device),
    }
    if cfg.mlp_act == "swiglu":
        p["wg"] = normal(gen, (*lead, m.n_experts, d, m.d_ff_expert), s_in,
                         device)
    return p


def expert_counts(flat_e, n_experts):
    """(n_experts,) int64 count of each expert id in ``flat_e``, as
    ``torch.bincount(flat_e, minlength=n_experts)``: an ``index_add`` of
    ones (integer adds, exact in any order), which DTensor can shard and
    bincount is not."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat_e.device).index_add(
        0, flat_e, torch.ones_like(flat_e))


def router_topk(p, x2d, cfg):
    """x2d (T, D) -> (gates (T,k), idx (T,k), aux_loss scalar float32)."""
    m = cfg.moe
    logits = x2d.to(torch.float32) @ p["router"]                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt.values[:, :m.top_k], srt.indices[:, :m.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    counts = expert_counts(idx.reshape(-1), m.n_experts)
    e_onehot_mean = counts.to(torch.float32) / idx.numel()
    p_mean = probs.mean(0)
    aux = m.n_experts * (e_onehot_mean * p_mean).sum()
    return gates.to(x2d.dtype), idx, aux


def _dispatch_indices(idx, n_experts, capacity):
    """idx (T, k) expert assignments -> (slot, keep, order, sorted_e), each
    (T*k,).

    slot[i] is the row in the (E*capacity, D) buffer for flat assignment i
    (sorted order); keep masks capacity overflow; order maps sorted->flat.
    """
    tk = idx.numel()
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)           # sorted by expert
    sorted_e = flat_e[order]
    # rank within expert = position - start offset of that expert
    counts = expert_counts(sorted_e, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tk, device=idx.device) - starts[sorted_e]
    keep = rank < capacity
    slot = sorted_e * capacity + torch.clamp_max(rank, capacity - 1)
    return slot, keep, order, sorted_e


def capacity_of(cfg, t):
    """Expert capacity for t tokens: all of them for t <= 4096 (decode and
    small batches never drop), else cf * t * k / E slots (at least k)."""
    m = cfg.moe
    if t <= 4096:
        return t
    return max(int(m.capacity_factor * t * m.top_k / m.n_experts), m.top_k)


def apply_moe(p, x, cfg):
    """x (B, S, D) -> (out (B, S, D), aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, aux = router_topk(p, x2d, cfg)
    capacity = capacity_of(cfg, t)
    slot, keep, order, _ = _dispatch_indices(idx, m.n_experts, capacity)

    token_of = torch.arange(t, device=x.device).repeat_interleave(
        m.top_k)[order]
    gate_of = gates.reshape(-1)[order]

    # gather tokens into an (E*capacity, D) buffer. Dropped rows all collide
    # on slot capacity-1: they add 0, so they cannot clobber a kept row.
    # (out-of-place adds into zeros: DTensor can add into a buffer the
    # model makes only as a new tensor)
    buf = torch.zeros((m.n_experts * capacity, d), dtype=x.dtype,
                      device=x.device).index_add(
        0, slot, torch.where(keep[:, None], x2d[token_of], 0))
    buf = buf.reshape(m.n_experts, capacity, d)

    # expert computation (batched over E)
    h = torch.bmm(buf, cx(p["wi"], cfg))
    gate = (torch.bmm(buf, cx(p["wg"], cfg)) if cfg.mlp_act == "swiglu"
            else None)
    h = activate(h, cfg, gate)
    out_buf = torch.bmm(h, cx(p["wo"], cfg)).reshape(
        m.n_experts * capacity, d)

    # combine: weighted scatter-add back to tokens
    contrib = out_buf[slot] * (gate_of * keep.to(gate_of.dtype))[:, None]
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add(
        0, token_of, contrib)
    return y.reshape(b, s, d), aux
