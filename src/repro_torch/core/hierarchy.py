"""AutoFLSat's two-tier aggregation as a training mode. Port of the JAX
package's ``core/hierarchy.py``.

Orbital cluster == replica: every state leaf carries a leading
``clusters`` axis (the reference's ``pod`` mesh axis becomes this tensor
axis on one card). Training:

  * tier 1 (Intra-SL, synchronous FL inside a cluster): every local step
    trains each cluster on its own batch, with no exchange between
    clusters — a loop over each cluster's slice where the reference
    ``vmap``s, each cluster's result equal to ``make_train_step``'s on
    that cluster alone;
  * tier 2 (Inter-SL, AutoFLSat round): every H steps ``cluster_sync``
    averages parameters (and optimizer moments) across the cluster axis;
  * H comes from the orbital InterSLScheduler in faithful mode
    (``sync_interval_from_orbits``) or is a fixed hyper-parameter;
  * QuAFL (paper App. C): the exchanged parameters can be quantized to
    ``quant_bits`` before averaging, in plain tensor ops (the reference's
    sync calls no kernel either), in the reference's order of float32
    operations, so the sync is bitwise equal to the reference's.

On a mesh, ``hfl_state_specs`` and ``hfl_batch_specs`` map the clusters
axis to the ``pod`` mesh dimension, as the reference's.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.optimizers import (AdamWConfig, adamw_init,
                                          tree_leaves, tree_map)
from repro_torch.train.steps import TrainState, make_train_step

# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------


def init_hfl_state(cfg, n_clusters: int, generator,
                   device="cuda") -> TrainState:
    """Per-cluster replicated state with a leading clusters axis: the same
    init in every cluster (paper: w_0 seeded from one ground contact), the
    AdamW moments zero and ``opt/step`` of shape (clusters,)."""
    device = resolve_device(device)
    params = tree_map(
        lambda x: x.expand((n_clusters,) + tuple(x.shape)).clone(),
        M.init_params(cfg, generator, device))
    opt = adamw_init(params)
    opt["step"] = torch.zeros((n_clusters,), dtype=torch.int32,
                              device=device)
    return TrainState(params=params, opt=opt)


def abstract_hfl_state(cfg, n_clusters: int) -> TrainState:
    """Shapes and dtypes of :func:`init_hfl_state`'s state, on the ``meta``
    device (no storage)."""
    return init_hfl_state(cfg, n_clusters, torch.Generator(), device="meta")


def cluster_slice(tree, c):
    """Cluster ``c``'s view of every leaf of ``tree`` (no copy)."""
    return tree_map(lambda x: x[c], tree)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def make_hfl_local_step(cfg, opt_cfg: AdamWConfig = AdamWConfig()):
    """One tier-1 step: every cluster trains on ITS OWN batch shard.

    state leaves: (C, ...); batch: a list of C batches, one a cluster.
    Returns (state, metrics with a leading (C,) axis). The state is
    updated in place, cluster by cluster (the reference donates it): the
    train step writes each cluster's slice, a view of the state, in place,
    so the card holds one leaf's new values at a time beside the whole."""
    step = make_train_step(cfg, opt_cfg)

    def local(state: TrainState, batches):
        per = []
        for c, batch in enumerate(batches):
            _, m = step(cluster_slice(state, c), batch)
            per.append(m)
        metrics = {k: torch.stack([m[k] for m in per]) for k in per[0]}
        return state, metrics
    return local


def _mean0(x):
    """``jnp.mean(x, axis=0, keepdims=True)`` as XLA computes it: the sum
    over the clusters times the float32 reciprocal of their count (a
    division lands an ulp away for 3 clusters)."""
    return torch.sum(x, dim=0, keepdim=True) * (1.0 / x.shape[0])


# The averages below return the float32 mean (1, ...) over the clusters;
# ``make_cluster_sync`` writes it over every cluster's slice.


def _mean_over_clusters(x):
    return _mean0(x.to(torch.float32))


def _weighted_mean_over_clusters(x, w):
    """Policy-weighted tier-2 mean: cluster c contributes with weight
    ``w[c]`` (normalized here). Only used when ``cluster_weights`` is
    given — the unweighted path keeps the exact ``_mean_over_clusters``
    reduction, so a None weighting stays bitwise-identical."""
    ww = w.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.sum(x.to(torch.float32) * ww, dim=0, keepdim=True) \
        / torch.sum(w)


def _quantized_mean_over_clusters(x, bits: int, w=None):
    """QuAFL: per-cluster symmetric uniform quantization before averaging
    (optionally policy-weighted — the dequantized models are combined
    with ``w`` exactly like the float path). ``absmax / qmax`` is a
    division by a tensor, as ``x / scale`` is: CUDA turns a division by a
    host scalar into a multiply by its reciprocal."""
    qmax = 2.0 ** (bits - 1) - 1.0
    xf = x.to(torch.float32)
    dims = tuple(range(1, x.dim()))       # () keeps a (C,) leaf as is
    absmax = torch.amax(xf.abs(), dim=dims, keepdim=True) if dims \
        else xf.abs()
    scale = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, qmax)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    deq = q * scale
    if w is None:
        m = _mean0(deq)
    else:
        ww = w.reshape((-1,) + (1,) * (x.dim() - 1))
        m = torch.sum(deq * ww, dim=0, keepdim=True) / torch.sum(w)
    return m


def make_cluster_sync(cfg, quant_bits: int = 0, sync_opt_state: bool = True,
                      cluster_weights=None):
    """Tier-2 AutoFLSat exchange: average states across the cluster axis.

    ``cluster_weights``: optional (C,) selection-policy-derived tier-2
    weights (see :func:`policy_cluster_weights`). ``None`` (default) keeps
    the exact unweighted reduction. The float32 mean (1, ...) of each leaf
    is written over every cluster's slice of it, cast to the leaf's dtype:
    the state is updated in place, leaf by leaf (the reference donates
    it), and returned."""
    w_host = None if cluster_weights is None else \
        torch.from_numpy(np.asarray(cluster_weights, np.float32))

    @torch.no_grad()
    def sync(state: TrainState) -> TrainState:
        w = None if w_host is None else \
            w_host.to(tree_leaves(state.params)[0].device)
        if quant_bits:
            avg_p = partial(_quantized_mean_over_clusters, bits=quant_bits,
                            w=w)
        elif w is not None:
            avg_p = partial(_weighted_mean_over_clusters, w=w)
        else:
            avg_p = _mean_over_clusters
        avg_o = _mean_over_clusters if w is None else \
            partial(_weighted_mean_over_clusters, w=w)
        tree_map(lambda x: x.copy_(avg_p(x).expand_as(x)), state.params)
        if sync_opt_state:
            for k in ("m", "v"):
                tree_map(lambda x: x.copy_(avg_o(x).expand_as(x)),
                         state.opt[k])
        return state
    return sync


def policy_cluster_weights(plan, hw, policy, epochs: int,
                           round_deadline_s: float = float("inf"),
                           energy=None) -> np.ndarray:
    """Tier-2 sync weights from the selection-policy layer (host numpy).

    Resolves ``policy`` (a ``repro_torch.core.policy`` name or instance),
    derives its per-member AutoFLSat tier-1 epoch budgets over the fleet
    at t=0 (deadline- and SoC-driven; see
    ``SelectionPolicy.epoch_budgets``), and averages them per cluster,
    normalized to mean 1. A policy with no budget rule (every built-in)
    yields uniform weights — equivalent to the unweighted sync."""
    from repro_torch.core.policy import PolicyInputs, resolve_policy
    from repro_torch.sim.hardware import FleetProfile

    K = plan.constellation.n_sats
    C = plan.constellation.n_clusters
    fleet = FleetProfile.build(hw, K)
    pol = resolve_policy(policy, "scheduled")
    zeros = np.zeros(K)
    inp = PolicyInputs(t=0.0, epochs=float(epochs), proj=None, fleet=fleet,
                       t_up_k=zeros, t_down_k=zeros, clients_per_round=K,
                       round_deadline_s=float(round_deadline_s),
                       energy=energy)
    budgets = pol.epoch_budgets(inp, int(epochs)) \
        if pol.member_budgets else None
    if budgets is None:
        return np.ones(C)
    w = np.asarray(budgets, np.float64).reshape(C, -1).mean(axis=1)
    return w / w.mean()


# ---------------------------------------------------------------------------
# schedule from orbits (faithful mode)
# ---------------------------------------------------------------------------


def sync_interval_from_orbits(plan, hw, model_bytes: float,
                              step_time_s: float, t: float = 0.0,
                              max_h: int = 500) -> int:
    """Derive H (steps between cluster syncs) from the InterSLScheduler:
    chain the C(C-1)/2 pairwise ISL passes and convert the exchange-period
    wall time into training steps (Algorithm 2's epoch budget, recast).

    ``hw`` may be one ``HardwareProfile`` or a ``FleetProfile``; with a
    mixed fleet the exchange is bottlenecked by the slowest ISL radio."""
    C = plan.constellation.n_clusters
    if C <= 1:
        return 1
    tx = 2.0 * float(np.max(hw.tx_time(model_bytes, "isl")))
    chained = plan.chain_pair_transfers(t, tx)
    if chained is None:
        return max_h
    t_cur, _ = chained
    h = int((t_cur - t) // max(step_time_s, 1e-9))
    return int(min(max(h, 1), max_h))


# ---------------------------------------------------------------------------
# sharding specs for the HFL mode
# ---------------------------------------------------------------------------


def hfl_state_specs(cfg, mesh, expert_parallel=False):
    """Param/opt specs with the leading clusters axis mapped to ``pod``."""
    from repro_torch.sharding.partition import P, train_state_specs
    base = train_state_specs(cfg, mesh, expert_parallel)
    return tree_map(lambda spec: P(*(("pod",) + tuple(spec))), base)


def hfl_batch_specs(cfg, mesh, batch_tree):
    """Batch (C, local_b, ...) with C over ``pod`` and local_b over
    ``data``."""
    from repro_torch.sharding.partition import P
    return tree_map(
        lambda leaf: P(*(("pod", "data") + (None,) * (leaf.dim() - 2))),
        batch_tree)
