"""AutoFLSat (paper §3.3, Algorithm 2): fully autonomous hierarchical FL.

Two-tier aggregation with NO central parameter server:
  * tier 1 — each orbital cluster runs synchronous FL over its always-on
    Intra-Satellite Links (every satellite trains e epochs, cluster model is
    the mean of its members);
  * tier 2 — cluster models are exchanged over Inter-Satellite Links whenever
    plane pairs have line-of-sight; the InterSLScheduler chains the
    C(C-1)/2 pairwise passes needed for all-to-all sharing and derives the
    per-round epoch budget e from the first/last comms record.

Port of the JAX package's ``core/autoflsat.py`` without the energy, fault
and deadline branches (``check_supported`` refuses those settings). Tier 1
trains the whole constellation as one (C*spc)-wide cohort; tier 2
aggregates the cluster models through ``_aggregate``: kernel K1 when
``quant_bits > 0``, or the robust estimator of ``FLConfig.aggregator``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.aggregation import segment_mean
from repro_torch.core.client import local_sgd_clients
from repro_torch.core.contact_plan import ContactPlan
from repro_torch.core.quantize import quantize_roundtrip_stacked
from repro_torch.core.spaceify import (FLConfig, RoundRecord, SpaceifiedFL,
                                       _broadcast)
from repro_torch.rng import TorchRandom


@dataclasses.dataclass
class InterSLSchedule:
    t_start: float
    t_complete: float          # all pairwise exchanges done
    epochs: int                # training budget derived from the schedule
    passes: List[Tuple[int, int, float]]   # (ci, cj, t_exchange)


def _fleet_mean(a) -> float:
    """Mean of a per-satellite array, exact for a uniform fleet (summing K
    equal doubles and dividing by K is not an IEEE identity)."""
    a = np.asarray(a, np.float64)
    first = a.flat[0]
    return float(first) if np.all(a == first) else float(np.mean(a))


class AutoFLSat(SpaceifiedFL):
    name = "autoflsat"

    def __init__(self, plan: ContactPlan, hw, dataset, cfg: FLConfig,
                 epochs_mode: str = "fixed", random_source=TorchRandom):
        super().__init__(plan, hw, dataset, cfg, random_source)
        if epochs_mode not in ("fixed", "auto"):
            raise ValueError(f"epochs_mode {epochs_mode!r}: 'fixed' | 'auto'")
        self.epochs_mode = epochs_mode
        self.n_clusters = C = plan.constellation.n_clusters
        # per-cluster models start from the seeded w_0
        self.cluster_params = _broadcast(self.global_params, C)

    # ------------------------------------------------------------------
    def inter_sl_scheduler(self, t: float) -> Optional[InterSLSchedule]:
        """Algorithm 2's InterSLScheduler: chain the C(C-1)/2 pair passes.
        Each pairwise exchange is bottlenecked by the slowest ISL radio
        among the two clusters' members."""
        C = self.n_clusters
        if C == 1:
            return InterSLSchedule(t, t, self.cfg.epochs, [])
        spc = self.plan.constellation.sats_per_cluster
        rate_c = self.fleet.isl_rate_bps.reshape(C, spc).min(1)
        tx = {(ci, cj):
              self.tx_bytes * 8.0 / min(rate_c[ci], rate_c[cj]) * 2.0
              for ci in range(C) for cj in range(ci + 1, C)}  # bidirectional
        chained = self.plan.chain_pair_transfers(t, tx)
        if chained is None:
            return None
        t_cur, passes = chained
        if self.epochs_mode == "auto":
            # epochs from first & last comms record (Algorithm 2); the
            # budget must fit the slowest ML unit so tier 1 stays in sync
            e = max(1, int((t_cur - t)
                           // float(np.max(self.fleet.epoch_time_s))))
            e = min(e, self.cfg.max_local_epochs)
        else:
            e = self.cfg.epochs
        return InterSLSchedule(t, t_cur, e, passes)

    # ------------------------------------------------------------------
    def run_round(self, r, t):
        cfg, plan = self.cfg, self.plan
        sched = self.inter_sl_scheduler(t)
        if sched is None:
            return None
        e = sched.epochs
        C = self.n_clusters
        spc = plan.constellation.sats_per_cluster
        K = C * spc
        train_time_k = self.fleet.train_time(e)              # (K,)
        intra_comm_k = self._t_isl_k * 2.0                   # bidirectional
        done_k = t + train_time_k + intra_comm_k

        # tier 1: synchronous intra-cluster FL (all satellites participate)
        # as ONE (C*spc)-wide cohort + a segment-wise cluster aggregation
        keys = self.rng.round_keys(K)        # sat (c, s) gets row c*spc + s
        bcast = self.cluster_params
        if cfg.quant_bits:                   # every transmitted model is
            bcast = quantize_roundtrip_stacked(bcast, cfg.quant_bits)
        stacked = {k: p[:, None].expand((C, spc) + p.shape[1:])
                   .reshape((K,) + p.shape[1:]) for k, p in bcast.items()}
        trained = local_sgd_clients(
            cfg.model, stacked, self.ds.x, self.ds.y,
            self._cohort_perms(keys, e), e, cfg.batch_size, cfg.lr)
        if cfg.quant_bits:                   # member -> cluster-head return
            trained = quantize_roundtrip_stacked(trained, cfg.quant_bits)

        # tier 2: all-to-all exchange -> constellation-wide model (the
        # exchanged cluster models cross ISLs quantized when quant_bits>0)
        stacked_clusters = segment_mean(trained, C)
        self.global_params, n_clip = self._aggregate(
            stacked_clusters, np.full(C, float(spc)))
        self.cluster_params = _broadcast(self.global_params, C)

        # timing: training overlaps the exchange chain; the round ends when
        # both the last pairwise pass and local training are done
        t_train_done = float(np.max(done_k))
        t_round_end = max(sched.t_complete, t_train_done)
        idle = max(t_round_end - t_train_done, 0.0)
        participants = list(range(K))
        acc = self._accuracy(r)
        # per-member comm: own intra-cluster exchanges + this member's
        # share of the tier-2 pass chain
        comm_k = intra_comm_k * 2 \
            + len(sched.passes) * self._t_isl_k * 2.0 / max(C, 1)
        return RoundRecord(r, t, t_round_end, t_round_end - t, idle,
                           _fleet_mean(comm_k), _fleet_mean(train_time_k),
                           acc, participants, epochs=float(e),
                           comm_s_by_sat={k: float(comm_k[k])
                                          for k in participants},
                           clipped_updates=n_clip)
