"""AutoFLSat (paper §3.3, Algorithm 2): fully autonomous hierarchical FL.

Two-tier aggregation with NO central parameter server:
  * tier 1 — each orbital cluster runs synchronous FL over its always-on
    Intra-Satellite Links (every satellite trains e epochs, cluster model is
    the mean of its members);
  * tier 2 — cluster models are exchanged over Inter-Satellite Links whenever
    plane pairs have line-of-sight; the InterSLScheduler chains the
    C(C-1)/2 pairwise passes needed for all-to-all sharing and derives the
    per-round epoch budget e from the first/last comms record.

Port of the JAX package's ``core/autoflsat.py``. Tier 1 trains the whole
constellation as one (C*spc)-wide cohort; tier 2 aggregates the cluster
models through ``_aggregate``: kernel K1 when ``quant_bits > 0``, or the
robust estimator of ``FLConfig.aggregator``. With energy or faults on,
members below the battery floor, inside an outage or reset by radiation
carry zero weight in their cluster's mean (and a cluster with no member
left zero tier-2 weight); the ISL pair chain retries dropped hops; a
finite round deadline closes the tier-1 barrier and skips pair exchanges
that cannot land in time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.aggregation import segment_mean, segment_weighted_mean
from repro_torch.core.client import local_sgd_clients
from repro_torch.core.contact_plan import ContactPlan
from repro_torch.core.quantize import quantize_roundtrip_stacked
from repro_torch.core.spaceify import (_WALK_ATTEMPT_CAP, FLConfig,
                                       RoundRecord, SpaceifiedFL, _broadcast)
from repro_torch.rng import TorchRandom


@dataclasses.dataclass
class InterSLSchedule:
    t_start: float
    t_complete: float          # all pairwise exchanges done
    epochs: int                # training budget derived from the schedule
    passes: List[Tuple[int, int, float]]   # (ci, cj, t_exchange)
    # fault accounting (zeros when FLConfig.faults is off)
    dropped_contacts: int = 0          # ISL hop attempts lost to drops
    retransmit_bytes: float = 0.0      # re-billed bytes of retried hops
    retries_exhausted: int = 0         # pair hops abandoned: retry budget out
    pairs_skipped: int = 0             # pair exchanges skipped (deadline or
                                       # exhaustion)


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
        among the two clusters' members. With faults or a finite deadline
        the chain goes through ``_chain_pair_transfers_faulted``."""
        C = self.n_clusters
        if C == 1:
            return InterSLSchedule(t, t, self.cfg.epochs, [])
        spc = self.plan.constellation.sats_per_cluster
        rate_c = self.fleet.isl_rate_bps.reshape(C, spc).min(1)
        tx = {(ci, cj):
              self.tx_bytes * 8.0 / min(rate_c[ci], rate_c[cj]) * 2.0
              for ci in range(C) for cj in range(ci + 1, C)}  # bidirectional
        drops, rebill, rex, skipped = 0, 0.0, 0, 0
        if self.faults is None and not self._deadline_on:
            chained = self.plan.chain_pair_transfers(t, tx)
            if chained is None:
                return None
            t_cur, passes = chained
        else:
            t_deadline = t + self.cfg.round_deadline_s \
                if self._deadline_on else np.inf
            chained = self._chain_pair_transfers_faulted(t, tx, t_deadline)
            if chained is None:
                return None
            t_cur, passes, drops, rebill, rex, skipped = chained
        if self.epochs_mode == "auto":
            # epochs from first & last comms record (Algorithm 2); the
            # budget must fit the slowest ML unit so tier 1 stays in sync
            e = max(1, int((t_cur - t)
                           // float(np.max(self.fleet.epoch_time_s))))
            e = min(e, self.cfg.max_local_epochs)
        else:
            e = self.cfg.epochs
        return InterSLSchedule(t, t_cur, e, passes, drops, rebill,
                               rex, skipped)

    def _chain_pair_transfers_faulted(self, t: float, tx: dict,
                                      t_deadline: float = np.inf):
        """Fault-aware pair chain: each ISL hop's attempt may drop
        (``faults.pair_dropped``, keyed by the attempt time, so every
        retry is a fresh draw). A dropped hop spends its airtime, re-bills
        the pair's bytes both ways and retries at the next pair window.
        With ``cfg.max_retries`` set each hop gets that budget and
        window-level exponential backoff, and an exhausted hop skips the
        pair's exchange; with a finite deadline a pair whose exchange
        cannot land by ``t_deadline``, or whose windows run out, is
        skipped too instead of failing the round. Returns (t_complete,
        passes, dropped_hops, retransmit_bytes, retries_exhausted,
        pairs_skipped), or None when a hop runs out of windows in
        wait-for-all mode."""
        C = self.n_clusters
        t_cur = t
        passes: List[Tuple[int, int, float]] = []
        drops, rebill, rex, skipped = 0, 0.0, 0, 0
        bounded = self.cfg.max_retries is not None
        budget = self.cfg.max_retries if bounded else _WALK_ATTEMPT_CAP
        deadline_on = bool(np.isfinite(t_deadline))
        for ci in range(C):
            for cj in range(ci + 1, C):
                dur = tx[(ci, cj)]
                attempts = 0
                while True:
                    done = self.plan.transmit_over_pair(ci, cj, t_cur, dur)
                    if done is None:
                        if deadline_on:
                            skipped += 1    # degrade: drop this exchange
                            break
                        return None
                    if deadline_on and done > t_deadline:
                        skipped += 1        # cannot land before the close
                        break
                    if self.faults is None or \
                            not self.faults.pair_dropped(ci, cj, t_cur):
                        passes.append((ci, cj, t_cur))
                        t_cur = done
                        break
                    drops += 1
                    attempts += 1
                    rebill += 2.0 * self.tx_bytes   # both directions lost
                    if attempts > budget:
                        rex += 1
                        skipped += 1
                        t_cur = done    # the failed attempt spent airtime
                        break
                    # retry at the next pair window (strictly later, so
                    # the walk terminates and every retry keys a new draw)
                    w = self.plan.next_pair_window(ci, cj, done)
                    if bounded:     # window-level exponential backoff
                        for _ in range((1 << min(attempts - 1, 16)) - 1):
                            if w is None:
                                break
                            w = self.plan.next_pair_window(ci, cj,
                                                           float(w[1]))
                    if w is None:
                        if deadline_on:
                            skipped += 1
                            t_cur = done
                            break
                        return None
                    t_cur = float(w[1]) if w[0] <= done else float(w[0])
        return t_cur, passes, drops, rebill, rex, skipped

    # ------------------------------------------------------------------
    def _member_mask(self, t, done_k):
        """Tier-1 gating at round start: ``(ok, energy_ok, n_faulted)``.
        Members below the SoC floor, inside an outage, or reset by
        radiation before their train+exchange completes get ``ok`` False;
        ``ok is None`` means everyone takes part (an all-True fault mask is
        not folded in, so a never-firing FaultConfig keeps the plain
        segment mean)."""
        energy_ok = None
        if self.energy is not None:
            self.energy.advance_to(t)
            energy_ok = self.energy.eligible()
        ok, n_flt = energy_ok, 0
        if self.faults is not None:
            fault_ok = self.faults.available(t)
            if self.faults.cfg.has_resets:
                fault_ok = fault_ok & (self.faults.resets_between(
                    np.arange(len(done_k)), t, done_k) == 0)
            n_flt = int(np.sum(~fault_ok)) if ok is None \
                else int(np.sum(ok & ~fault_ok))
            if not bool(fault_ok.all()):
                ok = fault_ok if ok is None else ok & fault_ok
        return ok, energy_ok, n_flt

    def run_round(self, r, t):
        cfg, plan = self.cfg, self.plan
        sched = self.inter_sl_scheduler(t)
        if sched is None:
            return None
        e = sched.epochs
        C = self.n_clusters
        spc = plan.constellation.sats_per_cluster
        K = C * spc
        # per-member tier-1 epoch budgets of a policy with member_budgets
        # (a slow or drained member trains fewer epochs); None keeps the
        # schedule's scalar budget
        ep_k = None
        if self.policy.member_budgets:
            ep_k = self.policy.epoch_budgets(
                self._policy_inputs(None, t, e), e)
        if ep_k is not None:
            ep_k = np.asarray(ep_k, np.int32)
            train_time_k = self.fleet.train_time(ep_k)       # (K,)
        else:
            train_time_k = self.fleet.train_time(e)          # (K,)
        intra_comm_k = self._t_isl_k * 2.0                   # bidirectional
        done_k = t + train_time_k + intra_comm_k
        ok, energy_ok, n_flt = self._member_mask(t, done_k)

        # tier 1: synchronous intra-cluster FL (all satellites train) as
        # ONE (C*spc)-wide cohort + a segment-wise cluster aggregation
        keys = self.rng.round_keys(K)        # sat (c, s) gets row c*spc + s
        bcast = self.cluster_params
        if cfg.quant_bits:                   # every transmitted model is
            bcast = quantize_roundtrip_stacked(bcast, cfg.quant_bits)
        stacked = {k: p[:, None].expand((C, spc) + p.shape[1:])
                   .reshape((K,) + p.shape[1:]) for k, p in bcast.items()}
        trained = local_sgd_clients(
            cfg.model, stacked, self.ds.x, self.ds.y,
            self._cohort_perms(keys, e), ep_k if ep_k is not None else e,
            cfg.batch_size, cfg.lr)
        if cfg.quant_bits:                   # member -> cluster-head return
            trained = quantize_roundtrip_stacked(trained, cfg.quant_bits)

        def cluster_ref(kk):
            return {n: b[kk // spc] for n, b in bcast.items()}

        # silent payload faults on the member -> cluster-head delivery at
        # done_k; members already masked out deliver nothing
        n_corr = 0
        if self.faults is not None and self.faults.cfg.has_payload_faults:
            for kk in range(K):
                if ok is not None and not ok[kk]:
                    continue
                trained, bad = self._corrupt_row(
                    trained, kk, kk, float(done_k[kk]), cluster_ref(kk))
                n_corr += int(bad)

        # deadline / quorum close on the tier-1 barrier: late members are
        # stragglers (carried as stale deltas or discarded)
        n_exp, n_strag = 0, 0
        t_close = None
        if self._deadline_on:
            elig = np.ones(K, bool) if ok is None else np.asarray(ok, bool)
            t_close, on_time, expired = self._close_round(t, done_k, elig)
            if expired:
                n_exp = 1
                late_members = np.nonzero(elig & ~on_time)[0]
                n_strag = int(len(late_members))
                if cfg.late_policy == "carry":
                    for kk in late_members:
                        self._carry_straggler(trained, int(kk),
                                              cluster_ref(int(kk)),
                                              float(done_k[kk]), r, int(kk))
                ok = on_time if ok is None else (ok & on_time)
            if sched.pairs_skipped:
                n_exp = 1   # tier-2 exchanges were cut short by the close

        # tier 2: all-to-all exchange -> constellation-wide model (the
        # exchanged cluster models cross ISLs quantized when quant_bits>0)
        n_clip = 0
        if ok is None:
            stacked_clusters = segment_mean(trained, C)
            self.global_params, n_clip = self._aggregate(
                stacked_clusters, np.full(C, float(spc)))
            self.cluster_params = _broadcast(self.global_params, C)
        else:
            w = ok.astype(np.float64)
            seg_w = w.reshape(C, spc).sum(1)   # eligible sats per cluster
            if seg_w.sum() > 0:
                stacked_clusters = segment_weighted_mean(trained, w, C)
                # clusters with no eligible member carry zero tier-2 weight
                self.global_params, n_clip = self._aggregate(
                    stacked_clusters, seg_w)
                self.cluster_params = _broadcast(self.global_params, C)
            # else: the whole fleet sat out; models unchanged, the round
            # still advances time

        # timing: training overlaps the exchange chain; the round ends when
        # both the last pairwise pass and the participants' training are
        # done (at the close in deadline mode)
        if t_close is not None:
            t_train_done = float(t_close)
        elif ok is not None and ok.any():
            t_train_done = float(np.max(done_k[ok]))
        else:
            t_train_done = float(np.max(done_k))
        t_round_end = max(sched.t_complete, t_train_done)
        idle = max(t_round_end - t_train_done, 0.0)
        # fold stale straggler deltas that landed by this round's end,
        # then refresh the per-cluster copies of the patched global model
        if self._carried and self._fold_carried(t_round_end, r):
            self.cluster_params = _broadcast(self.global_params, C)
        participants = list(range(K))
        if ok is not None:
            participants = [k for k in range(K) if ok[k]]
        wh, skipped = 0.0, 0
        if energy_ok is not None:
            skipped = int(np.sum(~energy_ok))
            self.energy.advance_to(t_round_end)
            ksel = np.asarray(participants, np.int64)
            wh = self.energy.bill_activity(
                ksel, train_time_k[ksel], intra_comm_k[ksel]) \
                if len(ksel) else 0.0
        acc = self._accuracy(r)
        # per-member comm: own intra-cluster exchanges + this member's
        # share of the tier-2 pass chain; record means cover the
        # participants
        comm_k = intra_comm_k * 2 \
            + len(sched.passes) * self._t_isl_k * 2.0 / max(C, 1)
        psel = np.asarray(participants, np.int64)
        comm_rec = _fleet_mean(comm_k[psel]) if len(psel) else 0.0
        train_rec = _fleet_mean(train_time_k[psel]) if len(psel) else 0.0
        return RoundRecord(r, t, t_round_end, t_round_end - t, idle,
                           comm_rec, train_rec, acc, participants,
                           epochs=float(np.mean(ep_k)) if ep_k is not None
                           else float(e), energy_wh=wh,
                           skipped_low_power=skipped,
                           comm_s_by_sat={k: float(comm_k[k])
                                          for k in participants},
                           skipped_faulted=n_flt,
                           dropped_contacts=sched.dropped_contacts,
                           retransmit_bytes=sched.retransmit_bytes,
                           corrupted_updates=n_corr,
                           clipped_updates=n_clip,
                           deadline_expired=n_exp,
                           stragglers_carried=n_strag,
                           retries_exhausted=sched.retries_exhausted,
                           storm_events=self._storms_in(t, t_round_end))
