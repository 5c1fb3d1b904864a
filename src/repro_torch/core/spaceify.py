"""The space-ification framework (paper §3.1) + augmentations (§3.2).

Space-ification of an FL algorithm = three modular revisions:
  1. client selection: first C idle clients to contact a ground station;
  2. round completion: wait until every selected client re-contacts a GS to
     return weights (no always-on links);
  3. evaluation clients re-selected with the same contact protocol.

Augmentations: ``scheduled`` (FLSchedule, Alg. 5) and ``intra_sl``
(FLIntraSL, Alg. 6), selected by ``FLConfig.selection``.

Port of the JAX package's ``core/spaceify.py``: ``FLConfig``,
``RoundRecord``, the shared engine ``SpaceifiedFL``, ``FedAvgSat``
(Alg. 1), ``FedProxSat`` (Alg. 3, partial updates + proximal term; V2 adds
a minimum-epoch floor) and ``FedBuffSat`` (Alg. 4, asynchronous buffered
aggregation with staleness discounting). The round clock, projections and
selection are the reference's numpy code, so every timing, selection and
byte field of a ``RoundRecord`` comes out bitwise as there. Training and
aggregation run in torch on the dataset's device. With ``quant_bits > 0``
every returned cohort of a synchronous round is aggregated through kernel
K1; ``FLConfig.aggregator`` swaps in a Byzantine-robust estimator
(``core/aggregation.py``), whose coordinate-wise trimmed mean and median
run through kernel K2.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: the energy and fault layers of the reference's ``FLConfig``
(``energy``, ``faults``, a finite ``round_deadline_s``, ``max_retries``).
They come with the engine's optional-layer slice (Slice B, ROADMAP
queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (apply_buffered_deltas,
                                          make_robust_aggregator,
                                          quantized_weighted_average,
                                          robust_apply_buffered_deltas,
                                          weighted_average)
from repro_torch.core.client import local_sgd, local_sgd_clients
from repro_torch.core.contact_plan import ContactPlan
from repro_torch.core.policy import PolicyInputs, resolve_policy, select_top
from repro_torch.core.quantize import (quantize_roundtrip,
                                       quantize_roundtrip_stacked,
                                       transmit_bytes)
from repro_torch.models.small import MODELS, accuracy
from repro_torch.rng import TorchRandom
from repro_torch.sim.events import (CLIENT_RETURN, ROUND_BARRIER, TRAIN_DONE,
                                    EventQueue, WorldTimeline)
from repro_torch.sim.hardware import FleetProfile, HardwareProfile

#: where the layers the port still refuses will land (ROADMAP queue 1)
NEXT_SLICE = "the engine's optional-layer slice (Slice B, ROADMAP queue 1)"


@dataclasses.dataclass
class RoundRecord:
    """One completed FL round's bookkeeping (a ``SimResult`` is a list of
    these). Same fields as the reference's record; the fields of layers
    this port does not have yet (energy, faults, deadlines, policy skips)
    stay at their defaults."""
    round: int
    t_start: float
    t_end: float
    duration_s: float
    idle_s: float              # mean satellite idle time in the round
    comm_s: float              # mean communication time
    train_s: float             # mean on-board compute time
    accuracy: float
    participants: List[int]
    epochs: float = 0.0
    energy_wh: float = 0.0
    skipped_low_power: int = 0
    # per-participant communication seconds {sat: s}
    comm_s_by_sat: Dict[int, float] = dataclasses.field(default_factory=dict)
    skipped_faulted: int = 0
    dropped_contacts: int = 0
    retransmit_bytes: float = 0.0
    corrupted_updates: int = 0
    clipped_updates: int = 0
    deadline_expired: int = 0
    stragglers_carried: int = 0
    retries_exhausted: int = 0
    storm_events: int = 0
    policy_deferred: int = 0
    policy_skips: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FLConfig:
    """Knobs of the space-ified FL suite; the same fields and defaults as
    the reference's ``FLConfig`` (see its docstring for each knob).

    ``quant_kernel`` takes only ``"auto"`` here: the tensors' device picks
    the route of kernels K1 and K2 (the CUDA kernel on the card, its plain
    version on the CPU). ``aggregator``: None or "mean" keeps the plain
    weighted mean; a name in ``ROBUST_AGGREGATORS`` ("norm_clip" |
    "trimmed_mean" | "median" | "krum") or a ``RobustAggregator`` instance
    swaps in a Byzantine-robust estimator. ``seed`` seeds the engine's
    random source (model init and minibatch order, ``repro_torch.rng``)."""
    model: str = "cnn"
    clients_per_round: int = 10          # C (static cohort width)
    epochs: int = 2                      # E (FedAvg; cap for FedProx)
    batch_size: int = 32
    lr: float = 0.05
    prox_mu: float = 0.01
    min_epochs: int = 0                  # FedProxSchV2 floor
    max_local_epochs: int = 30
    buffer_size: int = 5                 # FedBuff D
    staleness_exponent: float = 0.5
    selection: str = "first_contact"     # | "scheduled" | "intra_sl"
    policy: Optional[object] = None      # None | name | SelectionPolicy
    quant_bits: int = 0                  # 0 => f32 transmission
    quant_kernel: str = "auto"           # the device decides
    max_rounds: int = 500
    seed: int = 0
    eval_every: int = 1
    energy: Optional[object] = None      # Slice B: must stay None
    faults: Optional[object] = None      # Slice B: must stay None
    aggregator: Optional[object] = None  # None | name | RobustAggregator
    round_deadline_s: float = float("inf")  # Slice B: must stay inf
    quorum: int = 1
    late_policy: str = "carry"
    max_retries: Optional[int] = None    # Slice B: must stay None


def check_supported(cfg: FLConfig) -> None:
    """Raise for every setting of ``cfg`` this slice of the port does not
    implement, instead of silently running without it."""
    later = []
    if cfg.energy is not None:
        later.append("energy")
    if cfg.faults is not None:
        later.append("faults")
    if np.isfinite(cfg.round_deadline_s):
        later.append("round_deadline_s")
    if cfg.max_retries is not None:
        later.append("max_retries")
    if later:
        raise NotImplementedError(
            f"FLConfig {', '.join(later)} not ported yet: the energy and "
            f"fault layers come with {NEXT_SLICE}")
    if cfg.quant_kernel != "auto":
        raise ValueError(f"quant_kernel {cfg.quant_kernel!r}: the port takes "
                         "only 'auto' (the tensors' device picks the route)")
    if not cfg.round_deadline_s > 0.0:
        raise ValueError("FLConfig.round_deadline_s must be > 0 "
                         "(inf disables the deadline)")


def _broadcast(params, n: int):
    """A dict of leaves -> the same leaves stacked n times (n, ...)."""
    return {k: p.expand((n,) + p.shape).clone() for k, p in params.items()}


class SpaceifiedFL:
    """Shared machinery for the orbital suite.

    ``random_source(cfg.seed)`` builds the engine's random source (model
    init and per-round client keys, ``repro_torch.rng``); the dataset's
    device is the engine's device."""

    name = "base"

    def __init__(self, plan: ContactPlan, hw, dataset, cfg: FLConfig,
                 random_source=TorchRandom):
        check_supported(cfg)
        self.fleet = FleetProfile.build(hw, plan.constellation.n_sats)
        self.hw = hw if isinstance(hw, HardwareProfile) else \
            self.fleet.primary
        self.plan, self.ds, self.cfg = plan, dataset, cfg
        self.device = dataset.x.device
        self.rng = random_source(cfg.seed)
        init_fn, self.apply_fn = MODELS[cfg.model]
        img_shape = tuple(dataset.x.shape[2:])
        self.global_params = init_fn(self.rng, img_shape, dataset.n_classes,
                                     device=self.device)
        self.tx_bytes = transmit_bytes(self.global_params, cfg.quant_bits)
        # (K,) per-satellite link times for the (fixed) wire size
        self._t_up_k = self.fleet.tx_time(self.tx_bytes, "uplink")
        self._t_down_k = self.fleet.tx_time(self.tx_bytes, "downlink")
        self._t_isl_k = self.fleet.tx_time(self.tx_bytes, "isl")
        self.records: List[RoundRecord] = []
        self.event_stats = None
        self._tx_cache = self._tx_cache_src = None
        # Byzantine-robust server; None keeps the plain weighted mean
        self.aggregator = make_robust_aggregator(cfg.aggregator)
        self.policy = resolve_policy(cfg.policy, cfg.selection)
        self._policy_skips: Dict[str, int] = {}

    # -- client selection (space-ification consideration 1 + augments) --
    def _projected_returns(self, t: float, epochs: float, base=None):
        """Batched projection of every satellite's round at ``t``: first
        contact, uplink, ``epochs`` of training and the return contact, in
        one vectorized pass through the contact-plan arrays. Returns a dict
        of (K,) arrays (the reference's keys; the energy and fault masks
        are all True).

        ``base``: a projection this engine already took at the same ``t``
        (any epoch count). Its first-contact query depends only on ``t``,
        so it is reused as it is and only the return leg re-runs
        (FedProx's floor projection)."""
        plan = self.plan
        if base is None:
            avail, end, gs, valid = plan.next_contacts(t)
            recv_end = avail + self._t_up_k
        else:
            avail, end, gs = (base["contact_avail"], base["contact_end"],
                              base["contact_gs"])
            valid, recv_end = base["first_valid"], base["recv_end"]
        train_end = recv_end + self.fleet.train_time(epochs)
        if self.cfg.selection == "intra_sl":
            r_avail, r_end, r_gs, relay, r_valid = \
                plan.next_cluster_contacts(train_end)
        else:
            r_avail, r_end, r_gs, r_valid = plan.next_contacts(train_end)
            relay = np.arange(len(r_avail))
        orbit_valid = valid & r_valid
        ones = np.ones(len(orbit_valid), bool)
        return {"contact_avail": avail, "contact_end": end, "contact_gs": gs,
                "recv_end": recv_end, "train_end": train_end,
                "ret_avail": r_avail, "ret_end": r_end, "ret_gs": r_gs,
                "relay": relay, "valid": orbit_valid,
                "orbit_valid": orbit_valid, "energy_ok": ones,
                "fault_ok": ones, "first_valid": valid}

    def _policy_inputs(self, proj, t: float, epochs: float) -> PolicyInputs:
        """Bundle the batched score inputs for the selection policy."""
        return PolicyInputs(t=float(t), epochs=float(epochs), proj=proj,
                            fleet=self.fleet, t_up_k=self._t_up_k,
                            t_down_k=self._t_down_k,
                            clients_per_round=self.cfg.clients_per_round,
                            round_deadline_s=self.cfg.round_deadline_s)

    def _select_from_projections(self, proj, t: float) -> List[int]:
        """The policy scores + gates the fleet, ``select_top`` picks the
        lowest ``clients_per_round`` scores, ties by satellite index."""
        cfg = self.cfg
        decision = self.policy.decide(
            self._policy_inputs(proj, t, cfg.epochs))
        self._policy_skips = {k: int(v) for k, v in decision.skips.items()
                              if v}
        return select_top(decision.score, decision.eligible,
                          cfg.clients_per_round)

    # -- transmission (live QuAFL wire format) ---------------------------
    def _tx_global(self):
        """The global model as the clients receive it over the uplink
        (memoized per global-params version)."""
        if not self.cfg.quant_bits:
            return self.global_params
        if self._tx_cache_src is not self.global_params:
            self._tx_cache = quantize_roundtrip(self.global_params,
                                                self.cfg.quant_bits)
            self._tx_cache_src = self.global_params
        return self._tx_cache

    def _aggregate(self, stacked, weights):
        """Server-side aggregation of a returned (stacked) cohort. Returns
        ``(params, n_attenuated)``: the robust estimator's attenuated or
        rejected row count, 0 on the plain mean.

        The robust path first round-trips a quantized cohort through the
        wire format, so the estimator sees what the radio delivered
        (kernel K2 for the rank-based estimators, no K1). The plain path
        runs through kernel K1 with quantization on, the order-pinned
        weighted mean otherwise."""
        bits = self.cfg.quant_bits
        if self.aggregator is not None:
            if bits:
                stacked = quantize_roundtrip_stacked(stacked, bits)
            return self.aggregator.aggregate(stacked, weights,
                                             self._tx_global())
        if bits:
            return quantized_weighted_average(stacked, weights, bits), 0
        return weighted_average(stacked, weights), 0

    # -- fixed-shape training dispatch -----------------------------------
    def _cohort_perms(self, keys, n_epochs: int):
        """(W, n_epochs, n) minibatch orders of the client ``keys``."""
        n = self.ds.n_per_client
        return torch.stack([self.rng.permutations(k, n, n_epochs)
                            for k in keys]).to(self.device)

    def _train_cohort(self, sel: List[int], epochs, prox: bool = False):
        """Train ``sel`` inside a padded cohort of static width
        ``cfg.clients_per_round``. Pad slots replay client 0 with the first
        client key, train 1 epoch and get weight 0, so they vanish from
        the aggregate. ``epochs`` is a count or one per selected client;
        ``prox`` adds FedProx's proximal term towards the broadcast model.
        Returns (stacked trained params (W, ...), weights (W,))."""
        cfg = self.cfg
        W, m = cfg.clients_per_round, len(sel)
        keys = self.rng.round_keys(m)
        keys = list(keys) + [keys[0]] * (W - m)
        idx = np.zeros(W, np.int64)
        idx[:m] = sel
        ep = np.ones(W, np.int32)
        ep[:m] = epochs
        gather = torch.as_tensor(idx, device=self.device)
        tx_global = self._tx_global()
        trained = local_sgd_clients(
            cfg.model, _broadcast(tx_global, W), self.ds.x[gather],
            self.ds.y[gather], self._cohort_perms(keys, int(ep.max())), ep,
            cfg.batch_size, cfg.lr, mu=cfg.prox_mu if prox else 0.0,
            global_params=tx_global if prox else None)
        n_k = np.zeros(W, np.float64)
        n_k[:m] = self.ds.n_per_client
        return trained, n_k

    # -- evaluation ------------------------------------------------------
    def evaluate(self) -> float:
        return accuracy(self.apply_fn, self.global_params,
                        self.ds.x_test, self.ds.y_test)

    def _accuracy(self, r: int) -> float:
        if r % self.cfg.eval_every == 0:
            return self.evaluate()
        return self.records[-1].accuracy if self.records else 0.0

    # -- main loop (discrete-event core) ---------------------------------
    def run(self, t0: float = 0.0, t_end: Optional[float] = None,
            max_rounds: Optional[int] = None):
        """Event-driven main loop: ROUND_BARRIER decision events on a
        deterministic ``EventQueue`` fire ``run_round``; the contact-window
        events between barriers resolve in one batched
        ``WorldTimeline.advance_through`` pass per round."""
        t_end = t_end if t_end is not None else self.plan.horizon_s
        max_rounds = max_rounds or self.cfg.max_rounds
        queue = EventQueue()
        queue.push(t0, ROUND_BARRIER)
        timeline = WorldTimeline.for_fl(self.plan)
        self.event_stats = st = timeline.stats
        r = 0
        while queue and r < max_rounds:
            ev = queue.pop()
            if ev.t >= t_end:
                break
            st.add(ROUND_BARRIER)
            rec = self.run_round(r, ev.t)
            if rec is None:
                break
            self.records.append(rec)
            timeline.advance_through(rec.t_end)
            st.add(TRAIN_DONE, len(rec.participants))
            queue.push(rec.t_end, ROUND_BARRIER)
            r += 1
        return self.records

    def run_round(self, r: int, t: float) -> Optional[RoundRecord]:
        raise NotImplementedError


class FedAvgSat(SpaceifiedFL):
    """Algorithm 1 (+ FLSchedule / FLIntraSL via cfg.selection)."""

    name = "fedavg"

    def run_round(self, r, t):
        cfg = self.cfg
        proj = self._projected_returns(t, cfg.epochs)
        sel = self._select_from_projections(proj, t)
        pol_skips = self._policy_skips
        if not sel:
            return None
        # train selected clients (padded cohort, same epoch count:
        # synchronous)
        trained, n_k = self._train_cohort(sel, cfg.epochs)

        ks = np.asarray(sel)
        ends = proj["ret_avail"][ks] + self._t_down_k[ks]
        # a return window already open at train end means zero idle
        idles = (proj["contact_avail"][ks] - t) \
            + np.maximum(proj["ret_avail"][ks] - proj["train_end"][ks], 0.0)
        comms = self._t_up_k[ks] + self._t_down_k[ks]
        trains = proj["train_end"][ks] - proj["recv_end"][ks]
        # the server waits for every delivery (wait-for-all)
        t_round_end = float(ends.max())
        self.global_params, n_clip = self._aggregate(trained, n_k)
        acc = self._accuracy(r)
        return RoundRecord(r, t, t_round_end, t_round_end - t,
                           float(np.mean(idles)), float(np.mean(comms)),
                           float(np.mean(trains)), acc, sel,
                           epochs=cfg.epochs,
                           comm_s_by_sat=dict(zip(sel, comms.tolist())),
                           clipped_updates=n_clip,
                           policy_deferred=sum(pol_skips.values()),
                           policy_skips=pol_skips)


class FedProxSat(SpaceifiedFL):
    """Algorithm 3: partial updates — each client trains until it reaches a
    ground station; a proximal term bounds local drift. V2 (min_epochs>0)
    enforces a minimum-epoch floor before returning (paper §5.1.1).

    Per-client epoch budgets come from ONE batched floor projection over
    the contact plan; a selected client whose floor-epoch return contact
    never materializes is dropped from the round (the round only fails if
    nobody can return)."""

    name = "fedprox"

    def run_round(self, r, t):
        cfg = self.cfg
        proj = self._projected_returns(t, cfg.epochs)
        sel = self._select_from_projections(proj, t)
        pol_skips = self._policy_skips
        if not sel:
            return None
        floor_ep = max(cfg.min_epochs, 1)
        # the floor projection reuses the selection projection's first
        # contacts and re-runs only the return leg; when the floor equals
        # the selection epoch count the two coincide
        projf = proj if floor_ep == cfg.epochs else \
            self._projected_returns(t, floor_ep, base=proj)
        # refilter under the floor projection through the policy's
        # eligibility (for the built-ins this is projf["valid"])
        floor_ok = self.policy.decide(
            self._policy_inputs(projf, t, floor_ep)).eligible
        sel = [k for k in sel if floor_ok[k]]
        if not sel:
            return None
        ks = np.asarray(sel)
        recv_end = projf["recv_end"][ks]
        ep = np.clip(((projf["ret_avail"][ks] - recv_end)
                      // self.fleet.epoch_time_s[ks]).astype(np.int64),
                     floor_ep, cfg.max_local_epochs).astype(np.int32)
        train_end = recv_end + self.fleet.epoch_time_s[ks] * ep
        trained, n_k = self._train_cohort(sel, ep, prox=True)

        ends = projf["ret_avail"][ks] + self._t_down_k[ks]
        idles = (projf["contact_avail"][ks] - t) \
            + np.maximum(projf["ret_avail"][ks] - train_end, 0.0)
        comms = self._t_up_k[ks] + self._t_down_k[ks]
        trains = train_end - recv_end
        # the server waits for every delivery (wait-for-all)
        t_round_end = float(ends.max())
        self.global_params, n_clip = self._aggregate(trained, n_k)
        acc = self._accuracy(r)
        return RoundRecord(r, t, t_round_end, t_round_end - t,
                           float(np.mean(idles)), float(np.mean(comms)),
                           float(np.mean(trains)), acc, sel,
                           epochs=float(np.mean(ep)),
                           comm_s_by_sat=dict(zip(sel, comms.tolist())),
                           clipped_updates=n_clip,
                           policy_deferred=sum(pol_skips.values()),
                           policy_skips=pol_skips)


class FedBuffSat(SpaceifiedFL):
    """Algorithm 4: asynchronous buffered aggregation. Clients train
    continuously between ground contacts; the server folds in updates with
    staleness discounting and completes a "round" when the buffer holds
    ``buffer_size`` updates. The flush is one stacked delta reduction
    (``apply_buffered_deltas``, or the robust estimator's).

    Pending deliveries live on a deterministic ``EventQueue`` of
    CLIENT_RETURN events ordered ``(t, priority, sat, seq)``. Each
    processed return trains one client (``local_sgd``, always with the
    proximal term towards the version it picked up) with one key from the
    random source's ``event_key``, in pop order."""

    name = "fedbuff"

    def _flush_buffer(self, buf) -> int:
        """Fold a full buffer into the global model; returns the robust
        estimator's attenuated row count (0 on the plain flush)."""
        names = list(self.global_params)
        stacked_new = {k: torch.stack([b[0][k] for b in buf])
                       for k in names}
        stacked_base = {k: torch.stack([b[1][k] for b in buf])
                        for k in names}
        wgts = np.asarray([b[2] for b in buf], np.float32)
        if self.aggregator is not None:
            self.global_params, n_clip = robust_apply_buffered_deltas(
                self.global_params, stacked_new, stacked_base, wgts,
                self.aggregator)
            return n_clip
        self.global_params = apply_buffered_deltas(
            self.global_params, stacked_new, stacked_base, wgts)
        return 0

    def run(self, t0: float = 0.0, t_end: Optional[float] = None,
            max_rounds: Optional[int] = None):
        cfg, plan = self.cfg, self.plan
        t_end = t_end if t_end is not None else plan.horizon_s
        max_rounds = max_rounds or cfg.max_rounds
        K = plan.constellation.n_sats
        n = self.ds.n_per_client
        ep_s = self.fleet.epoch_time_s            # (K,) per-satellite
        queue = EventQueue()
        timeline = WorldTimeline.for_fl(plan)
        self.event_stats = st = timeline.stats
        # client states: params version picked up, pickup round, epochs,
        # idle gap between train end and the return window
        client_params: Dict[int, dict] = {}
        pickup_round: Dict[int, int] = {}
        epochs_of: Dict[int, int] = {}
        idle_of: Dict[int, float] = {}
        # seed the fleet with one batched contact-plan pass
        avail, _, _, valid = plan.next_contacts(np.full(K, t0))
        recv_end_k = avail + self._t_up_k
        ret_avail, _, _, ret_valid = plan.next_contacts(
            np.where(valid, recv_end_k + ep_s, np.inf))
        for k in range(K):
            if not (valid[k] and ret_valid[k]):
                continue
            recv_end, ret0 = float(recv_end_k[k]), float(ret_avail[k])
            ep = int(np.clip((ret0 - recv_end) // ep_s[k], 1,
                             cfg.max_local_epochs))
            queue.push(ret0 + float(self._t_down_k[k]), CLIENT_RETURN, key=k)
            client_params[k] = self._tx_global()
            pickup_round[k] = 0
            epochs_of[k] = ep
            idle_of[k] = max(ret0 - (recv_end + ep * float(ep_s[k])), 0.0)

        buf, r = [], 0
        t_round_start = t0
        idle_acc, comm_acc, train_acc, n_ev = 0.0, 0.0, 0.0, 0
        comm_by: Dict[int, float] = {}
        while queue and r < max_rounds:
            ev = queue.pop()
            t_ret, k = ev.t, ev.key
            if t_ret > t_end:
                break
            timeline.advance_through(t_ret)
            st.add(CLIENT_RETURN)
            t_up, t_down = float(self._t_up_k[k]), float(self._t_down_k[k])
            train_s = epochs_of[k] * float(ep_s[k])
            perms = self.rng.permutations(self.rng.event_key(), n,
                                          epochs_of[k])
            trained = local_sgd(cfg.model, client_params[k], self.ds.x[k],
                                self.ds.y[k], perms, epochs_of[k],
                                cfg.batch_size, cfg.lr, mu=cfg.prox_mu,
                                global_params=client_params[k])
            if cfg.quant_bits:      # the returned model crosses the radio
                trained = quantize_roundtrip(trained, cfg.quant_bits)
            stale = r - pickup_round[k]
            wgt = (1.0 + stale) ** (-cfg.staleness_exponent)
            buf.append((trained, client_params[k], wgt))
            comm_acc += t_up + t_down
            comm_by[k] = comm_by.get(k, 0.0) + t_up + t_down
            train_acc += train_s
            idle_acc += idle_of.get(k, 0.0)
            n_ev += 1
            st.add(TRAIN_DONE)
            # the client picks up the current global at this contact and
            # trains on until its next return window
            recv_end = t_ret + t_up
            nxt = self.plan.next_contact(k, recv_end + float(ep_s[k]))
            if nxt is not None:
                ep = int(np.clip((nxt[0] - recv_end) // ep_s[k], 1,
                                 cfg.max_local_epochs))
                queue.push(float(nxt[0]) + t_down, CLIENT_RETURN, key=k)
                client_params[k] = self._tx_global()
                pickup_round[k] = r
                epochs_of[k] = ep
                idle_of[k] = max(nxt[0] - (recv_end + ep * float(ep_s[k])),
                                 0.0)

            if len(buf) >= cfg.buffer_size:
                st.add(ROUND_BARRIER)
                n_clip = self._flush_buffer(buf)
                buf = []
                acc = self._accuracy(r)
                self.records.append(RoundRecord(
                    r, t_round_start, t_ret, t_ret - t_round_start,
                    idle_acc / max(n_ev, 1), comm_acc / max(n_ev, 1),
                    train_acc / max(n_ev, 1), acc, [],
                    epochs=float(np.mean(list(epochs_of.values())))
                    if epochs_of else 0.0,
                    comm_s_by_sat=comm_by, clipped_updates=n_clip))
                t_round_start = t_ret
                idle_acc = comm_acc = train_acc = 0.0
                comm_by = {}
                n_ev = 0
                r += 1
        return self.records


ALGORITHMS = {
    "fedavg": (FedAvgSat, {}),
    "fedavg_sch": (FedAvgSat, {"selection": "scheduled"}),
    "fedavg_intrasl": (FedAvgSat, {"selection": "intra_sl"}),
    "fedprox": (FedProxSat, {}),
    "fedprox_sch": (FedProxSat, {"selection": "scheduled"}),
    "fedprox_schv2": (FedProxSat, {"selection": "scheduled", "min_epochs": 2}),
    "fedprox_intrasl": (FedProxSat, {"selection": "intra_sl"}),
    "fedbuff": (FedBuffSat, {}),
}
