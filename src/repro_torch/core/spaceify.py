"""The space-ification framework (paper §3.1) + augmentations (§3.2).

Space-ification of an FL algorithm = three modular revisions:
  1. client selection: first C idle clients to contact a ground station;
  2. round completion: wait until every selected client re-contacts a GS to
     return weights (no always-on links);
  3. evaluation clients re-selected with the same contact protocol.

Augmentations: ``scheduled`` (FLSchedule, Alg. 5) and ``intra_sl``
(FLIntraSL, Alg. 6), selected by ``FLConfig.selection``.

Port of the JAX package's ``core/spaceify.py``: ``FLConfig``,
``RoundRecord``, the shared engine ``SpaceifiedFL`` and ``FedAvgSat``
(Alg. 1). The round clock, projections and selection are the reference's
numpy code, so every timing, selection and byte field of a
``RoundRecord`` comes out bitwise as there. Training and aggregation run
in torch on the dataset's device; with ``quant_bits > 0`` every returned
cohort is aggregated through kernel K1 (``core/aggregation.py``).

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: FedProxSat and FedBuffSat, and the optional layers of the
reference's ``FLConfig`` (``energy``, ``faults``, ``aggregator``, a finite
``round_deadline_s``, ``max_retries``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (quantized_weighted_average,
                                          weighted_average)
from repro_torch.core.client import local_sgd_clients
from repro_torch.core.contact_plan import ContactPlan
from repro_torch.core.policy import PolicyInputs, resolve_policy, select_top
from repro_torch.core.quantize import quantize_roundtrip, transmit_bytes
from repro_torch.models.small import MODELS, accuracy
from repro_torch.rng import TorchRandom
from repro_torch.sim.events import (ROUND_BARRIER, TRAIN_DONE, EventQueue,
                                    WorldTimeline)
from repro_torch.sim.hardware import FleetProfile, HardwareProfile

#: where the engines the port refuses will land (ROADMAP queue 1)
NEXT_SLICE = "the next slice of the port (ROADMAP queue 1)"


@dataclasses.dataclass
class RoundRecord:
    """One completed FL round's bookkeeping (a ``SimResult`` is a list of
    these). Same fields as the reference's record; the fields of layers
    this port does not have yet (energy, faults, deadlines, robust
    aggregation, policy skips) stay at their defaults."""
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
    the route of kernel K1 (the CUDA kernel on the card, its plain version
    on the CPU). ``seed`` seeds the engine's random source (model init and
    minibatch order, ``repro_torch.rng``)."""
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
    energy: Optional[object] = None      # not ported: must stay None
    faults: Optional[object] = None      # not ported: must stay None
    aggregator: Optional[object] = None  # not ported: None or "mean"
    round_deadline_s: float = float("inf")  # not ported: must stay inf
    quorum: int = 1
    late_policy: str = "carry"
    max_retries: Optional[int] = None    # not ported: must stay None


def check_supported(cfg: FLConfig) -> None:
    """Raise for every setting of ``cfg`` this slice of the port does not
    implement, instead of silently running without it."""
    later = []
    if cfg.energy is not None:
        later.append("energy")
    if cfg.faults is not None:
        later.append("faults")
    if cfg.aggregator not in (None, "mean"):
        later.append("aggregator")
    if np.isfinite(cfg.round_deadline_s):
        later.append("round_deadline_s")
    if cfg.max_retries is not None:
        later.append("max_retries")
    if later:
        raise NotImplementedError(
            f"FLConfig {', '.join(later)} not ported yet: the optional "
            "engine layers come with Slice B of the port (ROADMAP queue 1)")
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
        self.policy = resolve_policy(cfg.policy, cfg.selection)
        self._policy_skips: Dict[str, int] = {}

    # -- client selection (space-ification consideration 1 + augments) --
    def _projected_returns(self, t: float, epochs: float):
        """Batched projection of every satellite's round at ``t``: first
        contact, uplink, ``epochs`` of training and the return contact, in
        one vectorized pass through the contact-plan arrays. Returns a dict
        of (K,) arrays (the reference's keys; the energy and fault masks
        are all True)."""
        plan = self.plan
        avail, end, gs, valid = plan.next_contacts(t)
        recv_end = avail + self._t_up_k
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

    def _select_from_projections(self, proj, t: float) -> List[int]:
        """The policy scores + gates the fleet, ``select_top`` picks the
        lowest ``clients_per_round`` scores, ties by satellite index."""
        cfg = self.cfg
        decision = self.policy.decide(PolicyInputs(
            t=float(t), epochs=float(cfg.epochs), proj=proj,
            fleet=self.fleet, t_up_k=self._t_up_k, t_down_k=self._t_down_k,
            clients_per_round=cfg.clients_per_round,
            round_deadline_s=cfg.round_deadline_s))
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
        """Server-side aggregation of a returned (stacked) cohort: through
        kernel K1 with quantization on, the order-pinned weighted mean
        otherwise."""
        if self.cfg.quant_bits:
            return quantized_weighted_average(stacked, weights,
                                              self.cfg.quant_bits)
        return weighted_average(stacked, weights)

    # -- fixed-shape training dispatch -----------------------------------
    def _cohort_perms(self, keys, n_epochs: int):
        """(W, n_epochs, n) minibatch orders of the client ``keys``."""
        n = self.ds.n_per_client
        return torch.stack([self.rng.permutations(k, n, n_epochs)
                            for k in keys]).to(self.device)

    def _train_cohort(self, sel: List[int], epochs):
        """Train ``sel`` inside a padded cohort of static width
        ``cfg.clients_per_round``. Pad slots replay client 0 with the first
        client key and get weight 0, so they vanish from the aggregate.
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
        trained = local_sgd_clients(
            cfg.model, _broadcast(self._tx_global(), W), self.ds.x[gather],
            self.ds.y[gather], self._cohort_perms(keys, int(ep.max())), ep,
            cfg.batch_size, cfg.lr)
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
        self.global_params = self._aggregate(trained, n_k)
        acc = self._accuracy(r)
        return RoundRecord(r, t, t_round_end, t_round_end - t,
                           float(np.mean(idles)), float(np.mean(comms)),
                           float(np.mean(trains)), acc, sel,
                           epochs=cfg.epochs,
                           comm_s_by_sat=dict(zip(sel, comms.tolist())),
                           policy_deferred=sum(pol_skips.values()),
                           policy_skips=pol_skips)


class _NotPorted(SpaceifiedFL):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet: it comes with "
            f"{NEXT_SLICE}")


class FedProxSat(_NotPorted):
    """Algorithm 3 — not ported yet (raises)."""
    name = "fedprox"


class FedBuffSat(_NotPorted):
    """Algorithm 4 — not ported yet (raises)."""
    name = "fedbuff"


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
