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

The optional layers are the reference's, with the same numpy code:

* ``FLConfig.energy`` — battery state-of-charge gating
  (``repro_torch.sim.energy.EnergySim``): satellites below the SoC floor
  at selection time are ANDed out of the projection's validity mask and
  become zero-weight pad slots; each round bills its participants' FL
  energy.
* ``FLConfig.faults`` — fault injection (``repro_torch.sim.faults``):
  outages in the same mask, per-contact drops retried at the next usable
  window with the bytes re-billed, radiation resets that lose the update,
  SEU corruption and poisoning of delivered payloads, correlated storms.
  A lost update keeps its slot with weight 0, so a quantized cohort still
  goes through K1 in one launch, and a robust one through K2's validity
  mask.
* ``round_deadline_s`` / ``quorum`` / ``late_policy`` — deadline rounds:
  the round closes at ``t + round_deadline_s`` (stretched to the
  ``quorum``-th delivery); later deliveries are stragglers, carried into
  a later round as stale deltas or discarded.
* ``max_retries`` — a bounded drop-retry walk with window-level
  exponential backoff.

Every fault draw is a counter-based ``np.random.default_rng`` stream keyed
by ``FaultConfig.seed`` (noise drawn in float64 by numpy, then cast to the
leaf's dtype), so the faults and every non-accuracy field of a
``RoundRecord`` come out bitwise as in the reference, on the card as on
the CPU.
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
from repro_torch.sim.energy import EnergyConfig, EnergySim
from repro_torch.sim.events import (CLIENT_RETURN, ROUND_BARRIER, TRAIN_DONE,
                                    EventQueue, WorldTimeline)
from repro_torch.sim.faults import FaultConfig, FaultSim
from repro_torch.sim.hardware import FleetProfile, HardwareProfile


@dataclasses.dataclass
class RoundRecord:
    """One completed FL round's bookkeeping (a ``SimResult`` is a list of
    these). Same fields as the reference's record: the energy, fault,
    deadline and policy fields stay at their defaults when their layer is
    off."""
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
    energy_wh: float = 0.0     # added FL energy billed this round (fleet sum)
    skipped_low_power: int = 0  # orbit-eligible sats masked by the floor
    # per-participant communication seconds {sat: s}
    comm_s_by_sat: Dict[int, float] = dataclasses.field(default_factory=dict)
    skipped_faulted: int = 0       # outage-masked candidates + lost updates
    dropped_contacts: int = 0      # transmission attempts lost to drops
    retransmit_bytes: float = 0.0  # bytes re-billed by retried transmissions
    corrupted_updates: int = 0     # delivered updates corrupted or poisoned
    clipped_updates: int = 0       # rows the robust aggregator set aside
    deadline_expired: int = 0      # 1 when the deadline closed the round
    stragglers_carried: int = 0    # deliveries past the close
    retries_exhausted: int = 0     # walks abandoned at the retry budget
    storm_events: int = 0          # correlated storms breaking this round
    policy_deferred: int = 0       # candidates the policy deferred/demoted
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
    random source (model init and minibatch order, ``repro_torch.rng``);
    ``faults.seed`` seeds the independent numpy stream of every fault
    draw.

    ``energy`` (an ``EnergyConfig``), ``faults`` (a ``FaultConfig``;
    ``faults.attack`` needs ``energy``), ``round_deadline_s`` (inf: wait
    for all), ``quorum``, ``late_policy`` ("carry" | "discard") and
    ``max_retries`` (None: unbounded, up to ``_WALK_ATTEMPT_CAP``) switch
    on the optional layers, with the reference's checks."""
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
    energy: Optional[EnergyConfig] = None   # battery SoC gating
    faults: Optional[FaultConfig] = None    # fault injection
    aggregator: Optional[object] = None  # None | name | RobustAggregator
    round_deadline_s: float = float("inf")  # inf => wait-for-all rounds
    quorum: int = 1                # min deliveries before a deadline close
    late_policy: str = "carry"     # stragglers: "carry" | "discard"
    max_retries: Optional[int] = None   # drop-retry budget (None=unbounded)


def check_supported(cfg: FLConfig) -> None:
    """The reference's ``FLConfig`` checks, plus the port's one
    restriction: ``quant_kernel`` must be ``"auto"``."""
    if cfg.quant_kernel != "auto":
        raise ValueError(f"quant_kernel {cfg.quant_kernel!r}: the port takes "
                         "only 'auto' (the tensors' device picks the route)")
    if cfg.faults is not None and cfg.faults.attack is not None \
            and cfg.energy is None:
        raise ValueError("FaultConfig.attack requires FLConfig.energy: the "
                         "energy-drain attack targets batteries")
    if not cfg.round_deadline_s > 0.0:
        raise ValueError("FLConfig.round_deadline_s must be > 0 "
                         "(inf disables the deadline)")
    if cfg.quorum < 1:
        raise ValueError("FLConfig.quorum must be >= 1")
    if cfg.late_policy not in ("carry", "discard"):
        raise ValueError("FLConfig.late_policy must be 'carry' or "
                         f"'discard', got {cfg.late_policy!r}")
    if cfg.max_retries is not None and cfg.max_retries < 0:
        raise ValueError("FLConfig.max_retries must be >= 0 or None")


#: Hard safety cap on any drop-retry walk when ``max_retries`` is None: a
#: walk that drops this many consecutive passes is abandoned and counted
#: (``retries_exhausted``), not hidden. Unreachable under any realistic
#: drop rate (0.9^1000 ~ 1e-46).
_WALK_ATTEMPT_CAP = 1000

# ``lost`` codes of the drop-retry walks (both truthy)
_LOST_WINDOWS = 1      # horizon ran out of usable windows mid-walk
_LOST_RETRIES = 2      # the retry budget was exhausted


def _broadcast(params, n: int):
    """A dict of leaves -> the same leaves stacked n times (n, ...)."""
    return {k: p.expand((n,) + p.shape).clone() for k, p in params.items()}


def _stack(trees):
    """A list of dicts of leaves -> one dict of stacked leaves (n, ...)."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _poisoned(trained, reference, s: float):
    """The model-replacement payload ``(1+s)*ref - s*trained`` in float32,
    cast back to the trained leaf's dtype."""
    return ((1.0 + s) * reference.to(torch.float32)
            - s * trained.to(torch.float32)).to(trained.dtype)


def _seeded_noise(params, noise_seed: int, factor: float, lead: int = 0):
    """Large-magnitude SEU noise for each leaf of ``params``: float64
    standard normals from ``default_rng(noise_seed)`` times ``factor``,
    drawn leaf by leaf in sorted-name order (the reference's pytree
    order), cast to the leaf's dtype on the host, then moved to its
    device. ``lead`` leading axes of each leaf are not part of the draw's
    shape (1 for a row of a stacked cohort)."""
    rng = np.random.default_rng(noise_seed)
    out = {}
    for name in sorted(params):
        p = params[name]
        z = rng.standard_normal(tuple(p.shape[lead:])) * factor
        out[name] = torch.as_tensor(z).to(p.dtype).to(p.device)
    return out


class SpaceifiedFL:
    """Shared machinery for the orbital suite.

    ``random_source(cfg.seed)`` builds the engine's random source (model
    init and per-round client keys, ``repro_torch.rng``); the dataset's
    device is the engine's device, and the eclipse series of the battery
    simulation runs there too."""

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
        # battery SoC gating and fault injection; None skips every branch
        # of their layer
        self.energy: Optional[EnergySim] = None
        self.faults: Optional[FaultSim] = None
        if cfg.faults is not None:
            self.faults = FaultSim.for_plan(plan, cfg.faults)
        # Byzantine-robust server; None keeps the plain weighted mean
        self.aggregator = make_robust_aggregator(cfg.aggregator)
        self.policy = resolve_policy(cfg.policy, cfg.selection)
        self._policy_skips: Dict[str, int] = {}
        self._deadline_on = bool(np.isfinite(cfg.round_deadline_s))
        # stragglers carried past a deadline close, folded into a later
        # round as stale deltas: (row_params, base_params, t_deliver,
        # round_picked, sat)
        self._carried: List[tuple] = []
        if cfg.energy is not None:
            # shared-fleet invariant: unless EnergyConfig.fleet overrides,
            # the battery bills the hardware the timing schedules with
            self.energy = EnergySim.for_plan(
                plan, self.hw, cfg.energy, fleet=self.fleet.profiles,
                attack=cfg.faults.attack if cfg.faults is not None else None,
                device=self.device)

    # -- client selection (space-ification consideration 1 + augments) --
    def _projected_returns(self, t: float, epochs: float, base=None):
        """Batched projection of every satellite's round at ``t``: first
        contact, uplink, ``epochs`` of training and the return contact, in
        one vectorized pass through the contact-plan arrays. Returns a dict
        of (K,) arrays, with the battery-floor (``energy_ok``) and outage
        (``fault_ok``) masks ANDed into ``valid``.

        ``base``: a projection this engine already took at the same ``t``
        (any epoch count). Its first-contact query and its energy and
        fault masks depend only on ``t``, so they are reused as they are
        and only the return leg re-runs (FedProx's floor projection)."""
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
        if base is not None:
            energy_ok, fault_ok = base["energy_ok"], base["fault_ok"]
        else:
            if self.energy is not None:
                # SoC at selection time must clear the floor (advance_to
                # is idempotent at equal t)
                self.energy.advance_to(float(t))
                energy_ok = self.energy.eligible()
            else:
                energy_ok = np.ones(len(orbit_valid), bool)
            # a satellite inside an outage is masked like one below the
            # battery floor
            fault_ok = self.faults.available(t) if self.faults is not None \
                else np.ones(len(orbit_valid), bool)
        return {"contact_avail": avail, "contact_end": end, "contact_gs": gs,
                "recv_end": recv_end, "train_end": train_end,
                "ret_avail": r_avail, "ret_end": r_end, "ret_gs": r_gs,
                "relay": relay, "valid": orbit_valid & energy_ok & fault_ok,
                "orbit_valid": orbit_valid, "energy_ok": energy_ok,
                "fault_ok": fault_ok, "first_valid": valid}

    def _policy_inputs(self, proj, t: float, epochs: float) -> PolicyInputs:
        """Bundle the batched score inputs for the selection policy."""
        return PolicyInputs(t=float(t), epochs=float(epochs), proj=proj,
                            fleet=self.fleet, t_up_k=self._t_up_k,
                            t_down_k=self._t_down_k,
                            clients_per_round=self.cfg.clients_per_round,
                            round_deadline_s=self.cfg.round_deadline_s,
                            energy=self.energy, faults=self.faults,
                            engine=self)

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
        weighted mean otherwise. Lost, late and pad rows carry weight 0."""
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

    # -- fault resolution ------------------------------------------------
    def _next_available_contact(self, k: int, t: float):
        """``plan.next_contact`` that skips windows the satellite spends
        inside a fault outage (plain ``next_contact`` when faults, or
        outages, are off). A window whose outage ends mid-window starts
        late at the recovery time."""
        if not np.isfinite(t):
            return None
        if self.faults is None or not self.faults.cfg.has_outages:
            return self.plan.next_contact(k, t)
        tq = float(t)
        while True:
            w = self.plan.next_contact(k, tq)
            if w is None:
                return None
            up = float(self.faults.next_up(np.array([k]),
                                           np.array([w[0]]))[0])
            if up <= w[0]:
                return w
            if up < w[1]:
                return (up, w[1], w[2])
            tq = up                 # strictly past w[0]: walk terminates

    def _walk_drops(self, k: int, w_first):
        """Drop-retry walk of ``k``'s downlink from the usable window
        ``w_first`` (a ``(t_avail, end, gs)`` tuple): a dropped pass
        spends its airtime and re-acquires at the next usable pass.
        Returns ``(t_done, drops, rebill_bytes, lost)``: ``lost`` is 0
        (delivered), ``_LOST_WINDOWS`` (the horizon ran out of usable
        windows) or ``_LOST_RETRIES`` (``cfg.max_retries`` retries when
        set, else ``_WALK_ATTEMPT_CAP``). With ``max_retries`` set, retry
        ``j`` skips ``2**(j-1) - 1`` further usable passes first (shift
        clamped at 16): window-level exponential backoff."""
        t_down = float(self._t_down_k[k])
        bounded = self.cfg.max_retries is not None
        budget = self.cfg.max_retries if bounded else _WALK_ATTEMPT_CAP
        w, drops = w_first, 0
        while self.faults.contact_dropped(k, float(w[0])):
            drops += 1
            if drops > budget:
                return (float(w[0]) + t_down, drops,
                        max(drops - 1, 0) * self.tx_bytes, _LOST_RETRIES)
            nxt = self._next_available_contact(
                k, max(float(w[0]) + t_down, float(w[1])))
            if bounded:
                for _ in range((1 << min(drops - 1, 16)) - 1):
                    if nxt is None:
                        break
                    nxt = self._next_available_contact(k, float(nxt[1]))
            if nxt is None:
                return (float(w[0]) + t_down, drops,
                        max(drops - 1, 0) * self.tx_bytes, _LOST_WINDOWS)
            w = nxt
        return float(w[0]) + t_down, drops, drops * self.tx_bytes, 0

    def _faulted_return_legs(self, ks, recv_end, train_end, ends, comms):
        """Re-resolve the selected cohort's return downlinks under faults
        (sync engines): per client the first usable return window at or
        after train end, the drop-retry walk, then the radiation check (a
        reset in (recv_end, delivery] wipes the update). A delivered
        update with d drops bills uplink + (d+1) downlinks and re-bills
        d x tx_bytes; a client whose windows run out mid-walk bills the d
        attempts that keyed the radio; a wiped client bills its uplink
        only. Every non-delivered client gets aggregation weight 0.

        Returns ``(delivered (m,) 0/1 floats, ends, comms, n_faulted,
        drops, rebill_bytes, n_retries_exhausted)``."""
        m = len(ks)
        delivered = np.ones(m)
        ends, comms = ends.copy(), comms.copy()
        n_faulted, drops_total, rebill_total, n_rex = 0, 0, 0.0, 0
        check_resets = self.faults.cfg.has_resets
        for i in range(m):
            k = int(ks[i])
            t_up = float(self._t_up_k[k])
            w0 = self._next_available_contact(k, float(train_end[i]))
            if w0 is None:          # outages outlast every return window
                delivered[i], n_faulted = 0.0, n_faulted + 1
                ends[i], comms[i] = float(train_end[i]), t_up
                continue
            t_done, d, rb, lost = self._walk_drops(k, w0)
            if lost:
                delivered[i], n_faulted = 0.0, n_faulted + 1
                if lost == _LOST_RETRIES:
                    n_rex += 1
                ends[i], comms[i] = t_done, t_up + d * float(
                    self._t_down_k[k])
                drops_total += d
                rebill_total += rb
                continue
            if check_resets and self.faults.reset_in(
                    k, float(recv_end[i]), t_done):
                delivered[i], n_faulted = 0.0, n_faulted + 1
                ends[i], comms[i] = t_done, t_up
                continue
            ends[i] = t_done
            comms[i] += d * float(self._t_down_k[k])
            drops_total += d
            rebill_total += rb
        return (delivered, ends, comms, n_faulted, drops_total, rebill_total,
                n_rex)

    def _selection_faulted(self, proj) -> int:
        """Candidates masked *only* by an outage at selection time."""
        if self.faults is None:
            return 0
        return int(np.sum(proj["orbit_valid"] & proj["energy_ok"]
                          & ~proj["fault_ok"]))

    # -- deadline/quorum round close (graceful degradation) ---------------
    def _close_round(self, t: float, ends, delivered):
        """Round-close policy over the participants' delivery times.
        Returns ``(t_close, on_time, expired)``. With the deadline off the
        close is the latest delivered end (the latest end when nothing
        delivered). With a finite deadline the round closes at
        ``max(t + round_deadline_s, quorum-th delivery)``; a delivery
        after the close is a straggler (``on_time`` False)."""
        delivered = np.asarray(delivered, bool)
        natural = float(ends[delivered].max() if delivered.any()
                        else ends.max())
        if not self._deadline_on:
            return natural, delivered, False
        t_deadline = t + self.cfg.round_deadline_s
        if natural <= t_deadline or not delivered.any():
            return natural, delivered, False
        times = np.sort(ends[delivered])
        q = min(self.cfg.quorum, len(times))
        t_close = max(t_deadline, float(times[q - 1]))
        if t_close >= natural:
            return natural, delivered, False
        return t_close, delivered & (ends <= t_close), True

    def _carry_straggler(self, trained, i: int, base, t_deliver: float,
                         r: int, sat: int) -> None:
        """Bank row ``i`` of a stacked trained cohort as a straggler: its
        update (and the broadcast ``base`` it trained from) is folded into
        a later round once the clock passes its delivery time."""
        row = {k: p[i].clone() for k, p in trained.items()}
        self._carried.append((row, base, float(t_deliver), int(r), int(sat)))

    def _fold_carried(self, t_close: float, r: int) -> int:
        """Fold every carried straggler whose delivery time has passed into
        the global model as FedBuff-style stale deltas, discounted by
        ``(1 + r - r_orig)**(-staleness_exponent)``, through the robust
        estimator when one is configured. Returns the number folded."""
        if not self._carried:
            return 0
        due = [c for c in self._carried if c[2] <= t_close]
        if not due:
            return 0
        self._carried = [c for c in self._carried if c[2] > t_close]
        stacked_new = _stack([c[0] for c in due])
        stacked_base = _stack([c[1] for c in due])
        wgts = np.asarray(
            [(1.0 + max(r - c[3], 0)) ** (-self.cfg.staleness_exponent)
             for c in due], np.float32)
        if self.aggregator is not None:
            self.global_params, _ = robust_apply_buffered_deltas(
                self.global_params, stacked_new, stacked_base, wgts,
                self.aggregator)
        else:
            self.global_params = apply_buffered_deltas(
                self.global_params, stacked_new, stacked_base, wgts)
        return len(due)

    def _storms_in(self, t_from: float, t_to: float) -> int:
        """Correlated storms breaking in ``(t_from, t_to]`` (0 when faults
        or storms are off)."""
        if self.faults is None:
            return 0
        return self.faults.storms_between(t_from, t_to)

    # -- silent payload faults (SEU corruption + poisoning) --------------
    def _payload_fault(self, k: int, t_deliver: float):
        """``k``'s payload fault at ``t_deliver``: ("poison", scale),
        (mode, factor, noise_seed) of an SEU draw, or None. Poisoning
        takes precedence over the SEU draw."""
        fc = self.faults.cfg
        if fc.poison is not None and fc.poison.compromised(k):
            return ("poison", float(fc.poison.scale))
        return self.faults.corruption_at(k, t_deliver)

    def _corrupt_row(self, params, i: int, k: int, t_deliver: float,
                     reference):
        """Apply ``k``'s payload fault (if any) to row ``i`` of a stacked
        dict delivered at ``t_deliver``; ``reference`` is the model it
        trained from (the poison payload's anchor). Only row ``i`` is
        touched. Returns (params, was_bad)."""
        draw = self._payload_fault(k, t_deliver)
        if draw is None:
            return params, False
        mode, factor = draw[0], draw[1]
        if mode == "poison":
            rows = {n: _poisoned(p[i], reference[n], factor)
                    for n, p in params.items()}
        elif mode == "sign_flip":
            rows = {n: p[i] * -1.0 for n, p in params.items()}
        elif mode == "scale":
            rows = {n: p[i] * factor for n, p in params.items()}
        else:                           # large-magnitude seeded noise
            noise = _seeded_noise(params, draw[2], factor, lead=1)
            rows = {n: p[i] + noise[n] for n, p in params.items()}
        out = {}
        for n, p in params.items():
            q = p.clone()
            q[i] = rows[n]
            out[n] = q
        return out, True

    def _payload_fault_model(self, k: int, params, t_deliver: float,
                             reference):
        """Unstacked sibling of ``_corrupt_row`` for the async engine.
        Returns (params, was_bad)."""
        draw = self._payload_fault(k, t_deliver)
        if draw is None:
            return params, False
        mode, factor = draw[0], draw[1]
        if mode == "poison":
            return {n: _poisoned(p, reference[n], factor)
                    for n, p in params.items()}, True
        if mode == "sign_flip":
            return {n: -p for n, p in params.items()}, True
        if mode == "scale":
            return {n: p * factor for n, p in params.items()}, True
        noise = _seeded_noise(params, draw[2], factor)
        return {n: p + noise[n] for n, p in params.items()}, True

    def _apply_payload_faults(self, trained, sel, delivered, t_deliver):
        """Corrupt/poison the *delivered* rows of a trained cohort at their
        delivery times (sync engines); a lost update cannot also be
        corrupted. Returns (trained, n_corrupted)."""
        ref = self._tx_global()
        n_corr = 0
        for i, k in enumerate(sel):
            if delivered is not None and not delivered[i] > 0:
                continue
            trained, bad = self._corrupt_row(trained, i, int(k),
                                             float(t_deliver[i]), ref)
            n_corr += int(bad)
        return trained, n_corr

    # -- energy accounting ----------------------------------------------
    def _post_recovery_contact(self, k: int, t: float):
        """A drained satellite's earliest usable GS contact at or after
        battery recovery (idle + solar only), or None if the battery never
        clears the floor."""
        rt = self.energy.recover_time(k)
        return None if rt is None else \
            self._next_available_contact(k, max(rt, t))

    def _round_energy(self, proj, ks, trains, comms, t_round_end):
        """Advance the fleet's batteries to the round end and bill the
        participants' added FL energy. Returns (energy_wh,
        skipped_low_power), (0.0, 0) when energy modeling is off."""
        if self.energy is None:
            return 0.0, 0
        skipped = int(np.sum(proj["orbit_valid"] & ~proj["energy_ok"]))
        self.energy.advance_to(t_round_end)
        return self.energy.bill_activity(ks, trains, comms), skipped

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
        deterministic ``EventQueue`` fire ``run_round``; the world events
        between barriers (contact windows, eclipse transitions, outages,
        resets, storms) resolve in one batched
        ``WorldTimeline.advance_through`` pass per round, and battery-floor
        crossings are noted by diffing the gating mask at each barrier."""
        t_end = t_end if t_end is not None else self.plan.horizon_s
        max_rounds = max_rounds or self.cfg.max_rounds
        queue = EventQueue()
        queue.push(t0, ROUND_BARRIER)
        timeline = WorldTimeline.for_fl(self.plan, self.energy, self.faults)
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
            if self.energy is not None:
                timeline.note_eligibility(self.energy.eligible(), rec.t_end)
            queue.push(rec.t_end, ROUND_BARRIER)
            r += 1
        return self.records

    def run_round(self, r: int, t: float) -> Optional[RoundRecord]:
        raise NotImplementedError

    # -- the fault, deadline and energy tail of a synchronous round ------
    def _finish_sync_round(self, r, t, proj, sel, ks, trained, n_k, ends,
                           comms, recv_end, train_end, trains):
        """Resolve a trained synchronous cohort (FedAvg/FedProx): the
        faulted return legs and payload faults, the deadline/quorum close
        with its stragglers, the aggregation, the folding of carried
        stragglers and the energy bill. Returns ``(t_round_end, comms,
        counters)``, counters being the RoundRecord fault fields."""
        cfg = self.cfg
        n_flt, drops, rebill, n_corr, n_clip, n_rex = 0, 0, 0.0, 0, 0, 0
        delivered = np.ones(len(sel))
        if self.faults is not None:
            delivered, ends, comms, n_flt, drops, rebill, n_rex = \
                self._faulted_return_legs(ks, recv_end, train_end, ends,
                                          comms)
            n_k[:len(sel)] *= delivered    # lost/wiped updates: weight 0
            n_flt += self._selection_faulted(proj)
            if self.faults.cfg.has_payload_faults:
                # the bytes were billed above; only the weights went bad
                trained, n_corr = self._apply_payload_faults(
                    trained, sel, delivered, ends)
        # the server waits for deliveries, until the deadline/quorum close
        # cuts the slow tail
        t_round_end, on_time, expired = self._close_round(
            t, ends, delivered > 0)
        n_exp, n_strag = 0, 0
        if expired:
            n_exp = 1
            late = np.nonzero((delivered > 0) & ~on_time)[0]
            n_strag = len(late)
            if cfg.late_policy == "carry" and n_strag:
                base_ref = self._tx_global()   # the broadcast they trained on
                for i in late:
                    self._carry_straggler(trained, int(i), base_ref,
                                          float(ends[int(i)]), r,
                                          int(sel[int(i)]))
            n_k[:len(sel)] *= on_time.astype(np.float64)
        if float(n_k.sum()) > 0.0:         # always true when faults are off
            self.global_params, n_clip = self._aggregate(trained, n_k)
        if self._carried:
            self._fold_carried(t_round_end, r)
        wh, skipped = self._round_energy(proj, ks, trains, comms, t_round_end)
        return t_round_end, comms, dict(
            energy_wh=wh, skipped_low_power=skipped, skipped_faulted=n_flt,
            dropped_contacts=drops, retransmit_bytes=rebill,
            corrupted_updates=n_corr, clipped_updates=n_clip,
            deadline_expired=n_exp, stragglers_carried=n_strag,
            retries_exhausted=n_rex,
            storm_events=self._storms_in(t, t_round_end))


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
        t_round_end, comms, extra = self._finish_sync_round(
            r, t, proj, sel, ks, trained, n_k, ends, comms,
            proj["recv_end"][ks], proj["train_end"][ks], trains)
        acc = self._accuracy(r)
        return RoundRecord(r, t, t_round_end, t_round_end - t,
                           float(np.mean(idles)), float(np.mean(comms)),
                           float(np.mean(trains)), acc, sel,
                           epochs=cfg.epochs,
                           comm_s_by_sat=dict(zip(sel, comms.tolist())),
                           policy_deferred=sum(pol_skips.values()),
                           policy_skips=pol_skips, **extra)


class FedProxSat(SpaceifiedFL):
    """Algorithm 3: partial updates — each client trains until it reaches a
    ground station; a proximal term bounds local drift. V2 (min_epochs>0)
    enforces a minimum-epoch floor before returning (paper §5.1.1).

    Per-client epoch budgets come from ONE batched floor projection over
    the contact plan; a selected client whose floor-epoch return contact
    never materializes is dropped from the round (the round only fails if
    nobody can return). Under faults the budgets keep the fault-free
    projection (a client cannot foresee faults); only the return leg is
    re-resolved."""

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
        # contacts and energy/fault masks and re-runs only the return leg;
        # when the floor equals the selection epoch count the two coincide
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
        t_round_end, comms, extra = self._finish_sync_round(
            r, t, projf, sel, ks, trained, n_k, ends, comms, recv_end,
            train_end, trains)
        acc = self._accuracy(r)
        return RoundRecord(r, t, t_round_end, t_round_end - t,
                           float(np.mean(idles)), float(np.mean(comms)),
                           float(np.mean(trains)), acc, sel,
                           epochs=float(np.mean(ep)),
                           comm_s_by_sat=dict(zip(sel, comms.tolist())),
                           policy_deferred=sum(pol_skips.values()),
                           policy_skips=pol_skips, **extra)


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
    random source's ``event_key``, in pop order. With energy on, drained
    satellites stand down until their battery recovers (or, under the
    ``energy_aware`` policy, until sunrise); with faults on, pickups skip
    outages, the drop walk is resolved at scheduling time, a radiation
    reset since pickup loses the episode, and delivered payloads may be
    corrupted or poisoned. FedBuff is asynchronous and ignores the round
    deadline."""

    name = "fedbuff"

    def _flush_buffer(self, buf) -> int:
        """Fold a full buffer into the global model; returns the robust
        estimator's attenuated row count (0 on the plain flush)."""
        stacked_new = _stack([b[0] for b in buf])
        stacked_base = _stack([b[1] for b in buf])
        wgts = np.asarray([b[2] for b in buf], np.float32)
        if self.aggregator is not None:
            self.global_params, n_clip = robust_apply_buffered_deltas(
                self.global_params, stacked_new, stacked_base, wgts,
                self.aggregator)
            return n_clip
        self.global_params = apply_buffered_deltas(
            self.global_params, stacked_new, stacked_base, wgts)
        return 0

    def _seed_queries(self, t0: float):
        """(K,) first-pickup query times and the policy's eclipse
        deferrals at seeding: drained satellites query from their battery
        recovery (or, under an eclipse-deferring policy, from sunrise);
        one that never recovers gets an inf query."""
        K = self.plan.constellation.n_sats
        tq = np.full(K, t0)
        n_defer = 0
        if self.energy is None:
            return tq, n_defer
        self.energy.advance_to(t0)
        if self.policy.defers_in_eclipse:
            soc = self.energy.soc_frac()
            defer = ~self.energy.sunlit_at(t0) & (soc < self.policy.defer_soc)
            if defer.any():
                sr = self.energy.sunrise_after(t0)
                tq[defer] = np.where(np.isfinite(sr[defer]),
                                     np.maximum(sr[defer], t0), np.inf)
                n_defer = int(defer.sum())
        else:
            drained = np.nonzero(~self.energy.eligible())[0]
            if len(drained):
                rts = self.energy.recover_times(drained)
                tq[drained] = np.where(np.isfinite(rts),
                                       np.maximum(rts, t0), np.inf)
        return tq, n_defer

    def run(self, t0: float = 0.0, t_end: Optional[float] = None,
            max_rounds: Optional[int] = None):
        cfg, plan = self.cfg, self.plan
        t_end = t_end if t_end is not None else plan.horizon_s
        max_rounds = max_rounds or cfg.max_rounds
        K = plan.constellation.n_sats
        n = self.ds.n_per_client
        ep_s = self.fleet.epoch_time_s            # (K,) per-satellite
        queue = EventQueue()
        timeline = WorldTimeline.for_fl(plan, self.energy, self.faults)
        self.event_stats = st = timeline.stats
        # client states: params version picked up, pickup round, epochs,
        # idle gap between train end and the return window
        client_params: Dict[int, dict] = {}
        pickup_round: Dict[int, int] = {}
        epochs_of: Dict[int, int] = {}
        idle_of: Dict[int, float] = {}
        # uplink seconds of a pickup whose contact the clock has not passed
        # yet (seed pickups, pickups deferred past a stand-down), billed at
        # the client's next processed return
        deferred_up: Dict[int, float] = {}
        # fault bookkeeping: pickup contact time of each pending episode
        # and the drop walk resolved at scheduling time (drops, re-billed)
        pickup_t: Dict[int, float] = {}
        meta_of: Dict[int, tuple] = {}
        tq, def_seed = self._seed_queries(t0)
        rex_seed = 0        # retry-budget exhaustions during seeding
        if self.faults is None:
            # seed the fleet with one batched contact-plan pass
            avail, _, _, valid = plan.next_contacts(tq)
            recv_end_k = avail + self._t_up_k
            ret_avail, _, _, ret_valid = plan.next_contacts(
                np.where(valid, recv_end_k + ep_s, np.inf))
            for k in range(K):
                if not (valid[k] and ret_valid[k]):
                    continue
                recv_end, ret0 = float(recv_end_k[k]), float(ret_avail[k])
                ep = int(np.clip((ret0 - recv_end) // ep_s[k], 1,
                                 cfg.max_local_epochs))
                queue.push(ret0 + float(self._t_down_k[k]), CLIENT_RETURN,
                           key=k)
                client_params[k] = self._tx_global()
                pickup_round[k] = 0
                epochs_of[k] = ep
                idle_of[k] = max(ret0 - (recv_end + ep * float(ep_s[k])),
                                 0.0)
                if self.energy is not None:     # the seed pickup's uplink
                    deferred_up[k] = float(self._t_up_k[k])
        else:
            # fault-aware seed: outage-delayed pickups, outage-skipping
            # return windows, the drop walk resolved at scheduling time
            tq = self.faults.next_up(np.arange(K), tq)
            for k in range(K):
                w = self._next_available_contact(k, float(tq[k]))
                if w is None:
                    continue
                recv_end = float(w[0]) + float(self._t_up_k[k])
                nxt = self._next_available_contact(
                    k, recv_end + float(ep_s[k]))
                if nxt is None:
                    continue
                ep = int(np.clip((nxt[0] - recv_end) // ep_s[k], 1,
                                 cfg.max_local_epochs))
                t_done, d, rb, lost = self._walk_drops(k, nxt)
                if lost:            # every return window drops: sits out
                    rex_seed += int(lost == _LOST_RETRIES)
                    continue
                queue.push(t_done, CLIENT_RETURN, key=k)
                client_params[k] = self._tx_global()
                pickup_round[k] = 0
                epochs_of[k] = ep
                idle_of[k] = max(nxt[0] - (recv_end + ep * float(ep_s[k])),
                                 0.0)
                pickup_t[k] = float(w[0])
                meta_of[k] = (d, rb)
                if self.energy is not None:
                    deferred_up[k] = float(self._t_up_k[k])

        buf, r = [], 0
        t_round_start = t0
        idle_acc, comm_acc, train_acc, n_ev = 0.0, 0.0, 0.0, 0
        energy_acc, skip_acc = 0.0, 0
        fault_acc, drop_acc, rebill_acc = 0, 0, 0.0
        corr_acc, rex_acc, def_acc = 0, rex_seed, def_seed
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
            # a radiation reset since pickup wiped the client's local
            # state: the episode's update is lost, nothing is billed, and
            # the client re-syncs at this same contact
            wiped = (self.faults is not None and self.faults.cfg.has_resets
                     and self.faults.reset_in(k, pickup_t.get(k, t0), t_ret))
            n_drops = 0
            if not wiped:
                perms = self.rng.permutations(self.rng.event_key(), n,
                                              epochs_of[k])
                trained = local_sgd(cfg.model, client_params[k],
                                    self.ds.x[k], self.ds.y[k], perms,
                                    epochs_of[k], cfg.batch_size, cfg.lr,
                                    mu=cfg.prox_mu,
                                    global_params=client_params[k])
                if cfg.quant_bits:  # the returned model crosses the radio
                    trained = quantize_roundtrip(trained, cfg.quant_bits)
                if self.faults is not None \
                        and self.faults.cfg.has_payload_faults:
                    # corrupted/poisoned in flight; the reference is the
                    # pickup version the client trained from
                    trained, bad = self._payload_fault_model(
                        k, trained, t_ret, client_params[k])
                    corr_acc += int(bad)
                stale = r - pickup_round[k]
                wgt = (1.0 + stale) ** (-cfg.staleness_exponent)
                buf.append((trained, client_params[k], wgt))
                comm_acc += t_up + t_down
                comm_by[k] = comm_by.get(k, 0.0) + t_up + t_down
                train_acc += train_s
                idle_acc += idle_of.get(k, 0.0)
                n_ev += 1
                st.add(TRAIN_DONE)
                if self.faults is not None:
                    # retry airtime of the walk resolved at scheduling
                    n_drops, rb = meta_of.get(k, (0, 0.0))
                    drop_acc += n_drops
                    rebill_acc += rb
                    comm_acc += n_drops * t_down
                    comm_by[k] = comm_by.get(k, 0.0) + n_drops * t_down
            else:
                fault_acc += 1
                deferred_up.pop(k, None)
            # the client picks up the current global at this contact and
            # trains on until its next return window
            recv_end = t_ret + t_up
            requeue, stood_down = True, False
            if self.energy is not None:
                self.energy.advance_to(t_ret)
                # the completed episode is billed at its return contact:
                # training, the downlink(s), and any deferred pickup uplink
                if not wiped:
                    energy_acc += self.energy.bill_activity(
                        np.array([k]), np.array([train_s]),
                        np.array([t_down * (1 + n_drops)
                                  + deferred_up.pop(k, 0.0)]))
                elig = self.energy.eligible()
                timeline.note_eligibility(elig, t_ret)
                if self.policy.defers_in_eclipse:
                    # in eclipse below the defer threshold the next pickup
                    # waits for this satellite's sunrise
                    if float(self.energy.soc_frac()[k]) \
                            < self.policy.defer_soc \
                            and not bool(self.energy.sunlit_at(t_ret)[k]):
                        def_acc += 1
                        stood_down = True
                        sr = float(self.energy.sunrise_after(t_ret)[k])
                        w2 = self._next_available_contact(
                            k, max(sr, recv_end)) if np.isfinite(sr) \
                            else None
                        if w2 is None:
                            requeue = False  # dark forever: drops out
                        else:
                            recv_end = w2[0] + t_up
                elif not elig[k]:
                    # drained below the floor: stand down until idle+solar
                    # recovers, then rejoin at the next contact after that
                    skip_acc += 1
                    stood_down = True
                    w2 = self._post_recovery_contact(k, recv_end)
                    if w2 is None:
                        requeue = False     # never recovers: drops out
                    else:
                        recv_end = w2[0] + t_up
            nxt = self._next_available_contact(k, recv_end + float(ep_s[k])) \
                if requeue else None
            ev_t, d2, rb2 = None, 0, 0.0
            if nxt is not None:
                ev_t = float(nxt[0]) + t_down
                if self.faults is not None:
                    t_done2, d2, rb2, lost = self._walk_drops(k, nxt)
                    if lost:        # every remaining return window drops
                        rex_acc += int(lost == _LOST_RETRIES)
                        nxt = None
                    else:
                        ev_t = t_done2
            if nxt is not None:
                # the next pickup starts an episode: bill its uplink now,
                # or at the post-recovery contact after a stand-down
                if self.energy is not None:
                    if stood_down:
                        deferred_up[k] = t_up
                    else:
                        energy_acc += self.energy.bill_activity(
                            np.array([k]), np.array([0.0]),
                            np.array([t_up]))
                ep = int(np.clip((nxt[0] - recv_end) // ep_s[k], 1,
                                 cfg.max_local_epochs))
                queue.push(ev_t, CLIENT_RETURN, key=k)
                client_params[k] = self._tx_global()
                pickup_round[k] = r
                epochs_of[k] = ep
                idle_of[k] = max(nxt[0] - (recv_end + ep * float(ep_s[k])),
                                 0.0)
                if self.faults is not None:
                    pickup_t[k] = recv_end - t_up
                    meta_of[k] = (d2, rb2)
            elif self.energy is not None or self.faults is not None:
                # the client drops out for good: purge its state, so no
                # stale epochs_of entry skews later rounds' epoch average
                for dct in (client_params, pickup_round, epochs_of,
                            idle_of, deferred_up, pickup_t, meta_of):
                    dct.pop(k, None)

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
                    energy_wh=energy_acc, skipped_low_power=skip_acc,
                    comm_s_by_sat=comm_by, skipped_faulted=fault_acc,
                    dropped_contacts=drop_acc, retransmit_bytes=rebill_acc,
                    corrupted_updates=corr_acc, clipped_updates=n_clip,
                    retries_exhausted=rex_acc,
                    storm_events=self._storms_in(t_round_start, t_ret),
                    policy_deferred=def_acc,
                    policy_skips={"eclipse_deferred": def_acc}
                    if def_acc else {}))
                t_round_start = t_ret
                idle_acc = comm_acc = train_acc = 0.0
                energy_acc, skip_acc = 0.0, 0
                fault_acc, drop_acc, rebill_acc = 0, 0, 0.0
                corr_acc, rex_acc, def_acc = 0, 0, 0
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
