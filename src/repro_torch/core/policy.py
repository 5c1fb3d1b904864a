"""Client-selection policies (the selection-policy layer).

Port of the JAX package's ``core/policy.py`` (pure numpy, copied).

A :class:`SelectionPolicy` maps the batched projection dict produced by
``SpaceifiedFL._projected_returns`` — contact/return times, per-satellite
epoch times and link rates (``FleetProfile``), SoC and sunlit state
(``EnergySim``), outage/storm state (``FaultSim``) — to a ``(K,)`` score
vector plus an eligibility mask (:class:`PolicyDecision`). The engine then
picks the ``clients_per_round`` lowest-scoring eligible satellites with the
deterministic ``(score, sat-index)`` tie-break of :func:`select_top`.

Built-in policies: ``first_contact`` / ``scheduled`` / ``intra_sl`` score
the projection as it is and gate on its ``valid`` mask (orbit AND battery
floor AND outage). ``FLConfig.policy=None`` resolves to the built-in
matching ``cfg.selection``; ``cfg.selection`` keeps controlling the
projection (e.g. intra-SL relay return legs), the policy only scores and
gates.

The other policies:

``deadline_aware``
    Scores by projected delivery time, demotes satellites whose
    contact→delivery interval meets a storm over their plane
    (``FaultSim.storm_exposure``) and, under a finite ``round_deadline_s``,
    projected deadline misses, and adds each satellite's radio time so
    fast links win ties. Demotions are soft (large finite penalties). Also
    drives per-member AutoFLSat tier-1 epoch budgets.
``energy_aware``
    Drops the binary SoC floor for (a) deferral of satellites in eclipse
    below ``defer_soc`` until their sunlit arc, (b) a small
    ``critical_soc`` emergency floor and (c) a score weighted by
    ``(1 - SoC) * soc_weight_s``. FedBuff pickups follow the same rule
    (``defers_in_eclipse``); AutoFLSat budgets scale with SoC.
``oracle``
    Clairvoyant baseline: scores each candidate by its true fault-resolved
    delivery time (outage-skipping windows, the seeded drop-retry walk,
    radiation fate) and refuses candidates whose update never arrives.
    Fault draws are counter-based, so peeking never perturbs them.

For a fixed projection dict every decision is a pure function of its
inputs, and :func:`select_top` breaks score ties by satellite index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class PolicyInputs:
    """Everything a policy may score with, bundled by the engine.

    ``proj`` is the batched ``_projected_returns`` dict (``None`` for
    AutoFLSat budget queries, which have no per-satellite GS projection
    — all members always participate in tier 1). ``energy`` /
    ``faults`` are the live ``EnergySim`` / ``FaultSim`` (or None);
    ``engine`` is the calling ``SpaceifiedFL`` for clairvoyant policies
    that need fault resolution helpers."""
    t: float
    epochs: float
    proj: Optional[dict]
    fleet: object                     # repro_torch.sim.hardware.FleetProfile
    t_up_k: np.ndarray                # (K,) uplink seconds at the wire size
    t_down_k: np.ndarray              # (K,) downlink seconds
    clients_per_round: int
    round_deadline_s: float
    energy: Optional[object] = None   # repro_torch.sim.energy.EnergySim
    faults: Optional[object] = None   # repro_torch.sim.faults.FaultSim
    engine: Optional[object] = None   # repro_torch.core.spaceify.SpaceifiedFL

    @property
    def n_sats(self) -> int:
        return len(self.t_down_k)


@dataclasses.dataclass
class PolicyDecision:
    """A policy's verdict over the fleet: lower score = picked earlier;
    ineligible satellites are never picked. ``skips`` maps a per-policy
    reason to how many *otherwise-eligible* candidates it deferred
    (hard exclusions) or demoted (soft score penalties) this decision —
    the ``RoundRecord.policy_skips`` source. Built-ins report ``{}``."""
    score: np.ndarray                 # (K,) float
    eligible: np.ndarray              # (K,) bool
    skips: Dict[str, int] = dataclasses.field(default_factory=dict)


def select_top(score, eligible, width: int) -> List[int]:
    """The engine's one selection rule: the ``width`` lowest-scoring
    eligible satellites, ties broken by satellite index.

    ``np.lexsort((ks, score[ks]))`` sorts by (score, sat-index), so the
    result is deterministic for any score vector and independent of how
    the eligibility mask was composed."""
    ks = np.nonzero(np.asarray(eligible, bool))[0]
    score = np.asarray(score)
    order = np.lexsort((ks, score[ks]))        # score, then sat index
    m = min(width, len(ks))
    return [int(k) for k in ks[order][:m]]


class SelectionPolicy:
    """Base class / protocol for selection policies.

    Subclasses implement :meth:`decide`; the class attributes tell the
    engines which extra hooks the policy drives:

    * ``member_budgets`` — AutoFLSat tier 1 asks :meth:`epoch_budgets`
      for a per-member ``(K,)`` epoch vector (None keeps the scalar
      schedule budget);
    * ``defers_in_eclipse`` — FedBuff pickups replace the binary
      SoC-floor stand-down with the policy's eclipse-deferral rule
      (defer to the sunlit arc when below ``defer_soc``).
    """

    name = "base"
    member_budgets = False
    defers_in_eclipse = False

    def decide(self, inp: PolicyInputs) -> PolicyDecision:
        raise NotImplementedError

    def epoch_budgets(self, inp: PolicyInputs, epochs: int):
        """Per-member tier-1 epoch budgets (K,) int32, or None for the
        scalar default. Only consulted when ``member_budgets``."""
        return None


class FirstContactPolicy(SelectionPolicy):
    """The paper's base rule: first C idle clients to reach a ground
    station. Bitwise-identical to ``selection='first_contact'``."""

    name = "first_contact"

    def decide(self, inp):
        proj = inp.proj
        return PolicyDecision(score=proj["contact_avail"],
                              eligible=proj["valid"])


class ScheduledPolicy(SelectionPolicy):
    """FLSchedule (Alg. 5): smallest contact + projected-return total.
    Bitwise-identical to ``selection='scheduled'`` / ``'intra_sl'``
    (the intra-SL relay difference lives in the projection, not the
    score)."""

    name = "scheduled"

    def decide(self, inp):
        proj = inp.proj
        return PolicyDecision(score=proj["ret_avail"] + inp.t_down_k,
                              eligible=proj["valid"])


class DeadlineAwarePolicy(SelectionPolicy):
    """Deadline/storm-aware selection: a selector that routes around
    storm-struck planes.

    Score = projected delivery time, plus soft demotions:

    * a candidate whose contact→projected-delivery interval overlaps a
      storm over its plane is demoted by ``storm_penalty_s * (1 + max
      overlapping severity)`` — it delivers into boosted drop/outage
      rates, so prefer clear-sky planes while they exist;
    * with a finite ``round_deadline_s``, a candidate whose projected
      delivery misses the close is demoted by ``miss_penalty_s`` (it
      would only straggle), and every candidate's radio time is added
      with weight ``comm_weight`` so fast links break ties when the
      clock is tight.

    Demotions are finite, so a storm covering the whole fleet degrades
    to ordinary scheduled selection instead of starving the round."""

    name = "deadline_aware"
    member_budgets = True

    def __init__(self, storm_penalty_s: float = 1e7,
                 miss_penalty_s: float = 1e7, comm_weight: float = 1.0):
        self.storm_penalty_s = float(storm_penalty_s)
        self.miss_penalty_s = float(miss_penalty_s)
        self.comm_weight = float(comm_weight)

    def decide(self, inp):
        proj = inp.proj
        base = np.asarray(proj["ret_avail"] + inp.t_down_k, np.float64)
        elig = proj["valid"]
        score = base.copy()
        skips: Dict[str, int] = {}
        exposed = np.zeros(len(base), bool)
        if inp.faults is not None and inp.faults.has_storms:
            sev = inp.faults.storm_exposure(
                np.arange(len(base)), proj["contact_avail"], base)
            exposed = sev > 0.0
            score += np.where(exposed,
                              self.storm_penalty_s * (1.0 + sev), 0.0)
            n = int(np.sum(elig & exposed))
            if n:
                skips["storm_exposed"] = n
        if np.isfinite(inp.round_deadline_s):
            miss = base > inp.t + inp.round_deadline_s
            score += np.where(miss, self.miss_penalty_s, 0.0)
            score += self.comm_weight * (inp.t_up_k + inp.t_down_k)
            n = int(np.sum(elig & miss & ~exposed))
            if n:
                skips["deadline_miss"] = n
        return PolicyDecision(score=score, eligible=elig, skips=skips)

    def epoch_budgets(self, inp, epochs):
        """Fit each member's training into one wall-time budget: the
        round deadline when finite, else the fleet-median member's
        ``epochs``-epoch wall time — so a uniform fleet keeps exactly
        ``epochs`` everywhere and slow ML units on a mixed fleet train
        fewer epochs instead of stretching the tier-1 barrier."""
        ep_time = np.asarray(inp.fleet.epoch_time_s, np.float64)
        if np.isfinite(inp.round_deadline_s):
            budget_s = float(inp.round_deadline_s)
        else:
            budget_s = float(epochs) * float(np.median(ep_time))
        return np.clip(budget_s // ep_time, 1, epochs).astype(np.int32)


class EnergyAwarePolicy(SelectionPolicy):
    """Soft SoC-weighted selection with sunlit-arc deferral — the
    binary battery floor re-expressed as a *policy choice*.

    Eligibility: orbit AND outage masks as usual, but the binary
    ``energy_ok`` floor is dropped. Instead a satellite in eclipse
    below ``defer_soc`` is deferred to its sunlit arc (it would train
    on discharge with no solar input — counted ``eclipse_deferred``),
    and only a small ``critical_soc`` emergency floor hard-excludes
    (counted ``critical_soc``). Score adds ``(1 - SoC) *
    soc_weight_s`` seconds, so charge differences rotate selection long
    before any floor binds. Without an ``EnergySim`` this degrades to
    exactly the scheduled decision."""

    name = "energy_aware"
    member_budgets = True
    defers_in_eclipse = True

    def __init__(self, defer_soc: float = 0.5, critical_soc: float = 0.05,
                 soc_weight_s: float = 3600.0):
        self.defer_soc = float(defer_soc)
        self.critical_soc = float(critical_soc)
        self.soc_weight_s = float(soc_weight_s)

    def decide(self, inp):
        proj = inp.proj
        score = np.asarray(proj["ret_avail"] + inp.t_down_k, np.float64)
        elig = proj["orbit_valid"] & proj["fault_ok"]
        skips: Dict[str, int] = {}
        if inp.energy is not None:
            inp.energy.advance_to(float(inp.t))   # idempotent at equal t
            soc = inp.energy.soc_frac()
            sunlit = inp.energy.sunlit_at(float(inp.t))
            critical = soc < self.critical_soc
            deferred = ~sunlit & (soc < self.defer_soc) & ~critical
            n = int(np.sum(elig & critical))
            if n:
                skips["critical_soc"] = n
            n = int(np.sum(elig & deferred))
            if n:
                skips["eclipse_deferred"] = n
            elig = elig & ~critical & ~deferred
            score = score + (1.0 - soc) * self.soc_weight_s
        return PolicyDecision(score=score, eligible=elig, skips=skips)

    def epoch_budgets(self, inp, epochs):
        """Scale each member's tier-1 budget with its state of charge:
        full batteries train the whole ``epochs``, drained ones at
        least 1 (they stay in sync but spend less)."""
        if inp.energy is None:
            return None
        inp.energy.advance_to(float(inp.t))
        soc = inp.energy.soc_frac()
        return np.clip(np.ceil(epochs * soc), 1, epochs).astype(np.int32)


class OraclePolicy(SelectionPolicy):
    """Clairvoyant upper baseline: score by the TRUE delivery time under
    the seeded fault timeline (outage-skipping return windows, the
    drop-retry walk, radiation fate) and refuse candidates whose update
    never arrives (``doomed_update``). Safe to peek: every fault draw
    is counter-based, so resolving a walk at selection time reads the
    same fates the round will. Equals ``scheduled`` with faults off."""

    name = "oracle"

    def decide(self, inp):
        proj = inp.proj
        base = np.asarray(proj["ret_avail"] + inp.t_down_k, np.float64)
        elig = np.asarray(proj["valid"], bool).copy()
        score = base.copy()
        skips: Dict[str, int] = {}
        eng = inp.engine
        if inp.faults is not None and eng is not None:
            check_resets = inp.faults.cfg.has_resets
            doomed = 0
            for k in np.nonzero(elig)[0]:
                k = int(k)
                w0 = eng._next_available_contact(
                    k, float(proj["train_end"][k]))
                if w0 is None:
                    elig[k], doomed = False, doomed + 1
                    continue
                t_done, _, _, lost = eng._walk_drops(k, w0)
                if lost or (check_resets and inp.faults.reset_in(
                        k, float(proj["recv_end"][k]), t_done)):
                    elig[k], doomed = False, doomed + 1
                    continue
                score[k] = t_done
            if doomed:
                skips["doomed_update"] = doomed
        return PolicyDecision(score=score, eligible=elig, skips=skips)


#: Registry of constructible policies (``FLConfig.policy`` by name).
#: ``intra_sl`` aliases the scheduled scoring — the relay semantics
#: live in ``cfg.selection``'s projection, not in the policy.
POLICIES = {
    "first_contact": FirstContactPolicy,
    "scheduled": ScheduledPolicy,
    "intra_sl": ScheduledPolicy,
    "deadline_aware": DeadlineAwarePolicy,
    "energy_aware": EnergyAwarePolicy,
    "oracle": OraclePolicy,
}

#: The built-in policy each legacy ``cfg.selection`` value maps to when
#: ``FLConfig.policy`` is None.
_BUILTIN_FOR_SELECTION = {
    "first_contact": FirstContactPolicy,
    "scheduled": ScheduledPolicy,
    "intra_sl": ScheduledPolicy,
}


def resolve_policy(policy, selection: str) -> SelectionPolicy:
    """Resolve ``FLConfig.policy`` (None | name | instance) against the
    ``selection`` mode. None keeps the built-in matching the selection
    string."""
    if policy is None:
        try:
            return _BUILTIN_FOR_SELECTION[selection]()
        except KeyError:
            raise ValueError(
                f"unknown FLConfig.selection {selection!r} "
                f"(expected one of {sorted(_BUILTIN_FOR_SELECTION)})")
    if isinstance(policy, SelectionPolicy):
        return policy
    if isinstance(policy, str):
        try:
            return POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown selection policy {policy!r} "
                f"(registered: {sorted(POLICIES)})")
    raise TypeError("FLConfig.policy must be None, a registered policy "
                    f"name, or a SelectionPolicy instance, got {policy!r}")
