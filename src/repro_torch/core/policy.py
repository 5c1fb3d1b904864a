"""Client-selection policies: the built-in half of the JAX package's
``core/policy.py`` (pure numpy, copied).

A :class:`SelectionPolicy` maps the batched projection dict produced by
``SpaceifiedFL._projected_returns`` to a ``(K,)`` score vector plus an
eligibility mask (:class:`PolicyDecision`); the engine then picks the
``clients_per_round`` lowest-scoring eligible satellites with the
deterministic ``(score, sat-index)`` tie-break of :func:`select_top`.

``first_contact`` / ``scheduled`` / ``intra_sl`` are ported here and
answer bitwise as the reference does. The reference's ``deadline_aware``,
``energy_aware`` and ``oracle`` policies need the energy and fault layers,
which are not ported yet: naming them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class PolicyInputs:
    """Everything a policy may score with, bundled by the engine.
    ``proj`` is the batched ``_projected_returns`` dict."""
    t: float
    epochs: float
    proj: Optional[dict]
    fleet: object                     # repro_torch.sim.hardware.FleetProfile
    t_up_k: np.ndarray                # (K,) uplink seconds at the wire size
    t_down_k: np.ndarray              # (K,) downlink seconds
    clients_per_round: int
    round_deadline_s: float

    @property
    def n_sats(self) -> int:
        return len(self.t_down_k)


@dataclasses.dataclass
class PolicyDecision:
    """A policy's verdict over the fleet: lower score = picked earlier;
    ineligible satellites are never picked. ``skips`` maps a reason to
    how many otherwise-eligible candidates were deferred ({} for the
    built-ins)."""
    score: np.ndarray                 # (K,) float
    eligible: np.ndarray              # (K,) bool
    skips: Dict[str, int] = dataclasses.field(default_factory=dict)


def select_top(score, eligible, width: int) -> List[int]:
    """The engine's one selection rule: the ``width`` lowest-scoring
    eligible satellites, ties broken by satellite index
    (``np.lexsort((ks, score[ks]))`` sorts by (score, sat-index))."""
    ks = np.nonzero(np.asarray(eligible, bool))[0]
    score = np.asarray(score)
    order = np.lexsort((ks, score[ks]))        # score, then sat index
    m = min(width, len(ks))
    return [int(k) for k in ks[order][:m]]


class SelectionPolicy:
    """Base class of selection policies: subclasses implement
    :meth:`decide`."""

    name = "base"

    def decide(self, inp: PolicyInputs) -> PolicyDecision:
        raise NotImplementedError


class FirstContactPolicy(SelectionPolicy):
    """The paper's base rule: first C idle clients to reach a ground
    station."""

    name = "first_contact"

    def decide(self, inp):
        proj = inp.proj
        return PolicyDecision(score=proj["contact_avail"],
                              eligible=proj["valid"])


class ScheduledPolicy(SelectionPolicy):
    """FLSchedule (Alg. 5): smallest contact + projected-return total.
    Also serves ``intra_sl`` (the relay difference lives in the
    projection, not the score)."""

    name = "scheduled"

    def decide(self, inp):
        proj = inp.proj
        return PolicyDecision(score=proj["ret_avail"] + inp.t_down_k,
                              eligible=proj["valid"])


#: Registry of constructible policies (``FLConfig.policy`` by name).
POLICIES = {
    "first_contact": FirstContactPolicy,
    "scheduled": ScheduledPolicy,
    "intra_sl": ScheduledPolicy,
}

#: Policies of the reference that need layers this port has not reached.
NOT_PORTED = ("deadline_aware", "energy_aware", "oracle")

_BUILTIN_FOR_SELECTION = {
    "first_contact": FirstContactPolicy,
    "scheduled": ScheduledPolicy,
    "intra_sl": ScheduledPolicy,
}


def resolve_policy(policy, selection: str) -> SelectionPolicy:
    """Resolve ``FLConfig.policy`` (None | name | instance) against the
    ``selection`` mode. None keeps the built-in matching the selection."""
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
        if policy in NOT_PORTED:
            raise NotImplementedError(
                f"selection policy {policy!r} needs the energy/fault layers, "
                "which come with the engine's optional-layer slice of the "
                "port (Slice B)")
        try:
            return POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown selection policy {policy!r} "
                f"(registered: {sorted(POLICIES)})")
    raise TypeError("FLConfig.policy must be None, a registered policy "
                    f"name, or a SelectionPolicy instance, got {policy!r}")
