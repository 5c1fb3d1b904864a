"""Battery state-of-charge (SoC) simulation for the constellation.

The paper's hardware-aware claim (§4.1.2, Table 2) is a *power* claim:
FLyCube-class satellites generate ~4 W orbital-average from body-mounted
panels, and the FL duty cycle adds up to ~2.4 W of load — so whether a
satellite can take part in a round is decided by its battery, not just its
orbit. This module turns the static Table 2 arithmetic
(``repro_torch.sim.hardware.oap_added_mw`` / ``power_feasible``) into a
dynamic per-satellite battery model:

  * solar input  = ``power_generation_mw`` while the satellite is sunlit
    (eclipse geometry from ``repro_torch.orbit.eclipse``, cylindrical
    umbra);
  * idle draw    = ``PowerModes.idle`` continuously;
  * FL activity  = billed as *added* draw above idle when a satellite
    trains (``PowerModes.training - idle``) or keys its radio
    (``PowerModes.radio_tx - idle``), for the exact durations the round
    engine computed from the contact plan;
  * SoC is clamped to [0, capacity].

Port of the JAX package's ``sim/energy.py``. ``EnergySim`` is numpy over
the packed eclipse series and is copied as it is, so every SoC comes out
bitwise as there; only the eclipse series runs in torch, on the device
``for_constellation`` / ``for_plan`` are given.

``EnergySim`` is an event-driven interval engine: it stores only the
per-satellite sunlit/eclipse *transition times* as CSR-offset flat arrays
with cumulative sunlit-seconds prefix sums (the ``contact_plan.py``
layout, O(K*W) memory with W ~ 2 transitions per orbit). Between
transitions the net power rate is constant, so SoC is piecewise linear in
time: ``advance_to`` answers clamp-free advancement for the whole fleet
with one bisection plus a prefix-sum lookup, and resolves clamp crossings
analytically per constant-rate segment. ``recover_times`` batches
floor-recovery queries the same way.

``EnergySim`` is the backing store for the round engines' energy gating
(``FLConfig.energy``): a satellite whose SoC is below
``min_soc * capacity`` at selection time is masked out of the round.

Heterogeneous fleets: the round engine passes its timing fleet
(``repro_torch.sim.hardware.FleetProfile``) into
:meth:`EnergySim.for_plan`, so by default power and link/compute timing
bill the *same* per-satellite hardware — the shared-fleet invariant.
``EnergyConfig.fleet`` overrides the power-side profiles only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.orbit.constellation import WalkerStar, satellite_elements
from repro_torch.orbit.eclipse import PackedEclipse, eclipse_series
from repro_torch.orbit.visibility import transitions_from_bool_matrix
from repro_torch.sim.hardware import HardwareProfile

_MWS_PER_WH = 3.6e6      # mW * s  per  Wh


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    """Battery + participation-gating knobs (``FLConfig.energy``).

    battery_capacity_wh
        Usable battery capacity in watt-hours; a scalar applies to every
        satellite, a length-K sequence sets per-satellite capacities.
        Default 15 Wh is an 18650-pair CubeSat pack.
    initial_soc
        Starting state of charge as a fraction of capacity (scalar or
        per-satellite sequence).
    min_soc
        Participation floor: a satellite whose SoC fraction is below this
        at selection time is ineligible for the round (masked out of the
        contact-plan projection with a zero-weight slot — the padded
        training dispatch never changes shape).
    eclipse_dt_s
        Resolution of the eclipse terminator-crossing times (the interval
        engine's only use of the grid). Independent of the contact plan's
        ``dt_s``.
    fleet
        Optional per-satellite ``HardwareProfile`` tuple (length K)
        overriding the *power-side* hardware only. ``None`` (default)
        bills the same fleet the round engine times with (the timing
        fleet passed to ``EnergySim.for_plan``, itself defaulting to the
        primary profile) — the timing/energy shared-fleet invariant.
    """
    battery_capacity_wh: Union[float, Sequence[float]] = 15.0
    initial_soc: Union[float, Sequence[float]] = 1.0
    min_soc: float = 0.3
    eclipse_dt_s: float = 60.0
    fleet: Optional[Tuple[HardwareProfile, ...]] = None


def mixed_fleet(profiles: Sequence[HardwareProfile], n_sats: int
                ) -> Tuple[HardwareProfile, ...]:
    """Cycle ``profiles`` across ``n_sats`` satellites (round-robin)."""
    return tuple(profiles[i % len(profiles)] for i in range(n_sats))


def _per_sat(value, n: int) -> np.ndarray:
    arr = np.asarray(value, np.float64)
    if arr.ndim == 0:
        return np.full(n, float(arr))
    if arr.shape != (n,):
        raise ValueError(f"expected scalar or ({n},) array, got {arr.shape}")
    return arr.copy()


class EnergySim:
    """Event-driven battery engine over the whole constellation.

    State: ``soc_wh`` (K,) watt-hours and the wall-clock ``t`` it is valid
    at. ``advance_to(t)`` integrates solar generation minus the continuous
    idle draw in closed form over the sunlit/eclipse intervals, clamping
    to [0, capacity] per constant-rate segment (exactly equivalent to the
    reference per-cell integration: within a segment the SoC moves
    monotonically, so the per-cell clamp and the segment-end clamp agree);
    ``bill_activity`` subtracts the *added* energy of FL work the round
    engine scheduled. Past the last transition the final eclipse state is
    held — ``advance_to`` and ``recover_times`` share that convention.

    ``eclipse`` may be the dense (T, K) boolean series or a
    ``repro_torch.orbit.eclipse.PackedEclipse`` (from
    ``eclipse_series(..., packed=True)``), which never materializes the
    dense tensor — the mega-constellation path.
    """

    def __init__(self, times: Optional[np.ndarray], eclipse,
                 profiles: Sequence[HardwareProfile], cfg: EnergyConfig,
                 extra_load_mw=0.0, attack=None):
        if isinstance(eclipse, PackedEclipse):
            K = eclipse.n_sats
            t0 = float(eclipse.t0)
            init_sun = ~np.asarray(eclipse.init_eclipsed, bool)
            trans = np.asarray(eclipse.trans_t, np.float64)
            offsets = np.asarray(eclipse.offsets, np.int64)
            self.times = None if times is None \
                else np.asarray(times, np.float64)
        else:
            eclipse = np.asarray(eclipse, bool)
            times = np.asarray(times, np.float64)
            K = eclipse.shape[1]
            if len(times) != eclipse.shape[0]:
                raise ValueError("times and eclipse series disagree on T")
            t0 = float(times[0])
            init_sun = ~eclipse[0]
            sat, trans = transitions_from_bool_matrix(eclipse, times)
            offsets = np.zeros(K + 1, np.int64)
            np.cumsum(np.bincount(sat, minlength=K), out=offsets[1:])
            self.times = times
        if len(profiles) != K:
            raise ValueError(f"{len(profiles)} profiles for {K} satellites")
        self.gen_mw = np.array([p.power_generation_mw for p in profiles])
        self.idle_mw = np.array([p.power.idle for p in profiles])
        self.train_mw = np.array([p.power.training for p in profiles])
        self.tx_mw = np.array([p.power.radio_tx for p in profiles])
        self.train_tx_mw = np.array([p.power.training_tx for p in profiles])
        # extra_load_mw: scalar or (K,) continuous draw above idle
        self.load_mw = self.idle_mw + _per_sat(extra_load_mw, K)
        if attack is not None:
            # IWQoS'23 energy-drain attack (repro_torch.sim.faults.
            # EnergyDrainAttack): the forced duty cycle is a continuous
            # added draw. eclipse_only (the attacker-optimal schedule)
            # is expressible inside the closed-form engine exactly:
            # adding `atk` to BOTH load and generation leaves the sunlit
            # net rate (gen - load) unchanged while the eclipse rate
            # (-load) gains the full drain — no sunlit attack energy,
            # full eclipse attack energy, no new interval machinery.
            atk = attack.added_load_mw(self.idle_mw, self.tx_mw,
                                       self.train_tx_mw)
            self.load_mw = self.load_mw + atk
            if attack.eclipse_only:
                self.gen_mw = self.gen_mw + atk
        self.cap_wh = _per_sat(cfg.battery_capacity_wh, K)
        self.min_soc = float(cfg.min_soc)
        self.soc_wh = _per_sat(cfg.initial_soc, K) * self.cap_wh
        self._build_interval_arrays(K, t0, init_sun, trans, offsets)
        self.t = t0
        # cursor caches, valid at self.t: per-satellite transition count
        # and cumulative sunlit seconds (transitions are strictly after
        # t0, so both start at zero).
        self._p_at_t = np.zeros(K, np.int64)
        self._sun_at_t = np.zeros(K, np.float64)
        self._E_at_t = np.zeros(K, np.float64)
        self._state_at_t = self._init_sun.copy()

    # -- construction ----------------------------------------------------
    @classmethod
    def for_constellation(cls, c: WalkerStar, horizon_s: float,
                          hw: HardwareProfile, cfg: EnergyConfig,
                          extra_load_mw=0.0,
                          fleet: Optional[Sequence[HardwareProfile]] = None,
                          attack=None, device="cuda") -> "EnergySim":
        """``fleet`` is the round engine's per-satellite timing fleet;
        profile precedence is ``cfg.fleet`` (power-side override) >
        ``fleet`` (shared with timing) > ``hw`` replicated. The eclipse
        series runs on ``device`` (default the card)."""
        raan, phase, _ = satellite_elements(c)
        times = np.arange(0.0, horizon_s, cfg.eclipse_dt_s)
        ecl = eclipse_series(c, raan, phase, np.radians(c.inclination_deg),
                             times, packed=True, device=device)
        profiles = cfg.fleet if cfg.fleet is not None else \
            (tuple(fleet) if fleet is not None else (hw,) * c.n_sats)
        return cls(times, ecl, profiles, cfg, extra_load_mw=extra_load_mw,
                   attack=attack)

    @classmethod
    def for_plan(cls, plan, hw: HardwareProfile, cfg: EnergyConfig,
                 fleet: Optional[Sequence[HardwareProfile]] = None,
                 attack=None, device="cuda") -> "EnergySim":
        return cls.for_constellation(plan.constellation, plan.horizon_s,
                                     hw, cfg, fleet=fleet, attack=attack,
                                     device=device)

    # -- interval layout -------------------------------------------------
    def _build_interval_arrays(self, K, t0, init_sun, trans, offsets):
        """CSR transition times + cumulative sunlit-seconds prefix sums.

        ``_cum[i]`` is the sunlit seconds its satellite accumulated over
        [t0, _trans[i]]; the state between a satellite's transitions j-1
        and j is ``init_sun XOR (j is odd)``. A second, globally
        time-sorted view (``_g_t`` / ``_g_sat``) lets ``advance_to`` find
        every terminator crossing in a query window with a single
        bisection and advance the per-satellite transition cursors with
        one bincount over just those events.
        """
        self._K = int(K)
        self._t0 = float(t0)
        self._init_sun = np.asarray(init_sun, bool).copy()
        self._trans = trans
        self._off = offsets
        self._counts = np.diff(offsets)
        self._ntrans = len(trans)
        if self._ntrans:
            rows = np.repeat(np.arange(K), self._counts)
            cols = np.arange(self._ntrans) - np.repeat(offsets[:-1],
                                                       self._counts)
            prev = np.where(cols > 0,
                            np.concatenate([[t0], trans[:-1]]), t0)
            state = self._init_sun[rows] ^ ((cols % 2) == 1)
            contrib = (trans - prev) * state
            cs = np.cumsum(contrib)
            first = np.repeat(offsets[:-1], self._counts)
            self._cum = cs - (cs[first] - contrib[first])
            # unclamped net energy (Wh, relative to t0) at each boundary —
            # the prefix the closed-form clamp resolution bisects into
            self._E = (self.gen_mw[rows] * self._cum
                       - self.load_mw[rows] * (trans - t0)) / _MWS_PER_WH
            g_order = np.argsort(trans, kind="stable")
            self._g_t = trans[g_order]
            self._g_sat = rows[g_order]
            self._g_E = self._E[g_order]
        else:
            self._cum = np.zeros(0, np.float64)
            self._E = np.zeros(0, np.float64)
            self._g_t = np.zeros(0, np.float64)
            self._g_sat = np.zeros(0, np.int64)
            self._g_E = np.zeros(0, np.float64)
        self._gp = 0           # global event cursor: transitions <= self.t
        self._rate_sun = (self.gen_mw - self.load_mw) / _MWS_PER_WH  # Wh/s
        self._rate_dark = -self.load_mw / _MWS_PER_WH
        self._rise_rate = np.maximum(self._rate_sun, 0.0)
        self._fall_sun_rate = np.maximum(-self._rate_sun, 0.0)
        self._fall_dark_rate = -self._rate_dark

    def _sun_upto(self, t, p):
        """(sunlit seconds in [t0, t], current state) per satellite, given
        the transition counts ``p`` at ``t``: a prefix-sum gather plus the
        partial tail of the current segment."""
        has = p > 0
        idx = np.clip(self._off[:-1] + p - 1, 0, max(self._ntrans - 1, 0))
        if self._ntrans:
            base = np.where(has, self._cum[idx], 0.0)
            last = np.where(has, self._trans[idx], self._t0)
        else:
            base = np.zeros(self._K)
            last = np.full(self._K, self._t0)
        state = self._init_sun ^ ((p % 2) == 1)
        return base + (t - last) * state, state

    # -- integration -----------------------------------------------------
    def advance_to(self, t: float) -> None:
        """Integrate idle draw + solar input up to time ``t`` (monotone:
        earlier times are a no-op, so repeated same-``t`` queries inside
        one round are idempotent).

        One bisection of the global transition times finds every
        terminator crossing in (self.t, t]; the fleet's SoC then updates
        in closed form: exactly linear for any battery whose clamp bounds
        cannot bind, one-sided Skorokhod reflection
        (``min(soc + dE, cap + E(t) - max_u E(u))`` and its mirror at 0,
        with the running extreme taken over just the crossed boundaries)
        when one bound may bind, and a per-segment analytic walk only for
        the rare batteries that could hit *both* bounds in one window."""
        t = float(t)
        if t <= self.t:
            return
        s = self.t
        gp2 = int(np.searchsorted(self._g_t, t, side="right"))
        n_ev = gp2 - self._gp
        if n_ev == 0:
            # no terminator crossing anywhere in the fleet: every battery
            # sits in one constant-rate segment — one clipped linear step
            state = self._state_at_t
            d = np.where(state, self._rate_sun, self._rate_dark) * (t - s)
            np.clip(self.soc_wh + d, 0.0, self.cap_wh, out=self.soc_wh)
            self._sun_at_t = self._sun_at_t + (t - s) * state
            self._E_at_t = self._E_at_t + d
            self.t = t
            return
        p_t = self._p_at_t + np.bincount(self._g_sat[self._gp:gp2],
                                         minlength=self._K)
        sun_t, state_t = self._sun_upto(t, p_t)
        sun = sun_t - self._sun_at_t
        dark = (t - s) - sun
        dE = self._rate_sun * sun + self._rate_dark * dark
        # clamp bounds: the SoC path rises only while sunlit (at most
        # (gen-load)+ * sunlit seconds) and falls at most load*dark +
        # (load-gen)+ * sunlit; a battery whose bounds stay inside
        # [0, cap] moves exactly linearly — no clamp can bind.
        up = self.soc_wh + self._rise_rate * sun > self.cap_wh
        dn = self.soc_wh - (self._fall_dark_rate * dark
                            + self._fall_sun_rate * sun) < 0.0
        E_t = self._E_at_t + dE
        if not (up.any() or dn.any()):
            self.soc_wh += dE
        else:
            # running extremes of the unclamped energy over [s, t]: E is
            # piecewise linear, so they sit at the crossed transition
            # boundaries or at the window endpoints.
            max_e = np.maximum(self._E_at_t, E_t)
            min_e = np.minimum(self._E_at_t, E_t)
            ev_sat = self._g_sat[self._gp:gp2]
            ev_e = self._g_E[self._gp:gp2]
            np.maximum.at(max_e, ev_sat, ev_e)
            np.minimum.at(min_e, ev_sat, ev_e)
            lin = self.soc_wh + dE
            # one-sided reflections (exact when the other bound never
            # binds, which `up`/`dn` conservatively certify)
            hi = np.minimum(lin, self.cap_wh + E_t - max_e)
            lo = np.maximum(lin, E_t - min_e)
            new = np.where(dn, lo, hi)
            both = up & dn
            if both.any():
                rows = np.nonzero(both)[0]
                new[rows] = self._walk_segments(rows,
                                                self.soc_wh[rows].copy(),
                                                s, t)
            np.clip(new, 0.0, self.cap_wh, out=new)
            self.soc_wh = new
        self._gp = gp2
        self._p_at_t = p_t
        self._sun_at_t = sun_t
        self._state_at_t = state_t
        self._E_at_t = E_t
        self.t = t

    def _walk_segments(self, rows, soc, s: float, t: float) -> np.ndarray:
        """Advance the satellites in ``rows`` from ``s`` to ``t`` segment
        by segment with per-segment clamping (within a constant-rate
        segment the SoC moves monotonically, so the segment-end clamp
        equals the reference's per-cell clamp). Iteration count = max
        transitions any one of these satellites crosses in (s, t], not
        the number of grid cells."""
        cap = self.cap_wh[rows]
        gen, load = self.gen_mw[rows], self.load_mw[rows]
        cnt = self._counts[rows]
        offr = self._off[:-1][rows]
        init = self._init_sun[rows]
        j = self._p_at_t[rows].copy()
        cur = np.full(len(rows), s)
        while True:
            has = j < cnt
            if self._ntrans:
                idx = np.clip(offr + j, 0, self._ntrans - 1)
                b = np.where(has, self._trans[idx], np.inf)
            else:
                b = np.full(len(rows), np.inf)
            np.minimum(b, t, out=b)
            state = init ^ ((j % 2) == 1)
            rate = (gen * state - load) / _MWS_PER_WH
            soc += rate * (b - cur)
            np.clip(soc, 0.0, cap, out=soc)
            if not np.any(b < t):
                return soc
            cur = b
            j += 1

    # -- queries ---------------------------------------------------------
    def transition_events(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every terminator crossing as flat event arrays
        ``(sat, t, entering_eclipse)`` — the eclipse entry/exit sources of
        the discrete-event timeline
        (``repro_torch.sim.events.WorldTimeline``).
        A satellite sunlit before its j-th transition enters eclipse at
        it; states alternate from ``init_sun`` thereafter."""
        rows = np.repeat(np.arange(self._K), self._counts)
        cols = np.arange(self._ntrans) - np.repeat(self._off[:-1],
                                                   self._counts)
        entering = self._init_sun[rows] ^ ((cols % 2) == 1)
        return rows, self._trans, entering

    def soc_frac(self) -> np.ndarray:
        """(K,) state of charge as a fraction of capacity."""
        return self.soc_wh / np.maximum(self.cap_wh, 1e-12)

    def _counts_at(self, t: float) -> np.ndarray:
        """(K,) terminator crossings at or before ``t`` per satellite
        (a pure read of the globally time-sorted transition view; the
        integration cursors are untouched)."""
        gp = int(np.searchsorted(self._g_t, float(t), side="right"))
        return np.bincount(self._g_sat[:gp], minlength=self._K)

    def sunlit_at(self, t: float) -> np.ndarray:
        """(K,) bool: which satellites are in sunlight at ``t``. A pure
        query of the packed eclipse series (selection-policy score
        input) — never advances the battery integration."""
        return self._init_sun ^ ((self._counts_at(t) % 2) == 1)

    def sunrise_after(self, t: float) -> np.ndarray:
        """(K,) earliest time >= ``t`` each satellite is sunlit: ``t``
        itself when already in sun, its next dark→sun terminator
        crossing otherwise, ``np.inf`` for a satellite whose final
        (held-forever) state is eclipse. The sunlit-arc deferral target
        of the ``energy_aware`` selection policy. Pure query."""
        p = self._counts_at(t)
        sunlit = self._init_sun ^ ((p % 2) == 1)
        out = np.full(self._K, float(t))
        if self._ntrans:
            idx = self._off[:-1] + p
            has = p < self._counts
            nxt = np.where(has,
                           self._trans[np.clip(idx, 0, self._ntrans - 1)],
                           np.inf)
        else:
            nxt = np.full(self._K, np.inf)
        out[~sunlit] = nxt[~sunlit]
        return out

    def eligible(self) -> np.ndarray:
        """(K,) bool: SoC at or above the participation floor."""
        return self.soc_wh >= self.min_soc * self.cap_wh - 1e-12

    def recover_times(self, ks) -> np.ndarray:
        """Batched floor recovery: for each satellite in ``ks``, the
        earliest time >= ``t`` at which its SoC (idle + solar only)
        reaches the participation floor, or ``np.inf`` if it never does
        (the final eclipse state is held forever, so a net-positive final
        segment always recovers). One vectorized segment walk for the
        whole query set; crossings are resolved analytically inside the
        constant-rate segment where they occur."""
        ks = np.asarray(ks, np.int64)
        n = len(ks)
        target = self.min_soc * self.cap_wh[ks]
        soc = self.soc_wh[ks].astype(np.float64)
        res = np.full(n, np.inf)
        done = soc >= target - 1e-12
        res[done] = self.t
        if n == 0 or done.all():
            return res
        cnt = self._counts[ks]
        offk = self._off[:-1][ks]
        init = self._init_sun[ks]
        gen, load = self.gen_mw[ks], self.load_mw[ks]
        cap = self.cap_wh[ks]
        j = self._p_at_t[ks].copy()
        cur = np.full(n, self.t)
        while True:
            has = j < cnt
            if self._ntrans:
                idx = np.clip(offk + j, 0, self._ntrans - 1)
                b = np.where(has, self._trans[idx], np.inf)
            else:
                b = np.full(n, np.inf)
            state = init ^ ((j % 2) == 1)
            rate = (gen * state - load) / _MWS_PER_WH
            pos = ~done & (rate > 0)
            cross = cur + (target - soc) / np.where(rate > 0, rate, 1.0)
            hit = pos & (cross <= b)
            res[hit] = cross[hit]
            done |= hit | ~has      # ~has: the held final segment
            if done.all():
                return res
            step = np.where(np.isfinite(b), b - cur, 0.0)
            soc = np.clip(soc + rate * step, 0.0, cap)
            cur = np.where(np.isfinite(b), b, cur)
            j += 1

    def recover_time(self, k: int) -> Optional[float]:
        """Scalar ``recover_times`` (compat wrapper): the earliest
        recovery time of satellite ``k``, or None if it never recovers."""
        rt = float(self.recover_times(np.array([k]))[0])
        return rt if np.isfinite(rt) else None

    # -- FL activity billing --------------------------------------------
    def activity_wh(self, ks: np.ndarray, train_s: np.ndarray,
                    comm_s: np.ndarray) -> np.ndarray:
        """Added energy (above idle) of ``train_s`` seconds of on-board
        training and ``comm_s`` seconds of keyed radio for sats ``ks``."""
        ks = np.asarray(ks, np.int64)
        return (np.asarray(train_s) * (self.train_mw[ks] - self.idle_mw[ks])
                + np.asarray(comm_s) * (self.tx_mw[ks] - self.idle_mw[ks])
                ) / _MWS_PER_WH

    def bill_activity(self, ks, train_s, comm_s) -> float:
        """Subtract the added FL energy from ``ks``'s batteries (clamped at
        0) and return the total watt-hours billed. Duplicate indices in
        ``ks`` accumulate (bincount scatter, not a fancy-index store)."""
        ks = np.asarray(ks, np.int64)
        wh = self.activity_wh(ks, train_s, comm_s)
        self.soc_wh -= np.bincount(ks, weights=wh,
                                   minlength=len(self.soc_wh))
        np.clip(self.soc_wh, 0.0, self.cap_wh, out=self.soc_wh)
        return float(wh.sum())
