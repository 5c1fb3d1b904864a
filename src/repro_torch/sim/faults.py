"""Fault injection for the constellation: stochastic outages, dropped
contacts, radiation resets, silent payload corruption, correlated storms,
and the IWQoS'23 energy-drain and poisoning attacks.

Port of the JAX package's ``sim/faults.py``. The module is numpy only and
is copied as it is, so every draw comes out bitwise as there:

  * **Outages** — per-satellite alternating exponential up/down times,
    packed as CSR interval arrays (flat sorted ``(start, end)`` arrays
    with per-satellite offsets plus padded ``(K, Wmax)`` views), so
    :meth:`FaultSim.available` and :meth:`FaultSim.next_up` answer the
    whole fleet with one vectorized comparison.
  * **Dropped contacts** — per-contact Bernoulli(``drop_prob``) draws,
    counter-based: the RNG is keyed by ``(seed, stream, sat, quantized
    contact time)``, so a contact's fate is a pure function of the seed,
    independent of query order or engine. Retries are fresh draws.
  * **Radiation resets** — per-satellite Poisson event times, CSR-packed;
    a reset wipes the satellite's local FL state and loses any in-flight
    transmission.
  * **Silent payload corruption** — per-delivery Bernoulli(``corrupt_prob``)
    SEU draws on the same counter-based contract; a firing draw also fixes
    the corruption's shape (sign flip, scale blow-up or seeded noise, see
    :meth:`FaultSim.corruption_at`).
  * **Correlated storms** (:class:`StormConfig`) — regional events over one
    orbital plane: seeded full outages merged into the CSR arrays, and
    raised drop / corruption thresholds while active (the draw keys never
    change, only the thresholds).
  * **Energy-drain attack** (:class:`EnergyDrainAttack`) and **poison
    attack** (:class:`PoisonAttack`).

RNG convention: ``FLConfig.seed`` drives the engine's training draws
(``repro_torch.rng``); ``FaultConfig.seed`` drives an independent
``np.random.default_rng`` stream for every fault draw. The two never mix,
so adding faults perturbs scheduling, never the training randomness.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# sub-stream tags under FaultConfig.seed (SeedSequence entropy words):
# one seed, disjoint named streams, order-independent draws.
_STREAM_OUTAGE = 1
_STREAM_RESET = 2
_STREAM_DROP = 3
_STREAM_PAIR_DROP = 4
_STREAM_CORRUPT = 5
_STREAM_STORM = 6


@dataclasses.dataclass(frozen=True)
class StormEvent:
    """One correlated regional fault event: for
    ``[t_start, t_start + duration_s)`` every satellite whose plane /
    cluster (``ContactPlan.cluster_of``) equals ``cluster`` sits inside
    the storm footprint at the given ``severity`` in (0, 1]."""
    t_start: float
    duration_s: float
    cluster: int
    severity: float = 1.0

    @property
    def t_end(self) -> float:
        return self.t_start + self.duration_s


@dataclasses.dataclass(frozen=True)
class StormConfig:
    """Correlated storm faults (``FaultConfig.storms``).

    The base faults are i.i.d. per satellite; a solar/geomagnetic storm is
    not — it hits a whole orbital plane at once. A storm is an interval
    event over one cluster footprint; while it is active each footprint
    satellite sees (a) a seeded chance of a full outage for the storm
    interval, expanded into the same CSR outage arrays the engines
    already query, (b) elevated per-contact drop odds, and (c) elevated
    SEU-corruption odds — all scaled by the event's severity.

    rate_per_day
        Poisson arrival rate of *drawn* storms over the horizon (whole
        constellation; each drawn storm picks a uniform cluster, an
        exponential duration of mean ``mean_duration_s`` and a severity
        ~ Uniform[``severity_range``]). 0 disables drawing — scripted
        ``events`` still apply.
    outage_prob
        P(a footprint satellite is knocked into a full outage spanning
        the storm interval) x severity, drawn once per (storm, sat)
        from the ``_STREAM_STORM`` stream.
    drop_prob / corrupt_prob
        Added (x severity, clamped to 1) on top of the base
        ``FaultConfig.drop_prob`` / ``corrupt_prob`` for footprint
        satellites while the storm is active. The underlying Bernoulli
        draws keep their counter-based keys — a storm only moves the
        threshold, so the no-storm draw stream is untouched.
    events
        Scripted :class:`StormEvent` tuple, merged with the drawn ones
        (the degradation benchmark scripts a plane-wide storm this way).
    """
    rate_per_day: float = 0.0
    mean_duration_s: float = 10_800.0
    severity_range: Tuple[float, float] = (0.5, 1.0)
    outage_prob: float = 1.0
    drop_prob: float = 0.5
    corrupt_prob: float = 0.0
    events: Tuple[StormEvent, ...] = ()

    @property
    def any_events(self) -> bool:
        return self.rate_per_day > 0.0 or len(self.events) > 0


@dataclasses.dataclass(frozen=True)
class EnergyDrainAttack:
    """IWQoS'23 energy-drain attack against a battery-gated fleet.

    The attacker crafts a contact/activity schedule — bogus handshakes,
    beam-switch storms, junk uplink jobs — that forces each victim to key
    its radio (``mode="radio_tx"``) or run its payload compute while
    transmitting (``mode="training_tx"``) for ``duty`` of every second.
    The forced draw is the *added* power of that mode above idle, exactly
    like legitimate FL activity billing, so attack and workload energy
    are directly comparable.

    ``eclipse_only=True`` is the attacker-optimal schedule against a
    solar-charged fleet, and the scenario the benchmark reports: while
    sunlit the panel surplus absorbs the forced draw, but in eclipse
    every forced milliwatt comes straight out of the battery *and* pushes
    floor recovery past the next sunlit arc — concentrating the same
    attack energy where its marginal damage is highest is what pins
    victims below the SoC participation floor. ``eclipse_only=False``
    models a naive always-on attacker for comparison.

    ``targets`` selects the victim satellites (``None`` = whole fleet).
    """
    duty: float = 0.25                 # fraction of each second forced
    mode: str = "radio_tx"             # "radio_tx" | "training_tx"
    eclipse_only: bool = True          # attacker-optimal schedule
    targets: Optional[Tuple[int, ...]] = None

    def added_load_mw(self, idle_mw: np.ndarray, tx_mw: np.ndarray,
                      training_tx_mw: np.ndarray) -> np.ndarray:
        """(K,) forced draw above idle under this attack."""
        mode_mw = {"radio_tx": np.asarray(tx_mw),
                   "training_tx": np.asarray(training_tx_mw)}[self.mode]
        atk = self.duty * (mode_mw - np.asarray(idle_mw))
        if self.targets is not None:
            mask = np.zeros(len(atk), bool)
            mask[np.asarray(self.targets, np.int64)] = True
            atk = np.where(mask, atk, 0.0)
        return atk


@dataclasses.dataclass(frozen=True)
class PoisonAttack:
    """Model-poisoning attack: adversary-controlled satellites submit
    scaled malicious deltas (the IWQoS'23 adversarial framing extended
    from energy-drain to updates).

    Every update a compromised satellite delivers is replaced by the
    model-replacement attack of Bhagoji et al. / Blanchard et al.: the
    honest local delta is reversed and amplified,

        submitted = reference - scale * (trained - reference)

    where ``reference`` is the broadcast model the client trained from.
    With plain weighted-mean aggregation one such update drags the
    global model ``scale`` cohort-shares backwards per round; rank-based
    robust aggregators (trimmed mean, median, Krum) reject it as an
    outlier coordinate-wise.

    ``satellites`` lists the compromised satellite indices; ``scale``
    is the amplification factor (1.0 = plain sign flip of the delta).
    """
    satellites: Tuple[int, ...] = ()
    scale: float = 5.0

    def compromised(self, k: int) -> bool:
        return int(k) in self.satellites


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-injection knobs (``FLConfig.faults``).

    mean_up_s / mean_down_s
        Per-satellite outage process: up-times and outage durations are
        independent exponentials with these means. ``mean_up_s=inf``
        (default) disables outages entirely.
    drop_prob
        Probability that any single contact-window transmission attempt
        (return downlink, FedBuff pickup/return, AutoFLSat ISL pair hop)
        is lost. The transmission is retried at the next usable window
        with its bytes re-billed (``RoundRecord.retransmit_bytes``).
    corrupt_prob
        Probability that a *delivered* model update was silently
        corrupted by an SEU in payload memory or on the wire. Unlike a
        drop, the server receives (and bills) the transmission — the
        payload is just wrong: the update row is sign-flipped, blown up
        by a large scale factor, or overwritten with large-magnitude
        noise (the shape is part of the seeded draw,
        :meth:`FaultSim.corruption_at`). Counted in
        ``RoundRecord.corrupted_updates``; the defense is
        ``FLConfig.aggregator`` (robust aggregation).
    radiation_rate_per_day
        Poisson rate of radiation resets per satellite per day. A reset
        wipes the satellite's local FL state and loses its in-flight
        update (zero-weight slot; counted in
        ``RoundRecord.skipped_faulted``).
    seed
        Seed of the single ``np.random.default_rng`` fault stream,
        independent of ``FLConfig.seed``'s training draws. ``None``
        means "inherit the experiment seed": ``FLySTacK`` substitutes
        ``SimConfig.seed``; engines built directly treat ``None`` as 0.
    attack
        Optional :class:`EnergyDrainAttack`. Requires ``FLConfig.energy``
        (the attack drains batteries, so there must be batteries).
    poison
        Optional :class:`PoisonAttack`: the listed satellites replace
        every update they deliver with a scaled malicious delta.
    storms
        Optional :class:`StormConfig`: correlated regional events that
        expand into extra outages and elevated drop/corrupt rates for
        the affected cluster while active. ``None`` (default) keeps
        every fault draw bitwise-identical to the storm-free engines.
    """
    mean_up_s: float = float("inf")
    mean_down_s: float = 1800.0
    drop_prob: float = 0.0
    corrupt_prob: float = 0.0
    radiation_rate_per_day: float = 0.0
    seed: Optional[int] = None
    attack: Optional[EnergyDrainAttack] = None
    poison: Optional[PoisonAttack] = None
    storms: Optional["StormConfig"] = None

    @property
    def seed_value(self) -> int:
        return 0 if self.seed is None else int(self.seed)

    @property
    def has_base_outages(self) -> bool:
        """The i.i.d. per-satellite outage process is on."""
        return np.isfinite(self.mean_up_s) and self.mean_down_s > 0.0

    @property
    def has_storms(self) -> bool:
        return self.storms is not None and self.storms.any_events

    @property
    def has_outages(self) -> bool:
        """Satellites can be down: i.i.d. outages or storm knockouts.
        Gates the outage-aware contact walks in the engines."""
        return self.has_base_outages or (
            self.has_storms and self.storms.outage_prob > 0.0)

    @property
    def has_resets(self) -> bool:
        return self.radiation_rate_per_day > 0.0

    @property
    def has_payload_faults(self) -> bool:
        """True when deliveries can carry bad payloads — SEU corruption
        or a poison attack. The engines skip the payload pass entirely
        otherwise, keeping the zero-rate path bitwise-identical."""
        return self.corrupt_prob > 0.0 or (
            self.poison is not None and len(self.poison.satellites) > 0) or (
            self.has_storms and self.storms.corrupt_prob > 0.0)


def _sat_rng(seed: int, stream: int, k: int) -> np.random.Generator:
    """Named per-satellite sub-stream of the single fault seed."""
    return np.random.default_rng([int(seed), int(stream), int(k)])


class FaultSim:
    """Precomputed fault timeline over the whole constellation.

    Outage intervals and radiation-reset times are drawn once at
    construction from the seeded stream and packed as CSR arrays (flat
    sorted per-satellite values + ``(K+1,)`` offsets) with inf-padded
    ``(K, Wmax)`` views — the ``PackedEclipse`` layout — so the batched
    queries below are single vectorized passes. Per-contact drop draws
    are counter-based (keyed by satellite + contact time), so they need
    no precomputation and no mutable RNG state.
    """

    def __init__(self, cfg: FaultConfig, n_sats: int, horizon_s: float,
                 t0: float = 0.0, cluster_of=None):
        self.cfg = cfg
        self.n_sats = K = int(n_sats)
        self.horizon_s = float(horizon_s)
        self.t0 = float(t0)
        if cluster_of is None:
            self.cluster_of = np.zeros(K, np.int64)
        else:
            self.cluster_of = np.asarray(cluster_of, np.int64)
        self.n_clusters = int(self.cluster_of.max()) + 1 if K else 1
        seed = cfg.seed_value
        starts, ends = [], []
        counts = np.zeros(K, np.int64)
        if cfg.has_base_outages:
            for k in range(K):
                rng = _sat_rng(seed, _STREAM_OUTAGE, k)
                t = self.t0 + rng.exponential(cfg.mean_up_s)
                while t < self.horizon_s:
                    d = rng.exponential(cfg.mean_down_s)
                    starts.append(t)
                    ends.append(t + d)        # may extend past the horizon
                    counts[k] += 1
                    t = t + d + rng.exponential(cfg.mean_up_s)
        starts = np.asarray(starts, np.float64)
        ends = np.asarray(ends, np.float64)
        self._storms: list = []
        if cfg.has_storms:
            self._draw_storms()
            s_sat, s_start, s_end = self._storm_outage_intervals()
            if len(s_sat):
                # merge storm knockouts into the base CSR outage arrays;
                # only this path re-sorts, so storms=None leaves the base
                # arrays byte-identical to the pre-storm construction
                sat = np.concatenate([np.repeat(np.arange(K), counts), s_sat])
                starts, ends, counts = self._merge_sat_intervals(
                    sat, np.concatenate([starts, s_start]),
                    np.concatenate([ends, s_end]), K)
        self._build_outage_arrays(starts, ends, counts)
        self._build_storm_arrays()
        resets = []
        rcounts = np.zeros(K, np.int64)
        if cfg.has_resets:
            mean_gap = 86_400.0 / cfg.radiation_rate_per_day
            for k in range(K):
                rng = _sat_rng(seed, _STREAM_RESET, k)
                t = self.t0 + rng.exponential(mean_gap)
                while t < self.horizon_s:
                    resets.append(t)
                    rcounts[k] += 1
                    t += rng.exponential(mean_gap)
        self._build_reset_arrays(np.asarray(resets, np.float64), rcounts)

    @classmethod
    def for_plan(cls, plan, cfg: FaultConfig) -> "FaultSim":
        return cls(cfg, plan.constellation.n_sats, plan.horizon_s,
                   cluster_of=plan.cluster_of)

    # -- correlated storms ----------------------------------------------
    def _draw_storms(self) -> None:
        """Scripted events + Poisson-drawn events, time-sorted. Drawn
        storms come from the dedicated ``_STREAM_STORM`` stream so
        enabling them never perturbs the outage/reset/drop draws."""
        sc = self.cfg.storms
        evs = [StormEvent(float(e.t_start), float(e.duration_s),
                          int(e.cluster), float(e.severity))
               for e in sc.events]
        if sc.rate_per_day > 0.0:
            rng = np.random.default_rng(
                [self.cfg.seed_value, _STREAM_STORM])
            mean_gap = 86_400.0 / sc.rate_per_day
            lo, hi = sc.severity_range
            t = self.t0 + rng.exponential(mean_gap)
            while t < self.horizon_s:
                dur = rng.exponential(sc.mean_duration_s)
                cluster = int(rng.integers(self.n_clusters))
                sev = float(rng.uniform(lo, hi))
                evs.append(StormEvent(t, dur, cluster, sev))
                t = t + dur + rng.exponential(mean_gap)
        self._storms = sorted(evs, key=lambda e: (e.t_start, e.cluster))

    def _storm_outage_intervals(self):
        """Per-(storm, satellite) knockout draws: each footprint
        satellite is knocked into a full outage spanning the storm with
        probability ``outage_prob * severity``, keyed
        ``(seed, _STREAM_STORM, sat, storm_index)`` so the fate is a
        pure function of the fault seed."""
        sc = self.cfg.storms
        sats, starts, ends = [], [], []
        if sc.outage_prob <= 0.0:
            return (np.asarray(sats, np.int64), np.asarray(starts),
                    np.asarray(ends))
        seed = self.cfg.seed_value
        for i, ev in enumerate(self._storms):
            p = min(1.0, sc.outage_prob * ev.severity)
            for k in np.nonzero(self.cluster_of == ev.cluster)[0]:
                rng = np.random.default_rng(
                    [seed, _STREAM_STORM, int(k), i])
                if rng.random() < p:
                    sats.append(int(k))
                    starts.append(ev.t_start)
                    ends.append(ev.t_end)
        return (np.asarray(sats, np.int64),
                np.asarray(starts, np.float64), np.asarray(ends, np.float64))

    @staticmethod
    def _merge_sat_intervals(sats, starts, ends, n_sats):
        """Merge possibly-overlapping per-satellite intervals into the
        sorted non-overlapping CSR form ``available``/``next_up``
        require (their bisection assumes per-satellite starts AND ends
        are monotone). Touching intervals (``end == next start``) merge
        too — ``[s, e) ∪ [e, e2) = [s, e2)`` under the half-open outage
        semantics. Returns flat ``(starts, ends, counts)``."""
        order = np.lexsort((starts, sats))
        sats, starts, ends = sats[order], starts[order], ends[order]
        out_s, out_e = [], []
        counts = np.zeros(n_sats, np.int64)
        cur_sat, cur_s, cur_e, have = -1, 0.0, 0.0, False
        for k, s, e in zip(sats, starts, ends):
            if have and k == cur_sat and s <= cur_e:
                cur_e = max(cur_e, e)
                continue
            if have:
                out_s.append(cur_s)
                out_e.append(cur_e)
                counts[cur_sat] += 1
            cur_sat, cur_s, cur_e, have = int(k), float(s), float(e), True
        if have:
            out_s.append(cur_s)
            out_e.append(cur_e)
            counts[cur_sat] += 1
        return (np.asarray(out_s, np.float64), np.asarray(out_e, np.float64),
                counts)

    def _build_storm_arrays(self):
        """Cluster-level storm interval arrays for the severity queries
        (padded like the CSR views: start=inf rows are never active)."""
        C = self.n_clusters
        n_by_c = np.zeros(C, np.int64)
        for ev in self._storms:
            n_by_c[ev.cluster] += 1
        smax = max(int(n_by_c.max()) if C else 0, 1)
        self._stm_start = np.full((C, smax), np.inf)
        self._stm_end = np.full((C, smax), np.inf)
        self._stm_sev = np.zeros((C, smax))
        col = np.zeros(C, np.int64)
        for ev in self._storms:
            c, j = ev.cluster, col[ev.cluster]
            self._stm_start[c, j] = ev.t_start
            self._stm_end[c, j] = ev.t_end
            self._stm_sev[c, j] = ev.severity
            col[c] += 1
        self._storm_t0 = np.sort([ev.t_start for ev in self._storms])

    # -- packed CSR layout ----------------------------------------------
    def _build_outage_arrays(self, starts, ends, counts):
        K = self.n_sats
        self._out_counts = counts
        self._out_off = np.zeros(K + 1, np.int64)
        np.cumsum(counts, out=self._out_off[1:])
        self._out_start, self._out_end = starts, ends
        wmax = max(int(counts.max()) if K else 0, 1)
        self._out_start_pad = np.full((K, wmax), np.inf)
        self._out_end_pad = np.full((K, wmax), np.inf)
        if len(starts):
            rows = np.repeat(np.arange(K), counts)
            cols = np.arange(len(starts)) - np.repeat(self._out_off[:-1],
                                                      counts)
            self._out_start_pad[rows, cols] = starts
            self._out_end_pad[rows, cols] = ends

    def _build_reset_arrays(self, times, counts):
        K = self.n_sats
        self._rst_counts = counts
        self._rst_off = np.zeros(K + 1, np.int64)
        np.cumsum(counts, out=self._rst_off[1:])
        self._rst_t = times
        wmax = max(int(counts.max()) if K else 0, 1)
        self._rst_pad = np.full((K, wmax), np.inf)
        if len(times):
            rows = np.repeat(np.arange(K), counts)
            cols = np.arange(len(times)) - np.repeat(self._rst_off[:-1],
                                                     counts)
            self._rst_pad[rows, cols] = times

    # -- batched queries (the eligibility-mask hot path) ----------------
    def available(self, t) -> np.ndarray:
        """(K,) bool: satellite up (not inside an outage interval) at
        ``t`` (scalar or per-satellite (K,)). An outage spans
        ``[start, end)`` — the satellite is back up exactly at ``end``."""
        tq = np.broadcast_to(np.asarray(t, np.float64), (self.n_sats,))
        n_started = np.sum(self._out_start_pad <= tq[:, None], axis=1)
        n_ended = np.sum(self._out_end_pad <= tq[:, None], axis=1)
        return n_started == n_ended

    def next_up(self, ks, t) -> np.ndarray:
        """Batched recovery query: for each satellite ``ks[i]`` the
        earliest time >= ``t[i]`` at which it is up — ``t[i]`` itself if
        it is not in an outage, else the end of the outage containing
        ``t[i]`` (outages are drawn with finite exponential durations, so
        every satellite comes back; an end past the horizon simply lands
        the query past every contact window)."""
        ks = np.asarray(ks, np.int64)
        tq = np.broadcast_to(np.asarray(t, np.float64), ks.shape)
        sp, ep = self._out_start_pad[ks], self._out_end_pad[ks]
        n_started = np.sum(sp <= tq[:, None], axis=1)
        n_ended = np.sum(ep <= tq[:, None], axis=1)
        down = n_started > n_ended
        idx = np.minimum(n_ended, np.maximum(self._out_counts[ks] - 1, 0))
        end = ep[np.arange(len(ks)), idx]
        return np.where(down, end, tq)

    def outage_events(self):
        """Every outage interval as flat event arrays
        ``(sat, starts, ends)`` — the fault down/up sources of the
        discrete-event timeline (``repro_torch.sim.events.WorldTimeline``)."""
        sat = np.repeat(np.arange(self.n_sats), self._out_counts)
        return sat, self._out_start, self._out_end

    def reset_events(self):
        """Every radiation reset as flat event arrays ``(sat, t)``."""
        sat = np.repeat(np.arange(self.n_sats), self._rst_counts)
        return sat, self._rst_t

    def outage_fraction(self) -> np.ndarray:
        """(K,) fraction of [t0, horizon] each satellite spends down."""
        span = max(self.horizon_s - self.t0, 1e-12)
        clip_s = np.clip(self._out_start, self.t0, self.horizon_s)
        clip_e = np.clip(self._out_end, self.t0, self.horizon_s)
        down = np.zeros(self.n_sats)
        np.add.at(down, np.repeat(np.arange(self.n_sats), self._out_counts),
                  clip_e - clip_s)
        return down / span

    # -- radiation resets -----------------------------------------------
    def resets_between(self, ks, t_from, t_to) -> np.ndarray:
        """Batched count of radiation resets of ``ks[i]`` in
        ``(t_from[i], t_to[i]]`` (searchsorted on the padded CSR rows).
        An empty or inverted interval (``t_to <= t_from``) counts zero —
        the clamp keeps the contract total rather than letting the
        cumulative-count difference go negative."""
        ks = np.asarray(ks, np.int64)
        a = np.broadcast_to(np.asarray(t_from, np.float64), ks.shape)
        b = np.broadcast_to(np.asarray(t_to, np.float64), ks.shape)
        rp = self._rst_pad[ks]
        return np.maximum(np.sum(rp <= b[:, None], axis=1)
                          - np.sum(rp <= a[:, None], axis=1), 0)

    def reset_in(self, k: int, t_from: float, t_to: float) -> bool:
        """Scalar ``resets_between`` > 0 (FedBuff's per-event check)."""
        return bool(self.resets_between(np.array([k]), np.array([t_from]),
                                        np.array([t_to]))[0] > 0)

    # -- storm queries ---------------------------------------------------
    @property
    def has_storms(self) -> bool:
        return bool(self._storms)

    def _cluster_storm_sev(self, c: int, t: float) -> float:
        """Max severity of a storm active over cluster ``c`` at ``t``
        (0.0 = clear skies). A storm spans ``[t_start, t_end)``."""
        if not self._storms:
            return 0.0
        sp, ep, sv = self._stm_start[c], self._stm_end[c], self._stm_sev[c]
        act = (sp <= t) & (t < ep)
        return float(np.max(np.where(act, sv, 0.0)))

    def storm_severity(self, ks, t) -> np.ndarray:
        """Batched: max active-storm severity over ``ks[i]``'s cluster
        at ``t[i]`` (0 where no storm is active)."""
        ks = np.asarray(ks, np.int64)
        if not self._storms:
            return np.zeros(ks.shape)
        tq = np.broadcast_to(np.asarray(t, np.float64), ks.shape)
        cs = self.cluster_of[ks]
        sp, ep, sv = self._stm_start[cs], self._stm_end[cs], self._stm_sev[cs]
        act = (sp <= tq[:, None]) & (tq[:, None] < ep)
        return np.max(np.where(act, sv, 0.0), axis=1)

    def storm_exposure(self, ks, t_from, t_to) -> np.ndarray:
        """Batched interval query: for each satellite ``ks[i]``, the max
        severity of any storm over its cluster whose active span
        ``[t_start, t_end)`` overlaps ``[t_from[i], t_to[i])`` (0 where
        the interval is clear). The ``deadline_aware`` selection
        policy's storm-avoidance input: a candidate is "exposed" when
        its contact→projected-delivery interval intersects a storm
        footprint, whether the storm is already raging or forecast to
        break mid-flight. A pure query of the padded per-cluster storm
        arrays — no RNG, no state."""
        ks = np.asarray(ks, np.int64)
        if not self._storms:
            return np.zeros(ks.shape)
        a = np.broadcast_to(np.asarray(t_from, np.float64), ks.shape)
        b = np.broadcast_to(np.asarray(t_to, np.float64), ks.shape)
        cs = self.cluster_of[ks]
        sp, ep, sv = self._stm_start[cs], self._stm_end[cs], self._stm_sev[cs]
        act = (sp < b[:, None]) & (ep > a[:, None])
        return np.max(np.where(act, sv, 0.0), axis=1)

    def storms_between(self, t_from: float, t_to: float) -> int:
        """Count of storms *beginning* in ``(t_from, t_to]`` — the
        per-round ``RoundRecord.storm_events`` counter (each storm is
        attributed to exactly one round, the one during which it broke)."""
        if not self._storms:
            return 0
        return int(np.searchsorted(self._storm_t0, t_to, side="right")
                   - np.searchsorted(self._storm_t0, t_from, side="right"))

    def storm_timeline_events(self):
        """Every storm as flat event arrays ``(cluster, t_begin, t_end)``
        — the ``STORM_BEGIN``/``STORM_END`` sources of the discrete-event
        timeline (``repro_torch.sim.events.WorldTimeline``), keyed by
        cluster."""
        cl = np.asarray([ev.cluster for ev in self._storms], np.int64)
        tb = np.asarray([ev.t_start for ev in self._storms], np.float64)
        te = np.asarray([ev.t_end for ev in self._storms], np.float64)
        return cl, tb, te

    def drop_prob_at(self, k: int, t: float) -> float:
        """Effective per-contact drop probability for satellite ``k`` at
        ``t``: the base rate plus ``severity * storms.drop_prob`` while a
        storm covers its cluster (clamped to 1)."""
        p = self.cfg.drop_prob
        sc = self.cfg.storms
        if sc is not None and self._storms and sc.drop_prob > 0.0:
            sev = self._cluster_storm_sev(int(self.cluster_of[k]), float(t))
            if sev > 0.0:
                p = min(1.0, p + sc.drop_prob * sev)
        return p

    def pair_drop_prob_at(self, ci: int, cj: int, t: float) -> float:
        """Effective ISL pair-hop drop probability: boosted when a storm
        covers either endpoint cluster (the worse of the two)."""
        p = self.cfg.drop_prob
        sc = self.cfg.storms
        if sc is not None and self._storms and sc.drop_prob > 0.0:
            sev = max(self._cluster_storm_sev(int(ci), float(t)),
                      self._cluster_storm_sev(int(cj), float(t)))
            if sev > 0.0:
                p = min(1.0, p + sc.drop_prob * sev)
        return p

    def corrupt_prob_at(self, k: int, t: float) -> float:
        """Effective SEU-corruption probability at delivery time (storm
        boost, same clamp as the drop boost)."""
        p = self.cfg.corrupt_prob
        sc = self.cfg.storms
        if sc is not None and self._storms and sc.corrupt_prob > 0.0:
            sev = self._cluster_storm_sev(int(self.cluster_of[k]), float(t))
            if sev > 0.0:
                p = min(1.0, p + sc.corrupt_prob * sev)
        return p

    # -- per-contact drop draws (counter-based, order-independent) ------
    def _bernoulli(self, stream: int, a: int, b: int, t: float,
                   prob: float) -> bool:
        if prob <= 0.0:
            return False
        # quantize the contact time to ms so float noise cannot re-key a
        # draw; distinct attempts are at distinct windows => fresh draws
        key = [self.cfg.seed_value, stream, int(a), int(b),
               int(round(float(t) * 1e3))]
        return bool(np.random.default_rng(key).random() < prob)

    def contact_dropped(self, k: int, t_contact: float) -> bool:
        """Seeded fate of the transmission attempt of satellite ``k`` at
        the contact starting ``t_contact`` — a pure function of
        (seed, k, t_contact). A storm over ``k``'s cluster raises the
        threshold of the *same* draw (the key never changes), so the
        storm-free stream is untouched and a given contact can only flip
        toward dropping when a storm is added."""
        return self._bernoulli(_STREAM_DROP, k, 0, t_contact,
                               self.drop_prob_at(k, t_contact))

    def pair_dropped(self, ci: int, cj: int, t_attempt: float) -> bool:
        """Seeded fate of the AutoFLSat ISL pair hop (ci, cj) attempted
        at ``t_attempt`` (independent per hop, per attempt; storm boost
        from either endpoint cluster)."""
        return self._bernoulli(_STREAM_PAIR_DROP, ci, cj, t_attempt,
                               self.pair_drop_prob_at(ci, cj, t_attempt))

    # -- silent payload corruption (counter-based, order-independent) ----
    def corruption_at(self, k: int, t_deliver: float):
        """Seeded corruption draw for the update satellite ``k`` delivers
        at ``t_deliver`` — the same counter-based contract as the drop
        draws: one ``default_rng`` keyed by (seed, stream, sat, ms), so a
        delivery's fate AND damage shape are a pure function of the seed,
        independent of query order or engine.

        Returns ``None`` (intact, the overwhelmingly common case) or a
        ``(mode, factor, noise_seed)`` tuple:

          * ``("sign_flip", -1.0, s)`` — the payload's sign bits flipped;
          * ``("scale", f, s)`` with f ~ LogUniform[8, 128] — an exponent
            upset blows the magnitudes up;
          * ``("noise", f, s)`` with f ~ LogUniform[4, 64] — wide memory
            corruption: noise of f x the tensor's RMS overwrites the row
            (``noise_seed`` seeds the noise tensor draw so the damage
            itself is reproducible).
        """
        prob = self.corrupt_prob_at(k, t_deliver)
        if prob <= 0.0:
            return None
        key = [self.cfg.seed_value, _STREAM_CORRUPT, int(k), 0,
               int(round(float(t_deliver) * 1e3))]
        rng = np.random.default_rng(key)
        if rng.random() >= prob:
            return None
        mode = ("sign_flip", "scale", "noise")[int(rng.integers(3))]
        if mode == "sign_flip":
            factor = -1.0
        elif mode == "scale":
            factor = float(np.exp(rng.uniform(np.log(8.0), np.log(128.0))))
        else:
            factor = float(np.exp(rng.uniform(np.log(4.0), np.log(64.0))))
        return mode, factor, int(rng.integers(2 ** 31))
