"""ContactPlan: precomputed deterministic access windows (the paper's core
observation — satellite orbits are deterministic, so client selection can be
*scheduled* rather than sampled).

Structure-of-arrays engine: per-satellite ground-station windows live in
flat sorted numpy arrays with CSR offsets, queried by bisection
(``np.searchsorted`` on a per-satellite running max of window ends) instead
of a Python linear scan; cluster-pair ISL windows carry cumulative-airtime
prefix sums so multi-pass transfers resolve in two bisections. Batched
queries (``next_contacts`` / ``next_cluster_contacts``) answer the whole
constellation in one vectorized pass — that is the scheduler's hot path.
The original scalar API (``next_contact`` et al.) is retained as thin
wrappers over the same arrays.

Port of the JAX package's ``core/contact_plan.py``: the engine is pure
numpy and copied as it is, so every query answers bitwise as the
reference does. Only ``build_contact_plan`` differs: its visibility
series run in torch on ``device`` (``repro_torch.orbit.visibility``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.orbit.constellation import WalkerStar, satellite_elements
from repro_torch.orbit.groundstations import gs_ecef
from repro_torch.orbit.visibility import (
    access_window_arrays,
    interplane_los_series,
    windows_from_bool,
)


def _segmented_cummax(values: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Running maximum within each CSR segment of ``values``."""
    out = values.copy()
    for a, b in zip(offsets[:-1], offsets[1:]):
        if b > a:
            np.maximum.accumulate(out[a:b], out=out[a:b])
    return out


@dataclasses.dataclass
class ContactPlan:
    constellation: WalkerStar
    horizon_s: float
    sat_windows: List[List[Tuple[float, float, int]]]   # per sat, sorted
    cluster_of: np.ndarray                              # (K,)
    pair_windows: Dict[Tuple[int, int], List[Tuple[float, float]]]
    min_isl_sats: int = 10     # paper: >=10 sats/cluster for Intra-SL @500km
    # flat (sat, gs, start, end) arrays sorted by (sat, start, end, gs);
    # when provided (from_window_arrays) the SoA build skips re-flattening
    # the per-satellite lists.
    flat_windows: Optional[Tuple[np.ndarray, ...]] = \
        dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self._build_sat_arrays()
        self._build_pair_arrays()

    @classmethod
    def from_window_arrays(cls, constellation: WalkerStar, horizon_s: float,
                           sat: np.ndarray, gsi: np.ndarray,
                           starts: np.ndarray, ends: np.ndarray,
                           cluster_of: np.ndarray, pair_windows=None,
                           min_isl_sats: int = 10) -> "ContactPlan":
        """Build a plan from the flat per-window arrays produced by
        ``windows_from_bool_tensor`` (sorted by sat, then start/end/gs)."""
        bounds = np.cumsum(np.bincount(sat, minlength=constellation.n_sats))
        sat_windows = [
            list(zip(map(float, s), map(float, e), map(int, g)))
            for s, e, g in zip(np.split(starts, bounds[:-1]),
                               np.split(ends, bounds[:-1]),
                               np.split(gsi, bounds[:-1]))]
        return cls(constellation=constellation, horizon_s=horizon_s,
                   sat_windows=sat_windows, cluster_of=cluster_of,
                   pair_windows=pair_windows or {},
                   min_isl_sats=min_isl_sats,
                   flat_windows=(np.asarray(sat), np.asarray(gsi),
                                 np.asarray(starts, np.float64),
                                 np.asarray(ends, np.float64)))

    # -- array construction --------------------------------------------
    def _build_sat_arrays(self):
        K = len(self.sat_windows)
        if self.flat_windows is not None:
            sat, gsi, s, e = self.flat_windows
            counts = np.bincount(sat, minlength=K).astype(np.int64)
            starts = np.asarray(s, np.float64)
            ends = np.asarray(e, np.float64)
            gs = np.asarray(gsi, np.int64)
            offsets = np.zeros(K + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            W = len(starts)
        else:
            counts = np.array([len(w) for w in self.sat_windows], np.int64)
            offsets = np.zeros(K + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            W = int(offsets[-1])
            starts = np.empty(W, np.float64)
            ends = np.empty(W, np.float64)
            gs = np.empty(W, np.int64)
            i = 0
            for wins in self.sat_windows:
                for (s, e, g) in wins:
                    starts[i], ends[i], gs[i] = s, e, g
                    i += 1
        self._counts, self._offsets = counts, offsets
        self._starts, self._ends, self._gs = starts, ends, gs
        # first window with end > t in (start, end, gs) order == first index
        # whose running-max-of-ends exceeds t — a monotone key, so bisect.
        self._end_cummax = _segmented_cummax(ends, offsets)
        # padded (K, Wmax) views for whole-constellation batched queries
        Wmax = int(counts.max()) if K else 0
        self._wmax = max(Wmax, 1)
        shape = (K, self._wmax)
        self._end_cummax_pad = np.full(shape, np.inf)
        self._starts_pad = np.zeros(shape)
        self._ends_pad = np.zeros(shape)
        self._gs_pad = np.zeros(shape, np.int64)
        rows = np.repeat(np.arange(K), counts)
        cols = np.arange(W) - np.repeat(offsets[:-1], counts)
        self._end_cummax_pad[rows, cols] = self._end_cummax
        self._starts_pad[rows, cols] = starts
        self._ends_pad[rows, cols] = ends
        self._gs_pad[rows, cols] = gs

    def _build_pair_arrays(self):
        self._pair_arrays = {}
        for key, wins in self.pair_windows.items():
            s = np.array([w[0] for w in wins], np.float64)
            e = np.array([w[1] for w in wins], np.float64)
            cum = np.zeros(len(wins) + 1, np.float64)
            np.cumsum(e - s, out=cum[1:])
            self._pair_arrays[key] = (s, e, cum)

    # -- scalar API (thin wrappers over the arrays) ---------------------
    def next_contact(self, k: int, t: float
                     ) -> Optional[Tuple[float, float, int]]:
        """First window of sat k with any GS whose END is after t (a pass in
        progress still counts; transmission starts at max(t, start))."""
        a, b = self._offsets[k], self._offsets[k + 1]
        i = a + np.searchsorted(self._end_cummax[a:b], t, side="right")
        if i >= b:
            return None
        return (float(max(self._starts[i], t)), float(self._ends[i]),
                int(self._gs[i]))

    def intra_sl_enabled(self) -> bool:
        return self.constellation.sats_per_cluster >= self.min_isl_sats

    def peers(self, k: int) -> Sequence[int]:
        c = int(self.cluster_of[k])
        spc = self.constellation.sats_per_cluster
        return range(c * spc, (c + 1) * spc)

    def next_cluster_contact(self, k: int, t: float):
        """Earliest GS contact among k's cluster peers (Intra-SL relay).
        Returns (t_avail, end, gs, relay_sat). Priority to k itself on ties
        (paper §3.2 consideration 3)."""
        if not self.intra_sl_enabled():
            w = self.next_contact(k, t)
            return None if w is None else (*w, k)
        best = None
        for p in self.peers(k):
            w = self.next_contact(p, t)
            if w is None:
                continue
            key = (w[0], 0 if p == k else 1)
            if best is None or key < (best[0], 0 if best[3] == k else 1):
                best = (*w, p)
        return best

    def next_pair_window(self, ci: int, cj: int, t: float,
                         min_duration: float = 0.0):
        key = (min(ci, cj), max(ci, cj))
        arr = self._pair_arrays.get(key)
        if arr is None or not len(arr[0]):
            return None
        s, e, _ = arr
        avail_start = np.maximum(s, t)
        ok = (e > t) & ((e - avail_start) >= min_duration)
        if not ok.any():
            return None
        i = int(np.argmax(ok))
        return (float(avail_start[i]), float(e[i]))

    def transmit_over_pair(self, ci: int, cj: int, t: float,
                           tx_seconds: float) -> Optional[float]:
        """Completion time of a transmission of ``tx_seconds`` airtime between
        clusters ci and cj starting no earlier than t, resuming across
        successive LOS windows (paper App. C.6: inter-plane windows are short;
        transfers span multiple passes at low data rates)."""
        key = (min(ci, cj), max(ci, cj))
        arr = self._pair_arrays.get(key)
        if arr is None or not len(arr[0]):
            return None
        s, e, cum = arr
        n = len(s)
        # pair windows are disjoint and sorted, so ends are monotone: bisect.
        i0 = int(np.searchsorted(e, t, side="right"))
        if i0 >= n:
            return None
        start0 = max(float(s[i0]), t)
        avail0 = float(e[i0]) - start0
        if avail0 >= tx_seconds:
            return start0 + tx_seconds
        # consume window i0 partially, then bisect the airtime prefix sums
        # for the window where the remaining airtime is exhausted.
        target = float(cum[i0 + 1]) + (tx_seconds - avail0)
        j = int(np.searchsorted(cum, target, side="left")) - 1
        if j >= n:
            return None
        return float(s[j]) + (target - float(cum[j]))

    def chain_pair_transfers(self, t: float, tx_seconds):
        """Chain the C(C-1)/2 pairwise transfers of Algorithm 2's
        InterSLScheduler. ``tx_seconds`` is the per-pass transfer
        duration: one scalar for a uniform fleet, or a ``{(ci, cj):
        seconds}`` mapping when per-satellite ISL rates make pair
        exchanges heterogeneous. Returns (t_complete,
        [(ci, cj, t_start)]) or None if any pair never accumulates enough
        airtime."""
        C = self.constellation.n_clusters
        per_pair = tx_seconds if isinstance(tx_seconds, dict) else None
        t_cur = t
        passes: List[Tuple[int, int, float]] = []
        for ci in range(C):
            for cj in range(ci + 1, C):
                dur = per_pair[(ci, cj)] if per_pair is not None \
                    else tx_seconds
                done = self.transmit_over_pair(ci, cj, t_cur, dur)
                if done is None:
                    return None
                passes.append((ci, cj, t_cur))
                t_cur = done
        return t_cur, passes

    def window_events(self):
        """Every GS window as flat event arrays ``(sat, starts, ends)`` —
        the contact-window open/close sources of the discrete-event
        timeline (``repro_torch.sim.events.WorldTimeline``)."""
        sat = np.repeat(np.arange(len(self._counts)), self._counts)
        return sat, self._starts, self._ends

    # -- batched API (the scheduler's hot path) -------------------------
    def next_contacts(self, t):
        """Vectorized ``next_contact`` over all K satellites.

        ``t`` is a scalar or (K,) per-satellite query time. Returns
        ``(t_avail, end, gs, valid)`` arrays, each (K,); entries where
        ``valid`` is False have no remaining window.
        """
        K = len(self._counts)
        tq = np.broadcast_to(np.asarray(t, np.float64), (K,))
        idx = np.sum(self._end_cummax_pad <= tq[:, None], axis=1)
        valid = idx < self._counts
        i = np.minimum(idx, np.maximum(self._counts - 1, 0))
        rows = np.arange(K)
        avail = np.maximum(self._starts_pad[rows, i], tq)
        return avail, self._ends_pad[rows, i], self._gs_pad[rows, i], valid

    def next_cluster_contacts(self, t):
        """Vectorized ``next_cluster_contact`` over all K satellites: for
        each sat k, the earliest GS contact among k's cluster peers after
        k's query time t[k] (ties prefer k itself, then the lowest peer).

        Returns ``(t_avail, end, gs, relay, valid)`` arrays, each (K,).
        """
        K = len(self._counts)
        if not self.intra_sl_enabled():
            a, e, g, v = self.next_contacts(t)
            return a, e, g, np.arange(K), v
        tq = np.broadcast_to(np.asarray(t, np.float64), (K,))
        spc = self.constellation.sats_per_cluster
        C = K // spc
        # satellites are cluster-contiguous, so reshape to (C, spc, Wmax)
        # views and broadcast querier-times against peer windows — no
        # per-(querier, peer) gather of the window arrays is materialized.
        em3 = self._end_cummax_pad.reshape(C, spc, self._wmax)
        t3 = tq.reshape(C, spc)
        idx = np.sum(em3[:, None, :, :] <= t3[:, :, None, None], axis=3)
        counts3 = self._counts.reshape(C, spc)       # (C, spc_q, spc_p)
        valid = idx < counts3[:, None, :]
        i = np.minimum(idx, np.maximum(counts3 - 1, 0)[:, None, :])
        ci = np.arange(C)[:, None, None]
        pi = np.arange(spc)[None, None, :]
        s3 = self._starts_pad.reshape(C, spc, self._wmax)
        avail = np.maximum(s3[ci, pi, i], t3[:, :, None])
        key = np.where(valid, avail, np.inf)
        best = key.min(axis=2)
        cand = key == best[:, :, None]
        self_cand = cand & (pi == np.arange(spc)[None, :, None])
        col = np.where(self_cand.any(axis=2),
                       np.argmax(self_cand, axis=2),
                       np.argmax(cand, axis=2))          # (C, spc_q)
        cq = (np.arange(C)[:, None], np.arange(spc)[None, :])
        icol = i[cq[0], cq[1], col]
        relay = (np.arange(C)[:, None] * spc + col).reshape(K)
        e3 = self._ends_pad.reshape(C, spc, self._wmax)
        g3 = self._gs_pad.reshape(C, spc, self._wmax)
        return (avail[cq[0], cq[1], col].reshape(K),
                e3[cq[0], col, icol].reshape(K),
                g3[cq[0], col, icol].reshape(K),
                relay, valid.any(axis=2).reshape(K))


def build_contact_plan(n_clusters: int, sats_per_cluster: int,
                       n_ground_stations: int, horizon_s: float,
                       dt_s: float = 30.0, min_elev_deg: float = 10.0,
                       with_isl_pairs: bool = False,
                       device="cuda") -> ContactPlan:
    """Access windows of an ``n_clusters x sats_per_cluster`` Walker star
    against the first ``n_ground_stations`` IGS stations over
    ``[0, horizon_s)`` on a ``dt_s`` grid. The float32 visibility math runs
    on ``device`` (default the card; raises if it is absent); the window
    bookkeeping runs in numpy on the host."""
    device = resolve_device(device)
    c = WalkerStar(n_clusters, sats_per_cluster)
    raan, phase, cluster = satellite_elements(c)
    times = np.arange(0.0, horizon_s, dt_s)
    gs = gs_ecef(n_ground_stations)
    incl = np.radians(c.inclination_deg)
    sat, gsi, s, e = access_window_arrays(c, raan, phase, incl, times, gs,
                                          min_elev_deg, device=device)
    pair_windows = {}
    if with_isl_pairs and n_clusters > 1:
        for ci in range(n_clusters):
            for cj in range(ci + 1, n_clusters):
                a = ci * sats_per_cluster
                b = cj * sats_per_cluster
                los = interplane_los_series(c, raan, phase, incl, times, a, b,
                                            device=device)
                pair_windows[(ci, cj)] = windows_from_bool(los, times)
    return ContactPlan.from_window_arrays(c, horizon_s, sat, gsi, s, e,
                                          cluster_of=cluster,
                                          pair_windows=pair_windows)
