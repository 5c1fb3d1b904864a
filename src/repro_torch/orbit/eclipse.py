"""Earth-shadow (eclipse) geometry for the constellation power budget.

Cylindrical umbra model, the standard LEO power-budget approximation: the
Sun is taken at infinity, so Earth casts a cylinder of radius ``R_EARTH``
along the anti-sun direction. A satellite is eclipsed iff it is on the
anti-sun side of the geocenter AND inside that cylinder:

    proj = r . s_hat < 0           (behind Earth w.r.t. the Sun)
    |r - proj * s_hat| < R_EARTH   (inside the shadow cylinder)

The Sun direction uses a circular ecliptic: mean longitude advancing at
2*pi / year from the +x equinox direction, tilted by the 23.44 deg
obliquity. Penumbra and solar-radius effects (~30 s transition at 500 km)
are below the access-window grid resolution and are ignored.

Port of the JAX package's ``orbit/eclipse.py``. The geometry runs in
float32 torch on a chosen device, one time chunk at a time, with the
reference's operations in the reference's order (as the visibility series
do), so the boolean series and its packed transitions come out as there;
the packing is numpy on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.orbit.constellation import (R_EARTH, WalkerStar,
                                             satellite_elements)
from repro_torch.orbit.propagate import eci_positions, f32
from repro_torch.orbit.visibility import transitions_from_bool_matrix

OBLIQUITY_RAD = np.radians(23.44)
YEAR_S = 365.25 * 86_400.0

# eclipse_series materialises (chunk, K, 3) position blocks; cap the chunk
# so mega-constellations stay in memory (same convention as visibility).
_CHUNK_ELEM_BUDGET = 2 ** 25


def sun_direction_eci(times, device="cuda") -> torch.Tensor:
    """Unit Sun direction (T, 3) in ECI at ``times`` seconds past epoch,
    float32 on ``device`` (default the card).

    Epoch t=0 is the vernal equinox (+x axis); the direction advances
    through a circular ecliptic inclined by the obliquity.
    """
    device = resolve_device(device)
    lam = f32(2.0 * np.pi, device) * f32(times, device) / f32(YEAR_S, device)
    obl = f32(OBLIQUITY_RAD, device)
    ce, se = torch.cos(obl), torch.sin(obl)
    return torch.stack([torch.cos(lam), torch.sin(lam) * ce,
                        torch.sin(lam) * se], dim=-1)


@dataclasses.dataclass(frozen=True)
class PackedEclipse:
    """Packed (event) representation of an eclipse series.

    Instead of the dense (T, K) boolean tensor only the *state
    transitions* are kept: per-satellite transition times in one flat
    CSR-offset array (the ``contact_plan.py`` layout), plus the initial
    state. A LEO satellite crosses the terminator ~2x per orbit, so this
    is O(K*W) with W ~ 2 * horizon / period.

    The cell-hold convention matches the dense series: a transition at
    time ``tau`` means the state changes at ``tau`` and holds until the
    next transition; after the last transition the final state is held.
    """
    t0: float                    # grid start (state before any transition)
    init_eclipsed: np.ndarray    # (K,) bool — eclipsed at t0
    trans_t: np.ndarray          # (N,) float64 transition times, CSR by sat
    offsets: np.ndarray          # (K+1,) int64 CSR offsets into trans_t

    @property
    def n_sats(self) -> int:
        return len(self.offsets) - 1

    @property
    def nbytes(self) -> int:
        """Resident bytes of the packed representation."""
        return (self.trans_t.nbytes + self.offsets.nbytes
                + self.init_eclipsed.nbytes)

    def to_dense(self, times: np.ndarray) -> np.ndarray:
        """Reconstruct the dense (T, K) boolean series (tests/debugging)."""
        times = np.asarray(times, np.float64)
        out = np.empty((len(times), self.n_sats), bool)
        for k in range(self.n_sats):
            row = self.trans_t[self.offsets[k]:self.offsets[k + 1]]
            flips = np.searchsorted(row, times, side="right")
            out[:, k] = self.init_eclipsed[k] ^ (flips % 2).astype(bool)
        return out


def _eclipsed_block(c: WalkerStar, raan, phase, incl, ts, device):
    """(T, K) bool numpy: the umbra test for one time chunk."""
    pos = eci_positions(c, raan, phase, incl, ts, device)  # (T, K, 3)
    s = sun_direction_eci(ts, device)                      # (T, 3)
    proj = (pos * s[:, None, :]).sum(-1)                   # (T, K)
    perp = pos - proj[..., None] * s[:, None, :]
    dist = torch.sqrt((perp * perp).sum(-1))
    return ((proj < 0.0) & (dist < f32(R_EARTH, device))).cpu().numpy()


def eclipse_series(c: WalkerStar, raan, phase, incl, times,
                   chunk: int = 8192, packed: bool = False, device="cuda"):
    """Boolean eclipse series (T, K): sat k inside Earth's umbra at time t.
    The geometry runs on ``device`` (default the card; raises if it is
    absent).

    With ``packed=True`` the dense tensor is never materialized beyond one
    chunk: each (chunk, K) block is diffed against the previous block's
    last row and only the transitions are kept, returning a
    ``PackedEclipse`` (O(K*W) memory instead of O(T*K)).
    """
    device = resolve_device(device)
    k = max(int(c.n_sats), 1)
    chunk = max(1, min(chunk, _CHUNK_ELEM_BUDGET // k))
    times = np.asarray(times)
    blocks = (_eclipsed_block(c, raan, phase, incl, times[i:i + chunk],
                              device)
              for i in range(0, len(times), chunk))
    if not packed:
        return np.concatenate(list(blocks), axis=0)

    init = None
    carry = None
    sats, ts_ = [], []
    for i, blk in zip(range(0, len(times), chunk), blocks):
        if init is None:
            init = blk[0].copy()
        ki, ti = transitions_from_bool_matrix(blk, times[i:i + chunk],
                                              prev=carry)
        sats.append(ki)
        ts_.append(ti)
        carry = blk[-1]
    sat = np.concatenate(sats) if sats else np.zeros(0, np.int64)
    tt = np.concatenate(ts_) if ts_ else np.zeros(0, np.float64)
    order = np.lexsort((tt, sat))       # chunk blocks interleave: re-sort
    sat, tt = sat[order], tt[order]
    offsets = np.zeros(k + 1, np.int64)
    np.cumsum(np.bincount(sat, minlength=k), out=offsets[1:])
    if init is None:
        init = np.zeros(k, bool)
    return PackedEclipse(t0=float(times[0]) if len(times) else 0.0,
                         init_eclipsed=init, trans_t=tt, offsets=offsets)


def eclipse_fraction(c: WalkerStar, raan, phase, incl, times,
                     chunk: int = 8192, device="cuda") -> np.ndarray:
    """Per-satellite fraction of ``times`` spent in eclipse, shape (K,)."""
    ecl = eclipse_series(c, raan, phase, incl, times, chunk=chunk,
                         device=device)
    return ecl.mean(axis=0)


def mean_eclipse_fraction(c: WalkerStar, n_orbits: float = 3.0,
                          dt_s: float = 30.0, device="cuda") -> float:
    """Fleet-mean eclipse fraction of ``c`` over ``n_orbits`` periods —
    the scalar that discounts orbital-average solar generation in power
    budgets."""
    raan, phase, _ = satellite_elements(c)
    times = np.arange(0.0, n_orbits * c.period_s, dt_s)
    return float(eclipse_fraction(c, raan, phase,
                                  np.radians(c.inclination_deg),
                                  times, device=device).mean())
