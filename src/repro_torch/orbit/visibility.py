"""Visibility: satellite<->ground-station elevation masks, inter-plane LOS,
and boolean-series -> access-window extraction. Geometry in float32 torch on
a chosen device, window bookkeeping vectorized in numpy (one diff pass over
the full (T, K, G) tensor — no per-(sat, station) Python loops).

Port of the JAX package's ``orbit/visibility.py``. The geometry keeps the
reference's float32 steps and its time chunking; the numpy window
extraction is copied as it is.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.orbit.constellation import R_EARTH, WalkerStar
from repro_torch.orbit.propagate import ecef_positions, eci_positions, f32

# elevation_mask_series materialises (chunk, K, G, 3) relative vectors; cap
# the chunk so mega-constellations (K*G in the 10^4 range) stay in memory.
_CHUNK_ELEM_BUDGET = 2 ** 25


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def elevation_mask_series(c: WalkerStar, raan, phase, incl, times, gs,
                          min_elev_deg: float = 10.0, chunk: int = 4096,
                          device="cuda"):
    """Boolean visibility (T, K, G) numpy array: sat k visible from station
    g at time t. The geometry runs on ``device`` (default the card; raises
    if it is absent), one time chunk at a time."""
    device = resolve_device(device)
    gs_t = f32(gs, device)                                 # (G, 3)
    min_sin = torch.sin(f32(min_elev_deg, device) * f32(np.pi / 180, device))
    kg = max(int(c.n_sats) * int(gs_t.shape[0]), 1)
    chunk = max(1, min(chunk, _CHUNK_ELEM_BUDGET // kg))
    up = gs_t / _norm(gs_t)[:, None]

    outs = []
    times = np.asarray(times)
    for i in range(0, len(times), chunk):
        sat = ecef_positions(c, raan, phase, incl, times[i:i + chunk],
                             device)                       # (T, K, 3)
        rel = sat[:, :, None, :] - gs_t[None, None, :, :]  # (T, K, G, 3)
        rng = _norm(rel)
        sin_el = (rel * up).sum(-1) / torch.clamp_min(rng, 1.0)
        outs.append((sin_el >= min_sin).cpu().numpy())
    return np.concatenate(outs, axis=0)


def interplane_los_series(c: WalkerStar, raan, phase, incl, times,
                          sat_a: int, sat_b: int, max_range_m: float = 6e6,
                          chunk: int = 8192, device="cuda"):
    """Boolean LOS (T,) between two satellites: range bound + earth not in
    the way (perpendicular distance of segment to geocenter > R_earth+50km).
    The geometry runs on ``device`` (default the card).
    """
    device = resolve_device(device)
    outs = []
    times = np.asarray(times)
    for i in range(0, len(times), chunk):
        pos = eci_positions(c, raan, phase, incl, times[i:i + chunk],
                            device)                        # (T, K, 3)
        pa, pb = pos[:, sat_a], pos[:, sat_b]              # (T, 3)
        d = pb - pa
        rng = _norm(d)
        # closest point of segment to origin
        tpar = torch.clamp(-(pa * d).sum(-1)
                           / torch.clamp_min(rng * rng, 1.0), 0.0, 1.0)
        closest = pa + tpar[:, None] * d
        clear = _norm(closest) > (R_EARTH + 50_000.0)
        outs.append(((rng <= max_range_m) & clear).cpu().numpy())
    return np.concatenate(outs, axis=0)


def _grid_dt(times: np.ndarray) -> float:
    if len(times) < 2:
        return 0.0
    dt = float(times[1] - times[0])
    if not np.allclose(np.diff(times), dt):
        raise ValueError("uniform time grid required: window ends are "
                         "last-visible-sample + dt")
    return dt


def windows_from_bool(vis: np.ndarray, times: np.ndarray
                      ) -> List[Tuple[float, float]]:
    """(T,) bool -> [(t_start, t_end)] contiguous visibility windows.

    ``times`` must be a uniform grid. A window's end is the last *visible*
    sample plus the grid step, so a window running into the horizon has the
    same duration semantics as one ending mid-series.
    """
    vis = np.asarray(vis, bool)
    if vis.ndim != 1:
        raise ValueError("1-D series expected")
    if not vis.any():
        return []
    times = np.asarray(times, float)
    dt = _grid_dt(times)
    d = np.diff(np.concatenate([[False], vis, [False]]).astype(np.int8))
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]          # exclusive index of last visible
    return [(float(times[s]), float(times[e - 1]) + dt)
            for s, e in zip(starts, ends)]


def windows_from_bool_tensor(vis: np.ndarray, times: np.ndarray):
    """Vectorized window extraction from the full (T, K, G) tensor.

    One diff pass over the whole tensor; returns flat arrays
    ``(sat, gs, t_start, t_end)`` sorted by (sat, t_start, t_end, gs) —
    the same per-satellite ordering the scalar extraction produced.
    ``times`` must be a uniform grid (window ends are last-visible + dt).
    """
    vis = np.asarray(vis, bool)
    if vis.ndim != 3:
        raise ValueError("(T, K, G) tensor expected")
    times = np.asarray(times, float)
    dt = _grid_dt(times)
    # rising edges (first visible sample) and last visible samples, computed
    # along the native time axis — no transpose or int8 conversion copies.
    rise = np.empty_like(vis)
    rise[0] = vis[0]
    np.logical_and(vis[1:], ~vis[:-1], out=rise[1:])
    last = np.empty_like(vis)
    last[-1] = vis[-1]
    np.logical_and(vis[:-1], ~vis[1:], out=last[:-1])
    rt, rk, rg = np.nonzero(rise)
    lt, lk, lg = np.nonzero(last)
    # pair the i-th rise with the i-th last-visible sample of each (k, g)
    # series, then order per satellite by (start, end, gs) — the ordering
    # the scalar extraction produced.
    ro = np.lexsort((rt, rg, rk))
    lo = np.lexsort((lt, lg, lk))
    sat, gsi = rk[ro], rg[ro]
    s = times[rt[ro]]
    e = times[lt[lo]] + dt
    order = np.lexsort((gsi, e, s, sat))
    return sat[order], gsi[order], s[order], e[order]


def access_window_arrays(c: WalkerStar, raan, phase, incl, times, gs,
                         min_elev_deg: float = 10.0, chunk: int = 4096,
                         device="cuda"):
    """Flat (sat, gs, start, end) window arrays for the whole constellation."""
    vis = elevation_mask_series(c, raan, phase, incl, times, gs,
                                min_elev_deg, chunk=chunk, device=device)
    return windows_from_bool_tensor(vis, np.asarray(times))


def access_windows(c: WalkerStar, raan, phase, incl, times, gs,
                   min_elev_deg: float = 10.0, device="cuda"):
    """Per-satellite list of (t_start, t_end, gs_index) windows, sorted."""
    sat, gsi, s, e = access_window_arrays(c, raan, phase, incl, times, gs,
                                          min_elev_deg, device=device)
    # sat is sorted, so the per-satellite lists are contiguous runs of the
    # flat arrays: split on satellite boundaries instead of a zip loop.
    bounds = np.searchsorted(sat, np.arange(1, c.n_sats))
    return [list(zip(sk.tolist(), ek.tolist(), gk.tolist()))
            for sk, ek, gk in zip(np.split(s, bounds), np.split(e, bounds),
                                  np.split(gsi, bounds))]
