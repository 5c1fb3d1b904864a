"""Circular Keplerian propagation in float32 torch.

ECI frame: orbit plane defined by RAAN Omega and inclination i; true anomaly
nu(t) = phase + n*t with mean motion n = sqrt(mu/a^3) (circular => nu == M).
ECEF obtained by rotating ECI by -omega_earth * t about z.

Port of the JAX package's ``orbit/propagate.py``, which runs in float32
(64-bit mode off). Every step here keeps the reference's types: numpy
inputs become float32 tensors before they meet each other, and a Python
scalar stays a Python float until it multiplies a float32 tensor (so
``MU_EARTH / a**3`` divides in float64 and is then rounded to float32).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.orbit.constellation import MU_EARTH, OMEGA_EARTH, WalkerStar


def f32(x, device) -> torch.Tensor:
    """numpy array / Python scalar -> float32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def eci_positions(c: WalkerStar, raan, phase, incl_rad, times,
                  device="cuda"):
    """Positions (T, K, 3) in meters for satellite element arrays (K,),
    on ``device`` (default the card; raises if it is absent)."""
    device = resolve_device(device)
    a = c.radius_m
    n = torch.sqrt(f32(MU_EARTH / a ** 3, device))
    t = f32(times, device)[:, None]                        # (T, 1)
    nu = f32(phase, device)[None, :] + n * t               # (T, K)
    raan = f32(raan, device)
    incl = f32(incl_rad, device)
    cosO, sinO = torch.cos(raan), torch.sin(raan)          # (K,)
    cosi, sini = torch.cos(incl), torch.sin(incl)
    cosu, sinu = torch.cos(nu), torch.sin(nu)
    # perifocal -> ECI for circular orbit (argument of perigee = 0)
    x = a * (cosO * cosu - sinO * sinu * cosi)
    y = a * (sinO * cosu + cosO * sinu * cosi)
    z = a * (sinu * sini)
    return torch.stack([x, y, z], dim=-1)                  # (T, K, 3)


def ecef_positions(c: WalkerStar, raan, phase, incl_rad, times,
                   device="cuda"):
    """ECI -> ECEF by earth rotation. (T, K, 3) on ``device``."""
    device = resolve_device(device)
    eci = eci_positions(c, raan, phase, incl_rad, times, device)
    th = -OMEGA_EARTH * f32(times, device)
    cos_t, sin_t = torch.cos(th)[:, None], torch.sin(th)[:, None]
    x = eci[..., 0] * cos_t - eci[..., 1] * sin_t
    y = eci[..., 0] * sin_t + eci[..., 1] * cos_t
    return torch.stack([x, y, eci[..., 2]], dim=-1)
