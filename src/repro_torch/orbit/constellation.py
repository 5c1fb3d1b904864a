"""Walker-star constellation construction (paper §4.1.1).

Polar circular orbits (inclination 90°, eccentricity 0, altitude 500 km),
RAAN equally spaced over 180° (star pattern), satellites equally phased
within each plane — the Planet-Labs-Doves-inspired setup from the paper.
"""
from __future__ import annotations

import dataclasses

import numpy as np

R_EARTH = 6_371_000.0          # m
MU_EARTH = 3.986004418e14      # m^3/s^2
OMEGA_EARTH = 7.2921159e-5     # rad/s (sidereal rotation)


@dataclasses.dataclass(frozen=True)
class WalkerStar:
    n_clusters: int            # orbital planes
    sats_per_cluster: int
    altitude_m: float = 500_000.0
    inclination_deg: float = 90.0
    phase_offset_frac: float = 0.5   # inter-plane phasing (fraction of slot)

    @property
    def n_sats(self) -> int:
        return self.n_clusters * self.sats_per_cluster

    @property
    def radius_m(self) -> float:
        return R_EARTH + self.altitude_m

    @property
    def period_s(self) -> float:
        return 2 * np.pi * np.sqrt(self.radius_m ** 3 / MU_EARTH)

    def cluster_of(self, k: int) -> int:
        return k // self.sats_per_cluster


def satellite_elements(c: WalkerStar):
    """(raan (K,), phase (K,), cluster (K,)) arrays in radians."""
    raans, phases, clusters = [], [], []
    for p in range(c.n_clusters):
        raan = np.pi * p / c.n_clusters          # star: spread over 180°
        for s in range(c.sats_per_cluster):
            phase = 2 * np.pi * s / c.sats_per_cluster \
                + 2 * np.pi * c.phase_offset_frac * p / c.n_sats
            raans.append(raan)
            phases.append(phase)
            clusters.append(p)
    return (np.asarray(raans), np.asarray(phases),
            np.asarray(clusters, dtype=np.int32))
