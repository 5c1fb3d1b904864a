"""Hardware constraints (paper §4.1.2 + Appendix C / Table 2).

Port of the JAX package's ``sim/hardware.py`` (pure numpy, copied), so
link and compute times are bitwise those of the reference.

Power: duty-cycle model over the four FLyCube power modes; orbital average
power (OAP) added by FL = sum(duty_i * P_i) (``oap_added_mw``), checked
against the eclipse-derated solar input by ``power_feasible``.

Data rate: transmission time = bytes / rate; the FLyCube profile is the
measured 1.6 KB/s LoRa CubeSat-to-CubeSat rate with 12.5 W supply.

Heterogeneous fleets: a :class:`FleetProfile` vectorizes a
``Sequence[HardwareProfile]`` into per-satellite ``(K,)`` arrays of epoch
times, link rates and power figures. It is the round engine's timing
source (``repro_torch.core.spaceify``) *and* the default fleet the battery
simulation bills (``repro_torch.sim.energy``), so timing and power always
describe the same constellation — the shared-fleet invariant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerModes:
    """Whole-satellite draw per operating mode, in mW (paper Table 2;
    FLyCube = PyCubed flight computer + RPi Zero 2W ML unit).

    ``idle`` is the bus keep-alive draw; ``radio_tx`` keys the radio with
    the ML unit idle; ``training`` runs local SGD with the radio silent;
    ``training_tx`` does both at once. The battery integrator
    (``repro_torch.sim.energy``) bills idle continuously and the
    *difference* ``mode - idle`` for FL activity, so nothing is
    double-counted."""
    idle: float = 760.0
    radio_tx: float = 1613.0
    training: float = 2178.0
    training_tx: float = 3138.0


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """One satellite class: compute speed, link rates, and power.

    ``epoch_time_s``: wall-clock seconds for one local epoch on the ML
    unit — the scheduler's unit of on-board compute.
    ``downlink_rate_bps`` / ``uplink_rate_bps`` / ``isl_rate_bps``: link
    data rates (sat->ground, ground->sat, sat<->sat); transmission time is
    ``bytes * 8 / rate`` via :meth:`tx_time`, and the bytes are the
    *quantized* wire size when ``FLConfig.quant_bits > 0``.
    ``power``: the :class:`PowerModes` draw table.
    ``power_generation_mw``: solar input while sunlit. The seed model
    treated this as an orbital average; with ``FLConfig.energy`` set, the
    battery integrator applies it only outside eclipse, so it should be
    the panel's *sunlit* output.
    """
    name: str
    epoch_time_s: float            # one local epoch on the ML unit
    downlink_rate_bps: float       # sat -> ground
    uplink_rate_bps: float         # ground -> sat
    isl_rate_bps: float            # sat <-> sat
    power: PowerModes = PowerModes()
    power_generation_mw: float = 4000.0   # solar panel output while sunlit

    def tx_time(self, n_bytes: float, link: str = "downlink") -> float:
        """Seconds to move ``n_bytes`` over ``link`` ("downlink" |
        "uplink" | "isl")."""
        rate = {"downlink": self.downlink_rate_bps,
                "uplink": self.uplink_rate_bps,
                "isl": self.isl_rate_bps}[link]
        return n_bytes * 8.0 / rate

    def train_time(self, epochs: float) -> float:
        """Seconds of on-board compute for ``epochs`` local epochs."""
        return epochs * self.epoch_time_s


@dataclasses.dataclass(frozen=True, eq=False)
class FleetProfile:
    """A constellation's hardware as per-satellite ``(K,)`` arrays.

    Built from one :class:`HardwareProfile` per satellite
    (:meth:`from_profiles` / :meth:`uniform`); the round engine reads the
    arrays directly so a mixed FLyCube / S-band fleet gets per-satellite
    link and compute times, while a uniform fleet stays bitwise-identical
    to the scalar primary-profile arithmetic (``n_bytes * 8.0 / rate`` and
    ``epochs * epoch_time_s`` are evaluated elementwise with the exact
    same IEEE operations).

    ``profiles`` is retained so the energy simulation can bill the very
    same fleet (``EnergySim`` builds its power arrays from it) — the
    timing/energy shared-fleet invariant. ``primary`` (``profiles[0]``)
    is the compatibility scalar profile exposed as ``SpaceifiedFL.hw``.
    """
    profiles: tuple
    epoch_time_s: np.ndarray       # (K,) seconds per local epoch
    downlink_rate_bps: np.ndarray  # (K,) sat -> ground
    uplink_rate_bps: np.ndarray    # (K,) ground -> sat
    isl_rate_bps: np.ndarray       # (K,) sat <-> sat
    power_generation_mw: np.ndarray  # (K,) sunlit solar output

    @classmethod
    def from_profiles(cls, profiles: Sequence[HardwareProfile]
                      ) -> "FleetProfile":
        profiles = tuple(profiles)
        if not profiles:
            raise ValueError("FleetProfile needs at least one profile")
        arr = lambda f: np.array([f(p) for p in profiles], np.float64)
        return cls(profiles=profiles,
                   epoch_time_s=arr(lambda p: p.epoch_time_s),
                   downlink_rate_bps=arr(lambda p: p.downlink_rate_bps),
                   uplink_rate_bps=arr(lambda p: p.uplink_rate_bps),
                   isl_rate_bps=arr(lambda p: p.isl_rate_bps),
                   power_generation_mw=arr(
                       lambda p: p.power_generation_mw))

    @classmethod
    def uniform(cls, profile: HardwareProfile, n_sats: int
                ) -> "FleetProfile":
        return cls.from_profiles((profile,) * n_sats)

    @classmethod
    def build(cls, hw: Union["FleetProfile", HardwareProfile,
                             Sequence[HardwareProfile]],
              n_sats: int) -> "FleetProfile":
        """Normalize any accepted fleet spec to a validated FleetProfile:
        a FleetProfile (checked against ``n_sats``), one HardwareProfile
        (replicated), or a length-``n_sats`` profile sequence."""
        if isinstance(hw, FleetProfile):
            fleet = hw
        elif isinstance(hw, HardwareProfile):
            fleet = cls.uniform(hw, n_sats)
        else:
            fleet = cls.from_profiles(hw)
        if fleet.n_sats != n_sats:
            raise ValueError(f"fleet has {fleet.n_sats} profiles for "
                             f"{n_sats} satellites")
        return fleet

    @property
    def n_sats(self) -> int:
        return len(self.profiles)

    @property
    def primary(self) -> HardwareProfile:
        return self.profiles[0]

    @property
    def is_uniform(self) -> bool:
        return all(p == self.profiles[0] for p in self.profiles[1:])

    def tx_time(self, n_bytes: float, link: str = "downlink") -> np.ndarray:
        """(K,) seconds to move ``n_bytes`` over ``link`` per satellite."""
        rate = {"downlink": self.downlink_rate_bps,
                "uplink": self.uplink_rate_bps,
                "isl": self.isl_rate_bps}[link]
        return n_bytes * 8.0 / rate

    def train_time(self, epochs) -> np.ndarray:
        """(K,) seconds of on-board compute; ``epochs`` scalar or (K,)."""
        return np.asarray(epochs, np.float64) * self.epoch_time_s


# The built & measured FLyCube prototype (App. C.4): 1.6 KB/s radio,
# ~20 s/epoch-class training on the RPi Zero 2W for small CNNs.
FLYCUBE = HardwareProfile(
    name="flycube",
    epoch_time_s=20.0,
    downlink_rate_bps=1.6e3 * 8,
    uplink_rate_bps=1.6e3 * 8,
    isl_rate_bps=1.6e3 * 8,
)

# An earth-observation smallsat with an S-band radio (MB/s class).
SMALLSAT_SBAND = HardwareProfile(
    name="smallsat_sband",
    epoch_time_s=5.0,
    downlink_rate_bps=1e6 * 8,
    uplink_rate_bps=0.5e6 * 8,
    isl_rate_bps=20e3 * 8,        # paper Fig 9: 20 KB/s min for inter-plane
)


def oap_added_mw(duty: Dict[str, float], power: PowerModes = PowerModes()
                 ) -> float:
    """Added orbital-average power of FL tasks given duty cycles.

    Matches Table 2's convention: OAP_added = sum_i duty_i * P_mode_i
    (the paper bills the full mode draw to the FL workload — e.g.
    0.8*2178 + 0.2*3138 ~= 2370 mW for the 5-FLyCube constellation)."""
    modes = {"idle": power.idle, "radio_tx": power.radio_tx,
             "training": power.training, "training_tx": power.training_tx}
    return sum(d * modes[m] for m, d in duty.items())


def analytic_eclipse_fraction(orbit_radius_m: Optional[float] = None
                              ) -> float:
    """Cylindrical-umbra eclipse fraction ``asin(R_E / a) / pi`` of a
    circular orbit whose plane contains the sun — the worst-case (and,
    for the paper's polar constellations, typical) shadow arc. Defaults
    to the 500 km WalkerStar altitude (~0.378)."""
    from repro_torch.orbit.constellation import R_EARTH, WalkerStar
    a = WalkerStar(1, 1).radius_m if orbit_radius_m is None \
        else float(orbit_radius_m)
    return float(np.arcsin(R_EARTH / a) / np.pi)


def power_feasible(duty: Dict[str, float], profile: HardwareProfile,
                   eclipse_fraction: Optional[float] = None) -> bool:
    """Static feasibility: idle + added-FL draw must fit the *average*
    solar input. ``power_generation_mw`` is the panel's sunlit output
    (the battery integrator applies it only outside eclipse), so the
    average input is derated by the orbit's eclipse fraction — by default
    the analytic ``asin(R_E/a)/pi`` arc of the 500 km constellation.
    Pass ``eclipse_fraction=0.0`` to read ``power_generation_mw`` as an
    orbital average instead (the seed convention, optimistic by exactly
    the eclipse fraction)."""
    if eclipse_fraction is None:
        eclipse_fraction = analytic_eclipse_fraction()
    total = profile.power.idle + oap_added_mw(duty, profile.power)
    return total <= profile.power_generation_mw * (1.0 - eclipse_fraction)
