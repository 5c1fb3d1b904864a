"""FLySTacK (paper §4): constellation-design & hardware-aware FL testbed.

Combines deterministic orbital access windows (``repro_torch.orbit``,
standing in for STK) with the space-ified FL suite (``repro_torch.core``)
over synthetic FEMNIST / CIFAR-10 / EuroSAT federated datasets, under
explicit hardware profiles (``repro_torch.sim.hardware``).

Port of the JAX package's ``sim/flystack.py``. ``FLySTacK`` takes
``device=`` (default the card; raises if it is absent): the visibility
series, the dataset, the models and the aggregation kernels (K1, K2)
run there.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.autoflsat import AutoFLSat
from repro_torch.core.contact_plan import ContactPlan, build_contact_plan
from repro_torch.core.spaceify import ALGORITHMS, FLConfig, RoundRecord
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.rng import TorchRandom
from repro_torch.sim.hardware import FLYCUBE, FleetProfile, HardwareProfile


@dataclasses.dataclass
class SimConfig:
    """One FLySTacK experiment = constellation x dataset x algorithm; the
    same fields and defaults as the reference's ``SimConfig``.

    ``algorithm``: key in ``repro_torch.core.spaceify.ALGORITHMS`` or
    "autoflsat".
    ``seed``: dataset seed (``fl.seed`` drives model init and training)."""
    algorithm: str = "fedavg"            # key in ALGORITHMS or "autoflsat"
    n_clusters: int = 2
    sats_per_cluster: int = 5
    n_ground_stations: int = 3
    dataset: str = "femnist"
    model: str = "cnn"
    horizon_days: float = 3.0
    dt_s: float = 30.0
    n_per_client: int = 64
    alpha: float = 0.5                   # dirichlet non-IID skew
    min_elev_deg: float = 10.0           # GS elevation mask
    fl: FLConfig = dataclasses.field(default_factory=FLConfig)
    fleet: Optional[object] = None       # per-sat profiles / FleetProfile
    epochs_mode: str = "fixed"           # autoflsat: "fixed" | "auto"
    policy: Optional[object] = None      # selection policy override
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    config: SimConfig
    records: List[RoundRecord]

    # -- paper metrics ---------------------------------------------------
    def final_accuracy(self) -> float:
        return self.records[-1].accuracy if self.records else 0.0

    def best_accuracy(self) -> float:
        return max((r.accuracy for r in self.records), default=0.0)

    def mean_round_duration_h(self) -> float:
        return float(np.mean([r.duration_s for r in self.records]) / 3600) \
            if self.records else float("nan")

    def mean_idle_h(self) -> float:
        return float(np.mean([r.idle_s for r in self.records]) / 3600) \
            if self.records else float("nan")

    def total_training_time_h(self) -> float:
        return (self.records[-1].t_end - self.records[0].t_start) / 3600 \
            if self.records else float("nan")

    def time_to_accuracy_h(self, target: float) -> Optional[float]:
        for r in self.records:
            if r.accuracy >= target:
                return (r.t_end - self.records[0].t_start) / 3600
        return None

    def total_energy_wh(self) -> float:
        """Fleet-total added FL energy over the run (0 when energy off)."""
        return float(sum(r.energy_wh for r in self.records))

    def total_skipped_low_power(self) -> int:
        """Orbit-eligible satellites masked by the battery floor, summed
        over rounds. A fleet power-health gauge — every masked candidate
        counts, including ones the cohort would not have selected."""
        return int(sum(r.skipped_low_power for r in self.records))

    def total_skipped_faulted(self) -> int:
        """Outage-masked candidates plus wiped/lost updates, summed over
        rounds (0 when faults are off)."""
        return int(sum(r.skipped_faulted for r in self.records))

    def total_dropped_contacts(self) -> int:
        """Transmission attempts lost to per-contact drops, summed over
        rounds (0 when faults are off)."""
        return int(sum(r.dropped_contacts for r in self.records))

    def total_retransmit_bytes(self) -> float:
        """Bytes re-billed by drop-retry transmissions over the run."""
        return float(sum(r.retransmit_bytes for r in self.records))

    def total_corrupted_updates(self) -> int:
        """Delivered updates whose payload was SEU-corrupted or poisoned
        in flight, summed over rounds (0 when payload faults are off)."""
        return int(sum(r.corrupted_updates for r in self.records))

    def total_clipped_updates(self) -> int:
        """Rows the robust aggregator attenuated/rejected, summed over
        rounds (0 under the plain weighted mean)."""
        return int(sum(r.clipped_updates for r in self.records))

    def total_deadline_expired(self) -> int:
        """Rounds whose barrier was closed by the deadline/quorum rule
        before every delivery landed (0 at the wait-for-all default)."""
        return int(sum(r.deadline_expired for r in self.records))

    def total_stragglers_carried(self) -> int:
        """Deliveries that missed their round close and were carried as
        stale FedBuff-style deltas (or discarded), summed over rounds."""
        return int(sum(r.stragglers_carried for r in self.records))

    def total_retries_exhausted(self) -> int:
        """Drop-retry walks abandoned at the attempt budget, summed over
        rounds (0 while every walk delivers within budget)."""
        return int(sum(r.retries_exhausted for r in self.records))

    def total_storm_events(self) -> int:
        """Correlated storm onsets that began during a round, summed
        over rounds (0 with ``storms=None``)."""
        return int(sum(r.storm_events for r in self.records))

    def total_policy_deferred(self) -> int:
        """Otherwise-eligible candidates the selection policy deferred
        or demoted, summed over rounds (0 for the built-in policies)."""
        return int(sum(r.policy_deferred for r in self.records))

    def policy_skip_reasons(self) -> dict:
        """Per-reason policy skip counts merged over rounds, e.g.
        ``{"eclipse_deferred": 7, "storm_exposed": 3}`` ({} for the
        built-in policies, which never defer)."""
        merged: dict = {}
        for r in self.records:
            for reason, n in r.policy_skips.items():
                merged[reason] = merged.get(reason, 0) + int(n)
        return merged

    def summary(self) -> dict:
        return {
            "algorithm": self.config.algorithm,
            "clusters": self.config.n_clusters,
            "sats_per_cluster": self.config.sats_per_cluster,
            "ground_stations": self.config.n_ground_stations,
            "rounds": len(self.records),
            "final_acc": round(self.final_accuracy(), 4),
            "best_acc": round(self.best_accuracy(), 4),
            "mean_round_h": round(self.mean_round_duration_h(), 4),
            "mean_idle_h": round(self.mean_idle_h(), 4),
            "total_h": round(self.total_training_time_h(), 3),
            "energy_wh": round(self.total_energy_wh(), 3),
            "skipped_low_power": self.total_skipped_low_power(),
            "skipped_faulted": self.total_skipped_faulted(),
            "dropped_contacts": self.total_dropped_contacts(),
            "retransmit_bytes": round(self.total_retransmit_bytes(), 1),
            "corrupted_updates": self.total_corrupted_updates(),
            "clipped_updates": self.total_clipped_updates(),
            "deadline_expired": self.total_deadline_expired(),
            "stragglers_carried": self.total_stragglers_carried(),
            "retries_exhausted": self.total_retries_exhausted(),
            "storm_events": self.total_storm_events(),
            "policy_deferred": self.total_policy_deferred(),
            "policy_skips": self.policy_skip_reasons(),
        }


class FLySTacK:
    """One experiment on ``device``. ``random_source`` (a factory
    ``seed -> source``, ``repro_torch.rng``) supplies every draw: the
    dataset's from ``cfg.seed``, the engine's from ``cfg.fl.seed``.
    After :meth:`run`, ``self.algo`` is the engine that ran."""

    def __init__(self, cfg: SimConfig, hw: HardwareProfile = FLYCUBE,
                 plan: Optional[ContactPlan] = None, device="cuda",
                 random_source=TorchRandom):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.random_source = random_source
        K = cfg.n_clusters * cfg.sats_per_cluster
        # SimConfig.fleet (heterogeneous per-satellite hardware) wins over
        # the uniform hw profile; the algorithms accept either form.
        self.hw = FleetProfile.build(cfg.fleet, K) \
            if cfg.fleet is not None else hw
        needs_isl = cfg.algorithm == "autoflsat"
        self.plan = plan if plan is not None else build_contact_plan(
            cfg.n_clusters, cfg.sats_per_cluster, cfg.n_ground_stations,
            horizon_s=cfg.horizon_days * 86_400, dt_s=cfg.dt_s,
            min_elev_deg=cfg.min_elev_deg, with_isl_pairs=needs_isl,
            device=self.device)
        self.dataset = make_federated_dataset(
            cfg.dataset, n_clients=K, n_per_client=cfg.n_per_client,
            alpha=cfg.alpha, seed=cfg.seed, device=self.device,
            random_source=random_source)
        self.algo = None

    def run(self) -> SimResult:
        cfg = self.cfg
        fl = cfg.fl
        if fl.faults is not None and fl.faults.seed is None:
            # inherit the experiment seed into the fault stream (a numpy
            # stream independent of fl.seed's training draws)
            fl = dataclasses.replace(
                fl, faults=dataclasses.replace(fl.faults, seed=cfg.seed))
        if cfg.policy is not None:
            # experiment-level selection-policy override
            fl = dataclasses.replace(fl, policy=cfg.policy)
        if cfg.algorithm == "autoflsat":
            algo = AutoFLSat(self.plan, self.hw, self.dataset, fl,
                             epochs_mode=cfg.epochs_mode,
                             random_source=self.random_source)
        else:
            cls, overrides = ALGORITHMS[cfg.algorithm]
            fl = dataclasses.replace(fl, **overrides)
            algo = cls(self.plan, self.hw, self.dataset, fl,
                       random_source=self.random_source)
        self.algo = algo
        records = algo.run()
        return SimResult(config=cfg, records=records)
