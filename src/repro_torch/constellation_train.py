"""Full constellation FL training run on the port, with hardware-constraint
accounting.

Trains the CNN on synthetic EuroSAT across a 4-cluster x 10-satellite
Walker-star constellation with AutoFLSat (the paper's Table 7 setup),
reporting accuracy, round durations, idle time, and the FLyCube
power-model OAP. The counterpart of the JAX package's
``examples/constellation_train.py``, with the same configuration; the
visibility series, the dataset, the models and kernel K1 (one launch a
10-bit round) run on ``--device``. Run:

    PYTHONPATH=src python -m repro_torch.constellation_train
        [--rounds N] [--clusters C] [--dataset eurosat] [--device cuda]
"""
from __future__ import annotations

import argparse

from repro_torch.core.spaceify import FLConfig
from repro_torch.quickstart import full_precision
from repro_torch.sim.flystack import FLySTacK, SimConfig, SimResult
from repro_torch.sim.hardware import (SMALLSAT_SBAND, oap_added_mw,
                                      power_feasible)


def sim_config(rounds: int = 12, clusters: int = 4,
               dataset: str = "eurosat") -> SimConfig:
    """The example's experiment: AutoFLSat, ``clusters`` x 10 satellites,
    3 ground stations, 3 days, 48 samples a client, auto epoch budgets
    (3, capped at 10), 10-bit QuAFL."""
    return SimConfig(
        algorithm="autoflsat", n_clusters=clusters, sats_per_cluster=10,
        n_ground_stations=3, horizon_days=3.0, dataset=dataset,
        n_per_client=48, epochs_mode="auto",
        fl=FLConfig(epochs=3, max_rounds=rounds, lr=0.05,
                    max_local_epochs=10, quant_bits=10))


def power_report(res: SimResult, profile=SMALLSAT_SBAND):
    """(added OAP in mW, feasible) from the recorded rounds' duty cycles
    (paper Table 2)."""
    total = res.records[-1].t_end - res.records[0].t_start
    train_frac = sum(r.train_s for r in res.records) / max(total, 1.0)
    tx_frac = sum(r.comm_s for r in res.records) / max(total, 1.0)
    duty = {"training": max(train_frac - 0.2 * tx_frac, 0.0),
            "training_tx": min(0.2 * tx_frac, 1.0),
            "radio_tx": 0.8 * tx_frac}
    return oap_added_mw(duty), power_feasible(duty, profile)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--dataset", default="eurosat")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = sim_config(args.rounds, args.clusters, args.dataset)
    full_precision()
    print(f"== AutoFLSat on {args.clusters}x10 constellation, "
          f"{args.dataset} ==")
    res = FLySTacK(cfg, hw=SMALLSAT_SBAND, device=args.device).run()
    for r in res.records:
        print(f"round {r.round:3d}  t={r.t_start / 3600:7.2f}h  "
              f"dur={r.duration_s / 60:6.1f}min  "
              f"idle={r.idle_s / 60:6.1f}min  "
              f"e={r.epochs:.0f}  acc={r.accuracy:.3f}")
    print("\nsummary:", res.summary())
    oap, ok = power_report(res)
    print(f"power: added OAP = {oap:.0f} mW (feasible: {ok})")


if __name__ == "__main__":
    main()
