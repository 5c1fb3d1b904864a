"""Energy-aware constellation FL on the port: eclipse + battery SoC gating.

Satellites run on batteries: solar input stops in Earth's shadow (~38% of
a 500 km polar orbit) while the bus, the ML unit, and the radio keep
drawing. With ``FLConfig.energy`` set, the round engine tracks every
satellite's state of charge and masks satellites below the SoC floor out
of client selection — a zero-weight slot in the padded cohort, so the
trained model changes but the cohort's shape never does.

The counterpart of the JAX package's ``examples/energy_aware.py``, with the
same configuration: the same constellation twice — energy modeling off vs
a power-starved heterogeneous fleet — showing rounds losing participants
to flat batteries, the per-round energy bill, and the satellites used.
The eclipse series, the dataset and the models live on ``--device``.
Run:

    PYTHONPATH=src python -m repro_torch.energy_aware [--device cuda]
"""
from __future__ import annotations

import argparse

from repro_torch.core.contact_plan import build_contact_plan
from repro_torch.core.spaceify import FLConfig
from repro_torch.sim.energy import EnergyConfig, mixed_fleet
from repro_torch.sim.flystack import FLySTacK, SimConfig
from repro_torch.sim.hardware import FLYCUBE, SMALLSAT_SBAND

CLUSTERS, SPC, GS = 2, 3, 2
K = CLUSTERS * SPC

# a mixed FLyCube / S-band fleet (each satellite is timed with its own
# radio and ML unit, and the battery bills the same hardware) with small
# batteries; half the fleet starts nearly drained
FLEET = mixed_fleet((FLYCUBE, SMALLSAT_SBAND), K)
ENERGY = EnergyConfig(
    battery_capacity_wh=10.0,
    initial_soc=tuple(1.0 if k % 2 == 0 else 0.05 for k in range(K)),
    min_soc=0.4,
)


def run(device="cuda"):
    """Both runs on ``device``; returns {label: SimResult}."""
    print("== access windows + eclipse geometry ==")
    plan = build_contact_plan(CLUSTERS, SPC, GS, horizon_s=86_400,
                              dt_s=60.0, device=device)
    results = {}
    for label, ecfg in (("unlimited power", None), ("battery-gated", ENERGY)):
        fl = FLConfig(model="mlp", clients_per_round=4, epochs=2,
                      batch_size=16, max_rounds=4, max_local_epochs=6,
                      energy=ecfg)
        cfg = SimConfig(algorithm="fedavg", n_clusters=CLUSTERS,
                        sats_per_cluster=SPC, n_ground_stations=GS,
                        horizon_days=1.0, dataset="femnist",
                        n_per_client=32, fl=fl, fleet=FLEET)
        res = FLySTacK(cfg, plan=plan, device=device).run()
        results[label] = res
        print(f"\n-- {label} --")
        for r in res.records:
            print(f"round {r.round}: participants={r.participants} "
                  f"skipped_low_power={r.skipped_low_power} "
                  f"energy={r.energy_wh:.3f} Wh")
        s = res.summary()
        print(f"best_acc={s['best_acc']:.3f} total_energy={s['energy_wh']} "
              f"Wh slots_lost_to_power={s['skipped_low_power']}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run(args.device)
    gated = results["battery-gated"]
    if gated.total_skipped_low_power() == 0:
        raise SystemExit("expected at least one satellite masked by the "
                         "battery floor")
    full = {k for r in results["unlimited power"].records
            for k in r.participants}
    lean = {k for r in gated.records for k in r.participants}
    print(f"\nsatellites used: {sorted(full)} (unlimited) vs {sorted(lean)} "
          f"(gated) — drained satellites sit out until solar recharge "
          f"clears the {ENERGY.min_soc:.0%} SoC floor")


if __name__ == "__main__":
    main()
