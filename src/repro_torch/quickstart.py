"""Quickstart on the port: the paper's pipeline end to end on the card.

1. Build a small Walker-star constellation + IGS ground stations and compute
   real access windows from orbital mechanics.
2. Space-ify FedAvg and train a CNN on non-IID synthetic FEMNIST across the
   constellation (FLySTacK), with 10-bit QuAFL transmission aggregated
   through kernel K1.
3. Run AutoFLSat on the same constellation and compare round durations.

The counterpart of the JAX package's ``examples/quickstart.py``, with the
same configuration. Run:

    PYTHONPATH=src python -m repro_torch.quickstart [--device cuda]
        [--profile out.json]

``--profile`` records the runs with ``torch.profiler`` and writes where the
time went (wall time, device kernel time by kernel) to a JSON file.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.contact_plan import build_contact_plan
from repro_torch.core.spaceify import FLConfig
from repro_torch.sim.flystack import FLySTacK, SimConfig
from repro_torch.sim.hardware import SMALLSAT_SBAND

CLUSTERS, SPC, GS = 2, 5, 3
ALGORITHMS = ("fedavg", "fedavg_sch", "autoflsat")


def full_precision() -> None:
    """Keep float32 math in float32 on the card: cuDNN runs float32
    convolutions in TF32 by default (about three decimal digits), which
    would break parity with the CPU and with the JAX reference. Also pin
    cuDNN to deterministic algorithms: under its default heuristics a
    call may take another algorithm, whose rounding a training run can
    amplify (constellation_train's first EuroSAT round then moves by 10
    test samples of 512; tools/full_width_round0.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def quickstart_config(algorithm: str) -> SimConfig:
    fl = FLConfig(clients_per_round=5, epochs=2, max_rounds=8,
                  lr=0.05, max_local_epochs=10, quant_bits=10)
    return SimConfig(algorithm=algorithm, n_clusters=CLUSTERS,
                     sats_per_cluster=SPC, n_ground_stations=GS,
                     horizon_days=2.0, dataset="femnist", n_per_client=32,
                     fl=fl)


def quickstart_plan(device):
    return build_contact_plan(CLUSTERS, SPC, GS, horizon_s=2 * 86400,
                              dt_s=30.0, with_isl_pairs=True, device=device)


def run(device="cuda"):
    """Build the plan and run the three algorithms; returns
    {algorithm: SimResult}."""
    plan = quickstart_plan(device)
    n_windows = sum(len(w) for w in plan.sat_windows)
    print(f"constellation: {CLUSTERS} clusters x {SPC} sats, {GS} ground "
          f"stations, {n_windows} GS access windows over 2 days")
    results = {}
    for alg in ALGORITHMS:
        res = FLySTacK(quickstart_config(alg), hw=SMALLSAT_SBAND,
                       plan=plan, device=device).run()
        results[alg] = res
        s = res.summary()
        print(f"{alg:12s} rounds={s['rounds']:3d} "
              f"best_acc={s['best_acc']:.3f} "
              f"mean_round={s['mean_round_h']:.2f}h "
              f"idle={s['mean_idle_h']:.2f}h")
    return results


def _profile(device, path):
    """Run the quickstart once to warm up (CUDA context, cuDNN, the K1
    build), then once under ``torch.profiler``; write wall time, device
    kernel time and the kernels by device time to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    run(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run(device)
        if on_card:
            torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels = [{"name": ev.key, "calls": ev.count,
                "device_ms": ev.self_device_time_total / 1e3}
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in kernels)
    out = {"device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "wall_s": wall_s, "device_kernel_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
           "kernel_launches": sum(r["calls"] for r in kernels),
           "kernels": kernels}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"profile: wall {wall_s:.3f} s, device kernels {busy_ms:.3f} ms "
          f"in {out['kernel_launches']} launches -> {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler breakdown to this JSON file")
    args = ap.parse_args(argv)
    full_precision()
    if args.profile:
        _profile(args.device, args.profile)
        return
    results = run(args.device)
    base = results["fedavg_sch"].mean_round_duration_h()
    auto = results["autoflsat"].mean_round_duration_h()
    print(f"\nAutoFLSat round-duration reduction vs FedAvgSch: "
          f"{100 * (1 - auto / base):.1f}%")


if __name__ == "__main__":
    main()
