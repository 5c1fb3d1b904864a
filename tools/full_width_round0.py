#!/usr/bin/env python3
"""Round 0 of chip_smoke.py's full-width run, card against card and CPU.

    python3 tools/full_width_round0.py [--repeats N] [--out FILE]

The configuration is ``chip_smoke.full_width_config``: AutoFLSat on
4 x 10 satellites, synthetic EuroSAT, the CNN of 1,055,082 parameters,
10-bit QuAFL through kernel K1, with energy, faults (SEU corruption
among them) and a deadline; and the same experiment with the optional
layers off (``constellation_train.sim_config``). First, before anything
else runs in the process, the round's member training alone
(``core.client.local_sgd_clients``: 40 CNNs from one initial model, 10
steps of 32 images) runs ``--repeats`` times on the card with cuDNN's
default algorithms and with deterministic ones, and once on the CPU.
Then each configuration runs its first
round ``--repeats`` times on the card with cuDNN's default algorithms,
``--repeats`` times with ``torch.backends.cudnn.deterministic``, and
once on the CPU. For every card run against the first card run and
against the CPU it prints the accuracy gap in test samples (of 512), the
global parameters' max |difference| and the count of coordinates outside
rtol = atol = 1e-5. Then each configuration runs 1, 2, ... rounds on
the card (up to its round count) and 1 to 3 rounds on the CPU, and it
prints the accuracy, the corrupted updates and whether the global model
is finite after each round. Prints the card's name and power limit and one JSON line, which
also goes to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def run(cfg, device, rounds, torch):
    from repro_torch.sim.flystack import FLySTacK
    from repro_torch.sim.hardware import SMALLSAT_SBAND
    cfg = dataclasses.replace(cfg, fl=dataclasses.replace(
        cfg.fl, max_rounds=rounds))
    sim = FLySTacK(cfg, hw=SMALLSAT_SBAND, device=device)
    res = sim.run()
    params = {k: v.detach().cpu().double()
              for k, v in sim.algo.global_params.items()}
    return res.records, params


def compare(a, b, torch):
    (ra, pa), (rb, pb) = a, b
    outside, worst, total = 0, 0.0, 0
    for k in pa:
        close = torch.isclose(pa[k], pb[k], rtol=1e-5, atol=1e-5,
                              equal_nan=True)
        outside += int((~close).sum())
        total += pa[k].numel()
        d = (pa[k] - pb[k]).abs()
        d = d[torch.isfinite(d)]
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return {"acc_gap": round(512 * abs(ra[0].accuracy - rb[0].accuracy)),
            "max_abs_diff": worst, "outside_1e-5": outside,
            "coords": total}


def train_alone(torch, device, stacked, ds, perms):
    """The full-width round's member training alone: 40 EuroSAT CNNs, 10
    epochs of one 32-image step, on ``device``; trained params on the
    host."""
    from repro_torch.core.client import local_sgd_clients
    out = local_sgd_clients(
        "cnn", {k: v.to(device) for k, v in stacked.items()},
        ds.x.to(device), ds.y.to(device), perms, 10, 32, 0.05)
    return {k: v.detach().cpu().double() for k, v in out.items()}


def diff(pa, pb, torch):
    outside, worst = 0, 0.0
    for k in pa:
        outside += int((~torch.isclose(pa[k], pb[k], rtol=1e-5,
                                       atol=1e-5)).sum())
        worst = max(worst, float((pa[k] - pb[k]).abs().max()))
    return {"max_abs_diff": worst, "outside_1e-5": outside}


def training_section(torch, repeats):
    """Member training alone, before anything else runs in the process:
    each card repeat against the CPU and against the first repeat."""
    import numpy as np
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.models.small import MODELS
    from repro_torch.rng import TorchRandom
    ds = make_federated_dataset("eurosat", 40, 48, device="cpu")
    p0 = MODELS["cnn"][0](TorchRandom(0), (64, 64, 3), 10, device="cpu")
    stacked = {k: v[None].expand((40,) + v.shape).contiguous()
               for k, v in p0.items()}
    rng = np.random.default_rng(0)
    perms = torch.from_numpy(np.stack([[rng.permutation(48)
                                        for _ in range(10)]
                                       for _ in range(40)]))
    cpu = train_alone(torch, "cpu", stacked, ds, perms)
    rows = []
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        first = None
        for i in range(repeats):
            got = train_alone(torch, "cuda", stacked, ds, perms)
            first = first or got
            row = {"cudnn_deterministic": det, "repeat": i,
                   "vs_cpu": diff(got, cpu, torch),
                   "vs_first": diff(got, first, torch)}
            rows.append(row)
            print("training alone", json.dumps(row))
    torch.backends.cudnn.deterministic = True     # full_precision()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "full_width_round0.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("full_width_round0: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import constellation_train, quickstart
    quickstart.full_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    report = {"device": card,
              "training_alone": training_section(torch, args.repeats)}
    configs = {"faulted": chip_smoke.full_width_config(),
               "plain": constellation_train.sim_config()}
    for name, cfg in configs.items():
        cpu = run(cfg, "cpu", 1, torch)
        rows = []
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            first = None
            for i in range(args.repeats):
                got = run(cfg, "cuda", 1, torch)
                first = first or got
                row = {"cudnn_deterministic": det, "repeat": i,
                       "accuracy": got[0][0].accuracy,
                       "vs_cpu": compare(got, cpu, torch),
                       "vs_first": compare(got, first, torch)}
                rows.append(row)
                print(name, json.dumps(row))
        torch.backends.cudnn.deterministic = True  # full_precision()
        # the global model after each of the first rounds: every round
        # count on the card, the first three on the CPU
        after = {}
        for dev, last in (("cuda", cfg.fl.max_rounds), ("cpu", 3)):
            after[dev] = []
            for n in range(1, last + 1):
                recs, params = run(cfg, dev, n, torch)
                fin = [p[torch.isfinite(p)].abs() for p in params.values()]
                after[dev].append({
                    "rounds": len(recs), "accuracy": recs[-1].accuracy,
                    "corrupted": recs[-1].corrupted_updates,
                    "finite": all(bool(torch.isfinite(p).all())
                                  for p in params.values()),
                    "max_abs": max(float(f.max()) if f.numel() else 0.0
                                   for f in fin)})
        print(name, "after each round", json.dumps(after))
        report[name] = {"cpu_accuracy": cpu[0][0].accuracy,
                        "cpu_max_abs": max(float(p.abs().max())
                                           for p in cpu[1].values()),
                        "runs": rows, "after_each_round": after}
    line = json.dumps(report)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
