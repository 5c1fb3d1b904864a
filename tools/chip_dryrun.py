#!/usr/bin/env python3
"""Phase 11 or 12 of chip_smoke.py (the dry run) alone, on one GPU.

    python3 tools/chip_dryrun.py [--sharded] [--out FILE]

Runs ``chip_smoke.dryrun_phase`` with TF32 off (``quickstart.
full_precision``): the dry run (``repro_torch.launch.dryrun``) of
whole-config mamba2-1.3b's train step on a one-rank mesh against the same
step on the card (matmul FLOPs, peak memory, seconds beside the
roofline), and a reduced HFL state restored onto a one-rank cuda
DeviceMesh. Builds no kernel: the phase checks that K1-K5
count 0 launches. Prints the card's name and power limit, each check's
line, and writes the phase's record to ``--out`` (default
``chiprun_out/chip_dryrun.json``). Exits non-zero if a check fails or no
CUDA device is present.

``--sharded`` runs phase 12 instead (``chip_smoke.sharded_dryrun_phase``):
the sharded dry runs on this machine's torch over ``cuda`` meshes of fake
ranks, thirteen small-mesh cases and two production ones, each held to
its bars against the JAX package's figures in
``tests/dryrun_reference.json`` (``chiprun_out/chip_dryrun_sharded.json``
by default).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    args.out = args.out or str(ROOT / "chiprun_out" / (
        "chip_dryrun_sharded.json" if args.sharded else "chip_dryrun.json"))
    import torch
    if not torch.cuda.is_available():
        print("chip_dryrun: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import quickstart as qs
    reset_counts, read_counts = cs.launch_counters()
    card = cs.gpu_line()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    qs.full_precision()
    t0 = time.perf_counter()
    out = cs.sharded_dryrun_phase(torch) if args.sharded else \
        cs.dryrun_phase(torch, reset_counts, read_counts)
    out.update(device=card, torch=torch.__version__,
               phase_s=time.perf_counter() - t0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"phase {12 if args.sharded else 11} in {out['phase_s']:.1f} s "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
