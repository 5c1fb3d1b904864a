#!/usr/bin/env python3
"""Phase 10 of chip_smoke.py (LM training) alone, on one GPU.

    python3 tools/chip_train.py [--out FILE]

Runs ``chip_smoke.train_phase`` with TF32 off (``quickstart.
full_precision``): one float32 train step of each smoke config and the
4-layer full-width mamba2-1.3b gradient, card against CPU; the
whole-config mamba2-1.3b hierarchical run of ``repro_torch.launch.train``
(``chip_smoke.TRAIN_ARGV``) with its timings, peak memory and a
torch.profiler breakdown of one step; and the checkpoint round trip.
Builds no kernel: the training path launches none, and the phase checks
that K1-K5 count 0 launches. Prints the card's name and power limit,
each check's line, and writes the phase's record to ``--out`` (default
``chiprun_out/chip_train.json``). Exits non-zero if a check fails or no
CUDA device is present.
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
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_train.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_train: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import quickstart as qs
    from repro_torch.kernels import quant_agg as qa
    from repro_torch.kernels import ssd_scan as K4
    from repro_torch.kernels import swa_attention as K5
    from repro_torch.kernels import trimmed_agg as ta
    counters = ((qa, "launches"), (ta, "launches"), (qa, "single_launches"),
                (K4, "launches"), (K5, "launches"), (K5, "tc_launches"),
                (K4, "tc_launches"))

    def reset_counts():
        for mod, attr in counters:
            setattr(mod, attr, 0)

    def read_counts():
        return tuple(getattr(mod, attr) for mod, attr in counters)
    card = cs.gpu_line()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    qs.full_precision()
    t0 = time.perf_counter()
    out = cs.train_phase(torch, reset_counts, read_counts)
    out.update(device=card, phase_s=time.perf_counter() - t0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"phase 10 in {out['phase_s']:.1f} s -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
