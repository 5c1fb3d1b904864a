#!/usr/bin/env python3
"""Which production dry runs this machine's torch can trace.

    python3 tools/dryrun_probe.py [--timeout S] [ARCH:SHAPE:MESH ...]

Runs ``repro_torch.launch.dryrun.run_one`` for each case (by default
``mamba2-1.3b:train_4k:single`` and ``mixtral-8x22b:decode_32k:multi``),
each in a process of its own (a process group is per process) with a
time limit, on a ``cuda`` mesh of fake ranks (the shards are meta, so no
card is used), and prints one line a case: ok with the per-device matmul
FLOPs and peak, or the error and the last frames of its traceback. Writes
the records to ``chiprun_out/dryrun_probe.json``. Exits 0 when every case
ran to a record, ok or not (it asks; it does not hold a bar).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("mamba2-1.3b:train_4k:single", "mixtral-8x22b:decode_32k:multi")
ONE = """
import json, sys, torch
from repro_torch.launch import dryrun as D
rec = D.run_one(%(arch)r, %(shape)r, %(mesh)r, device="cuda")
rec["torch"] = torch.__version__
print(json.dumps(rec))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="*", default=list(CASES))
    ap.add_argument("--timeout", type=float, default=900)
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for case in args.cases:
        arch, shape, mesh = case.split(":")
        procs[case] = subprocess.Popen(
            [sys.executable, "-c", ONE % {"arch": arch, "shape": shape,
                                          "mesh": mesh}],
            cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
    out, rc = {}, 0
    for case, proc in procs.items():
        try:
            so, se = proc.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            out[case] = {"status": "timeout", "timeout_s": args.timeout}
            print(f"[probe] {case}: no record in {args.timeout} s")
            rc = 1
            continue
        if proc.returncode != 0 or not so.strip():
            out[case] = {"status": "crash", "stderr": se[-3000:]}
            print(f"[probe] {case}: exit {proc.returncode}: {se[-400:]}")
            rc = 1
            continue
        rec = json.loads(so.strip().splitlines()[-1])
        out[case] = rec
        if rec["status"] == "ok":
            print(f"[probe] {case}: ok on torch {rec['torch']}, "
                  f"{rec['trace_s']} s; matmul FLOPs/dev "
                  f"{rec['op_matmul_flops_per_dev']:.4e}, peak GiB/dev "
                  f"{rec['mem_peak_bytes_per_dev'] / 2 ** 30:.2f}")
        else:
            frames = [ln.strip() for ln in rec.get("traceback", "")
                      .splitlines() if ln.strip().startswith("File")][-3:]
            print(f"[probe] {case}: {rec['status']} on torch "
                  f"{rec['torch']}: {rec.get('error', '')[:300]} "
                  f"(at {' | '.join(frames)})")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "dryrun_probe.json").write_text(
        json.dumps(out, indent=1))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
