#!/usr/bin/env python3
"""The port's dry-run records against the JAX package's, case by case.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --device cpu --out build/dryrun
    PYTHONPATH=src python -m repro.launch.dryrun --arch all --shape all \\
        --mesh both --out build/dryrun_ref
    python3 tools/dryrun_compare.py [--port build/dryrun] [--ref build/dryrun_ref]

Reads the two directories of JSON records (one per arch x shape x mesh)
and prints, for every case both ran ok, the port's per-device FLOPs,
peak and link bytes over the reference's: ``op_flops_per_dev`` over
``hlo_flops_per_dev`` (matmuls 2·M·N·K and one FLOP per output element of
a pointwise op, against the HLO's dots and one per fusion output
element), ``mem_peak_bytes_per_dev`` over the compiled program's
arguments + temporaries + outputs not aliased to an argument, and
``collective_link_bytes_per_dev`` over the same key. Ends with each
ratio's range and median, and the port's ok / skipped / error count by
arch. Imports nothing but the standard library.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics


def load(d):
    out = {}
    for f in sorted(pathlib.Path(d).glob("*.json")):
        r = json.loads(f.read_text())
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def ref_peak(r):
    return (r["mem_argument_bytes_per_dev"] + r["mem_temp_bytes_per_dev"]
            + r["mem_output_bytes_per_dev"] - r["mem_alias_bytes_per_dev"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default="build/dryrun")
    ap.add_argument("--ref", default="build/dryrun_ref")
    args = ap.parse_args(argv)
    port, ref = load(args.port), load(args.ref)
    counts = collections.defaultdict(collections.Counter)
    ratios = collections.defaultdict(list)
    for key, p in sorted(port.items()):
        counts[key[0]][p["status"]] += 1
        r = ref.get(key)
        if p["status"] != "ok" or r is None or r["status"] != "ok":
            continue
        row = {"flops": p["op_flops_per_dev"] / r["hlo_flops_per_dev"],
               "peak": p["mem_peak_bytes_per_dev"] / ref_peak(r),
               "link": p["collective_link_bytes_per_dev"]
               / max(r["collective_link_bytes_per_dev"], 1.0)}
        for k, v in row.items():
            ratios[k].append(v)
        print(f"{' x '.join(key):44s} flops {p['op_flops_per_dev']:.4g} "
              f"(x{row['flops']:.3f})  peak "
              f"{p['mem_peak_bytes_per_dev'] / 2 ** 30:.2f} GiB "
              f"(x{row['peak']:.3f})  link x{row['link']:.3g}")
    for k, v in ratios.items():
        print(f"{k}: port / reference {min(v):.3f} to {max(v):.3f}, median "
              f"{statistics.median(v):.3f}, within 1.05x in "
              f"{sum(x <= 1.05 for x in v)} of {len(v)}")
    for arch, c in sorted(counts.items()):
        print(f"{arch}: ok {c['ok']}, skipped {c['skipped']}, "
              f"error {c['error']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
