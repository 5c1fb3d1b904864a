#!/usr/bin/env python3
"""The port's dry-run records against the JAX package's, case by case.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --device cpu --out build/dryrun
    PYTHONPATH=src python -m repro.launch.dryrun --arch all --shape all \\
        --mesh both --out build/dryrun_ref
    python3 tools/dryrun_compare.py [--port build/dryrun] \\
        [--ref build/dryrun_ref] [--before DIR]

Reads the two directories of JSON records (one per arch x shape x mesh)
and prints, for every case both ran ok, the port's per-device FLOPs,
peak and link bytes over the reference's: ``op_flops_per_dev`` over
``hlo_flops_per_dev`` (matmuls 2·M·N·K and one FLOP per output element of
a pointwise op, against the HLO's dots and one per fusion output
element), ``mem_peak_bytes_per_dev`` over the compiled program's
arguments + temporaries + outputs not aliased to an argument, and
``collective_link_bytes_per_dev`` over the same key. Then each ratio's
range and median; the over-counts (ratio above 1) apart from the
under-counts (below 1: where XLA repeats work the port shards, such as
attention over heads that ``model`` does not divide); every case above
1.25x in FLOPs or peak or above 4x in link bytes, by name; and the
port's ok / skipped / error count by arch. ``--before`` takes an earlier
port sweep of the same cases and lists, for each metric, the cases whose
ratio moved further from 1 by more than 0.5%. Last, the reference's cases
the port has no record of, and with ``--before`` the port records older
than that sweep's record of the same case (written before the sweep it is
compared with, so not rerun): a partial rerun shows itself instead of
reading as complete. Imports nothing but the standard library.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import pathlib
import statistics

#: a case is listed above these ratios (port over reference)
BARS = {"flops": 1.25, "peak": 1.25, "link": 4.0}


def load(d):
    """{(arch, shape, mesh): record}, each record with its file's
    modification time under ``_mtime``."""
    out = {}
    for f in sorted(pathlib.Path(d).glob("*.json")):
        r = json.loads(f.read_text())
        r["_mtime"] = f.stat().st_mtime
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def not_rerun(port, ref, before=None):
    """(the reference's cases without a port record, the port records
    older than ``before``'s record of the same case, or than its oldest
    record where it has none of that case)."""
    missing = sorted(k for k in ref if k not in port)
    stale = []
    if before:
        start = min(r["_mtime"] for r in before.values())
        stale = sorted(k for k, p in port.items() if p["_mtime"]
                       < before.get(k, {"_mtime": start})["_mtime"])
    return missing, stale


def ref_peak(r):
    return (r["mem_argument_bytes_per_dev"] + r["mem_temp_bytes_per_dev"]
            + r["mem_output_bytes_per_dev"] - r["mem_alias_bytes_per_dev"])


def ratios(p, r):
    return {"flops": p["op_flops_per_dev"] / r["hlo_flops_per_dev"],
            "peak": p["mem_peak_bytes_per_dev"] / ref_peak(r),
            "link": p["collective_link_bytes_per_dev"]
            / max(r["collective_link_bytes_per_dev"], 1.0)}


def compare(port, ref):
    """{case: {metric: port / reference}} over the cases both ran ok."""
    out = {}
    for key, p in sorted(port.items()):
        r = ref.get(key)
        if p["status"] == "ok" and r is not None and r["status"] == "ok":
            out[key] = ratios(p, r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default="build/dryrun")
    ap.add_argument("--ref", default="build/dryrun_ref")
    ap.add_argument("--before", default=None,
                    help="an earlier port sweep of the same cases")
    args = ap.parse_args(argv)
    port, ref = load(args.port), load(args.ref)
    rows = compare(port, ref)
    counts = collections.defaultdict(collections.Counter)
    for key, p in port.items():
        counts[key[0]][p["status"]] += 1
    for key, row in rows.items():
        p = port[key]
        print(f"{' x '.join(key):44s} flops {p['op_flops_per_dev']:.4g} "
              f"(x{row['flops']:.3f})  peak "
              f"{p['mem_peak_bytes_per_dev'] / 2 ** 30:.2f} GiB "
              f"(x{row['peak']:.3f})  link x{row['link']:.3g}")
    for k in BARS:
        v = [row[k] for row in rows.values()]
        if not v:
            continue
        over = sorted(x for x in v if x > 1.0)
        under = sorted(x for x in v if x < 1.0)
        print(f"{k}: port / reference {min(v):.3f} to {max(v):.3f}, median "
              f"{statistics.median(v):.3f}, at most 1.05x in "
              f"{sum(x <= 1.05 for x in v)} of {len(v)}; "
              f"over-counts {len(over)} (up to x{max(over, default=1):.3g}),"
              f" under-counts {len(under)} (down to "
              f"x{min(under, default=1):.3g})")
    for k, bar in BARS.items():
        above = [(key, row[k]) for key, row in rows.items() if row[k] > bar]
        print(f"above {bar}x in {k}: {len(above)}")
        for key, v in sorted(above, key=lambda kv: -kv[1]):
            print(f"  {' x '.join(key)}: x{v:.3f}")
    before = load(args.before) if args.before else None
    if before:
        old = compare(before, ref)
        for k in BARS:
            worse = [(key, old[key][k], row[k]) for key, row in rows.items()
                     if key in old and abs(math.log(row[k]))
                     > abs(math.log(old[key][k])) + math.log(1.005)]
            print(f"{k}: further from 1 than before in {len(worse)} of "
                  f"{sum(key in old for key in rows)}")
            for key, a, b in worse:
                side = "over" if a > 1 else "under"
                print(f"  {' x '.join(key)}: x{a:.4g} -> x{b:.4g} "
                      f"(was an {side}-count)")
    for arch, c in sorted(counts.items()):
        print(f"{arch}: ok {c['ok']}, skipped {c['skipped']}, "
              f"error {c['error']}")
    missing, stale = not_rerun(port, ref, before)
    print(f"reference cases without a port record: {len(missing)}")
    for key in missing:
        print(f"  {' x '.join(key)}")
    if before:
        print(f"port records older than the --before sweep's: {len(stale)}")
        for key in stale:
            print(f"  {' x '.join(key)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
