#!/usr/bin/env python3
"""Kernel K2 (``trimmed_agg``) at byte-bound shapes on one GPU.

    python3 tools/k2_bytebound.py [--parent-cu PATH] [--out FILE]

One leaf of n = 2**24 coordinates (67.1 MB a client row) at K = 10 rows
(8 valid) and K = 32 rows (30 valid); the pad rows hold NaN, as garbage
that must not reach the output; trimmed-mean rank weights (trim 0.2)
over the valid rows. Timed with CUDA events:

  * ``rank_combine_ms``: ``core.aggregation._rank_combine`` on this
    one-leaf cohort, as the trimmed-mean and median aggregators call it;
  * ``kernel_ms``: ``trimmed_agg.trimmed_agg_stacked`` (all K rows read)
    on a copy whose pad rows were set to +inf beforehand;
  * with ``--parent-cu``, the same for an earlier ``trimmed_agg.cu``
    whose C entry point is ``trimmed_agg_stacked(x, rw, out, n, K,
    stream)`` (one leaf a launch), built here with the port's nvcc flags:
    ``parent_rank_combine_ms`` is ``torch.where(valid, x, inf)`` plus its
    launch, ``parent_kernel_ms`` the launch alone. The two run in turns
    (parent, this tree, this tree, parent) and each figure is the mean of
    its two turns.

Every output is held against ``trimmed_agg_stacked_plain`` on
``where(valid, x, inf)`` (rtol 1e-5, atol 1e-6). ``bound_ms`` counts the
bytes the function must move: the valid rows read once and the output
written once, at 3.35 TB/s. Prints the card's name and power limit and
one JSON line, which also goes to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N = 1 << 24
CASES = ((10, 8), (32, 30))        # (K rows, m valid rows)


def build_parent(cu: Path):
    """The earlier source as its own library, loaded with ctypes."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "k2_parent" / "libtrimmed_agg_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.trimmed_agg_stacked.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.trimmed_agg_stacked.restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.aggregation import _rank_combine
    from repro_torch.kernels import trimmed_agg as ta

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-cu", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "k2_bytebound.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_bytebound: no CUDA device", file=sys.stderr)
        return 2
    parent = build_parent(args.parent_cu) if args.parent_cu else None
    card = cs.gpu_line()
    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for k, m in CASES:
        x = torch.randn(k, N, device="cuda", generator=g) * 0.05
        x[m:] = float("nan")
        valid = np.arange(k) < m
        rw_np = cs.rank_weights(torch, k, "trimmed_mean", m).cpu().numpy()
        rw = torch.from_numpy(rw_np).cuda()
        vt = torch.from_numpy(valid).cuda()[:, None]
        xw = torch.where(vt, x, torch.inf)
        want = ta.trimmed_agg_stacked_plain(xw, rw)

        def combine():
            return _rank_combine({"w": x}, valid, rw_np)["w"]

        def kernel():
            return ta.trimmed_agg_stacked(xw, rw)

        impls = {"rank_combine_ms": combine, "kernel_ms": kernel}
        if parent is not None:
            stream = torch.cuda.current_stream().cuda_stream

            def parent_launch(xp):
                out = torch.empty(N, device="cuda")
                err = parent.trimmed_agg_stacked(
                    xp.data_ptr(), rw.data_ptr(), out.data_ptr(), N, k,
                    stream)
                if err:
                    raise RuntimeError(f"parent launch failed: {err}")
                return out

            impls["parent_rank_combine_ms"] = lambda: parent_launch(
                torch.where(vt, x, torch.inf))
            impls["parent_kernel_ms"] = lambda: parent_launch(xw)
        row = {"n": N, "K": k, "m": m}
        for key, fn in impls.items():
            got = fn()
            torch.cuda.synchronize()
            ok, err = cs._close(torch, got, want, 1e-5, 1e-6)
            row[key.replace("_ms", "_max_abs_err")] = err
            if not ok:
                raise AssertionError(f"K={k} {key}: max |got - plain| {err}")
        order = list(impls)
        if parent is not None:
            mine = [o for o in order if not o.startswith("parent")]
            theirs = [o for o in order if o.startswith("parent")]
            order = theirs + mine + mine + theirs
        times = {}
        for key in order:
            times.setdefault(key, []).append(
                cs.time_ms(torch, impls[key], reps=20, trials=5, warmup=3))
        for key, ts in times.items():
            row[key] = sum(ts) / len(ts)
        nbytes = (m + 1) * N * 4 + 4 * k
        row["bytes"] = nbytes
        row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
        rows.append(row)
        print(f"[k2 bytebound] n=2^24 K={k} m={m}: " + ", ".join(
            f"{key} {row[key]:.4f}" for key in times)
            + f"; bound {row['bound_ms']:.4f} ms")
        del x, xw, want, vt
        torch.cuda.empty_cache()
    result = {"card": card, "rows": rows}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
