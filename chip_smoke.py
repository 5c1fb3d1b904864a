#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. device     — a CUDA card is present; its name and power limit;
  2. precision  — TF32 off for matmuls and cuDNN convolutions;
  3. build      — nvcc builds every kernel source of the port (sm_90a);
  4. kernels    — each kernel against its plain PyTorch version on the card,
                  at the main path's shapes and more, with timings;
  5. main path  — the quickstart pipeline (fedavg, fedavg_sch, autoflsat
                  with 10-bit QuAFL) on the card through FLySTacK, kernel
                  launches counted, then the same runs on the CPU: every
                  non-accuracy field of every RoundRecord must be equal;
and then the ``kernels`` JSON line, the card's name and power limit, and
the result line. Details go to ``chiprun_out/chip_smoke.json``.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM float32, no tensor cores
# Accuracy is a count over 512 test samples. Card and CPU train the same
# model on the same data and draws, but convolutions and reductions round
# in another order. In the first rounds that moves only samples whose top
# two logits nearly tie (ACC_TOL_EARLY). Each round then re-quantizes the
# models to 10 bits: a weight whose float value sits within rounding noise
# of a half step snaps to the other level, a change of a whole quantization
# step, and the next rounds train on from there. The gap therefore grows
# with the round (AutoFLSat, which re-quantizes ten members and two
# cluster models a round, more than FedAvg), and later rounds get
# ACC_TOL_LATE. Timing, selection and byte fields stay bitwise.
ACC_TOL_EARLY, EARLY_ROUNDS = 4 / 512, 3
ACC_TOL_LATE = 24 / 512
CNN_LEAF_SIZES = (144, 16, 4608, 32, 200_704, 128, 7936, 62)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps=200, trials=7):
    """Median over ``trials`` of the mean per-call time of ``reps`` calls,
    with CUDA events, after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def captured(torch, fn):
    """``fn``'s launches captured once into a CUDA graph (after a warm-up
    on a side stream, as graph capture requires)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def kernel_phase(torch, qa):
    """K1 against its plain version on the card, on 10-bit codes with
    weight*scale products of the main path's size (|sw * q| <= 1).
    Returns (max |kernel - plain|, timings, per-shape rows)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(n, k, False) for n in CNN_LEAF_SIZES for k in (5, 2)]
    cases += [(n, k, False) for n in (7, 2049, 100_003) for k in (1, 4, 10)]
    cases += [(4608, 5, True), (62, 5, True)]    # pad row with sw = 0
    max_err, rows = 0.0, []
    for n, k, pad in cases:
        acc = torch.randn(n, device="cuda", generator=g)
        q = torch.randint(-511, 512, (k, n), device="cuda", generator=g,
                          dtype=torch.int32)
        sw = torch.rand(k, device="cuda", generator=g) * 2e-3
        if pad:
            sw[-1] = 0.0
            q[-1] = 511
        got = qa.quant_agg_stacked(acc, q, sw)
        want = qa.quant_agg_stacked_plain(acc, q, sw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        rows.append({"n": n, "K": k, "pad_row": pad, "max_abs_err": err,
                     "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"quant_agg_stacked n={n} K={k} pad={pad}: "
                                 f"max |kernel - plain| = {err}")
        max_err = max(max_err, err)
    # timings at the main path's shapes: one FedAvg aggregation is one
    # launch per CNN leaf at K = 5 (AutoFLSat's tier 2: K = 2). "ms" calls
    # the 8 leaves as the main path does; "graph_ms" replays the same 8
    # calls from a CUDA graph, which leaves out the host's launch cost.
    timing = {}
    for k in (5, 2):
        leaves = []
        for n in CNN_LEAF_SIZES:
            acc = torch.randn(n, device="cuda", generator=g)
            q = torch.randint(-511, 512, (k, n), device="cuda", generator=g,
                              dtype=torch.int32)
            sw = torch.rand(k, device="cuda", generator=g) * 2e-3
            leaves.append((acc, q, sw, q.to(torch.float32).t()))
        impls = {
            "ms": lambda: [qa.quant_agg_stacked(a, q, w)
                           for a, q, w, _ in leaves],
            "plain_ms": lambda: [qa.quant_agg_stacked_plain(a, q, w)
                                 for a, q, w, _ in leaves],
            # the float copy of q is made above, outside the timed window
            "library_ms": lambda: [torch.addmv(a, qf, w)
                                   for a, _, w, qf in leaves],
        }
        tot = {}
        for key, fn in impls.items():
            tot[key] = time_ms(torch, fn)
            tot[key.replace("ms", "graph_ms")] = time_ms(
                torch, captured(torch, fn).replay)
        nbytes = sum((4 * k + 8) * n + 4 * k for n in CNN_LEAF_SIZES)
        flops = sum(2 * k * n for n in CNN_LEAF_SIZES)
        tot["bytes"] = nbytes
        tot["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                              flops / FP32_FLOPS_PER_S) * 1e3
        timing[k] = tot
    return max_err, timing, rows


def records_equal(a, b):
    """Every non-accuracy RoundRecord field equal; accuracy within
    ACC_TOL_EARLY for the first EARLY_ROUNDS rounds, ACC_TOL_LATE after."""
    if len(a) != len(b):
        return False, f"{len(a)} vs {len(b)} rounds"
    for ra, rb in zip(a, b):
        da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
        tol = ACC_TOL_EARLY if ra.round < EARLY_ROUNDS else ACC_TOL_LATE
        for f in da:
            if f == "accuracy":
                if abs(da[f] - db[f]) > tol + 1e-12:
                    return False, (f"round {ra.round} accuracy {da[f]} "
                                   f"vs {db[f]}")
            elif da[f] != db[f]:
                return False, f"round {ra.round} {f}: {da[f]} vs {db[f]}"
    return True, ""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import quickstart as qs
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_agg as qa
    from repro_torch.orbit.constellation import WalkerStar, satellite_elements
    from repro_torch.orbit.groundstations import gs_ecef
    from repro_torch.orbit.visibility import (elevation_mask_series,
                                              interplane_los_series)
    from repro_torch.sim.flystack import FLySTacK
    from repro_torch.sim.hardware import SMALLSAT_SBAND

    t_start = time.perf_counter()
    report = {}
    card = gpu_line()
    print(f"[1 device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    qs.full_precision()
    print("[2 precision] allow_tf32 = False for cuda matmul and cudnn "
          "(cuDNN runs float32 convolutions in TF32 by default, which "
          "breaks parity with the CPU)")

    t0 = time.perf_counter()
    _build.build(["quant_agg"])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.get("quant_agg", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"[3 build] quant_agg.cu -> sm_90a in {build_s:.2f} s; "
          + " | ".join(ptxas))
    report["build_s"] = build_s
    report["ptxas"] = _build.build_log.get("quant_agg", "")

    max_err, timing, rows = kernel_phase(torch, qa)
    report["kernel_rows"] = rows
    report["timing"] = {str(k): v for k, v in timing.items()}
    t5 = timing[5]
    print(f"[4 kernels] quant_agg_stacked vs plain: {len(rows)} shapes "
          f"allclose (rtol=atol=1e-5), max |err| {max_err:.3g}; one "
          f"aggregation (8 leaves, K=5) eager / CUDA graph: kernel "
          f"{t5['ms']:.4f} / {t5['graph_ms']:.4f} ms, plain "
          f"{t5['plain_ms']:.4f} / {t5['plain_graph_ms']:.4f} ms, addmv "
          f"{t5['library_ms']:.4f} / {t5['library_graph_ms']:.4f} ms, bound "
          f"{t5['bound_ms']:.5f} ms")

    # -- main path on the card -------------------------------------------
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    plan = qs.quickstart_plan(dev)
    plan_s = time.perf_counter() - t0
    c = WalkerStar(qs.CLUSTERS, qs.SPC)
    raan, phase, _ = satellite_elements(c)
    times = np.arange(0.0, 2 * 86400, 30.0)
    gs, incl = gs_ecef(qs.GS), np.radians(c.inclination_deg)
    vis = {d: elevation_mask_series(c, raan, phase, incl, times, gs,
                                    device=d) for d in ("cuda", "cpu")}
    los = {d: interplane_los_series(c, raan, phase, incl, times, 0, qs.SPC,
                                    device=d) for d in ("cuda", "cpu")}
    flips = int((vis["cuda"] != vis["cpu"]).sum())
    los_flips = int((los["cuda"] != los["cpu"]).sum())
    plan_cpu = qs.quickstart_plan("cpu")
    same_plan = plan.sat_windows == plan_cpu.sat_windows \
        and plan.pair_windows == plan_cpu.pair_windows
    print(f"[5 plan] built on the card in {plan_s:.2f} s; visibility samples "
          f"differing card vs CPU: {flips} of {vis['cpu'].size} GS, "
          f"{los_flips} of {los['cpu'].size} ISL; windows equal: {same_plan}")
    report["visibility_flips"] = {"gs": flips, "isl": los_flips,
                                  "samples_gs": int(vis["cpu"].size),
                                  "samples_isl": int(los["cpu"].size),
                                  "windows_equal": bool(same_plan)}

    qa.launches = 0
    gpu, per_alg = {}, {}
    t0 = time.perf_counter()
    for alg in qs.ALGORITHMS:
        before = qa.launches
        sim = FLySTacK(qs.quickstart_config(alg),
                       hw=SMALLSAT_SBAND, plan=plan, device=dev)
        t_alg = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        t_alg = time.perf_counter() - t_alg
        n_launch = qa.launches - before
        on_card = all(p.is_cuda for p in sim.algo.global_params.values()) \
            and sim.dataset.x.is_cuda and sim.dataset.y.is_cuda
        n_rounds = len(res.records)
        gpu[alg] = res
        per_alg[alg] = {"rounds": n_rounds, "launches": n_launch,
                        "run_s": t_alg, "summary": res.summary()}
        print(f"[5 {alg}] cuda: {json.dumps(res.summary())}; {n_launch} "
              f"K1 launches in {n_rounds} rounds; run {t_alg:.3f} s")
        if not on_card:
            raise AssertionError(f"{alg}: parameters or data not on cuda")
        if n_rounds < 3 or n_launch != 8 * n_rounds:
            raise AssertionError(f"{alg}: {n_launch} K1 launches over "
                                 f"{n_rounds} rounds, expected 8 per round")
        finite = all(bool(torch.isfinite(p).all())
                     for p in sim.algo.global_params.values())
        if not finite:
            raise AssertionError(f"{alg}: non-finite global parameters")
    main_launches = qa.launches
    report["main_path_s"] = time.perf_counter() - t0

    for alg in qs.ALGORITHMS:
        res = FLySTacK(qs.quickstart_config(alg),
                       hw=SMALLSAT_SBAND, plan=plan, device="cpu").run()
        ok, why = records_equal(gpu[alg].records, res.records)
        gaps = [round(512 * abs(a.accuracy - b.accuracy))
                for a, b in zip(gpu[alg].records, res.records)]
        per_alg[alg]["cpu_equal"] = ok
        per_alg[alg]["acc_gap_samples"] = gaps
        print(f"[5 {alg}] cpu run: records equal {ok}; accuracy gap per "
              f"round in test samples {gaps} (tolerance "
              f"{round(512 * ACC_TOL_EARLY)} for rounds < {EARLY_ROUNDS}, "
              f"{round(512 * ACC_TOL_LATE)} after) {why}")
        if not ok:
            raise AssertionError(f"{alg}: card and CPU records differ: {why}")
    report["algorithms"] = per_alg

    kernels = [{
        "name": "quant_agg_stacked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_agg.cu",
        "replaces": "src/repro/kernels/quant_agg.py:100",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": timing[5]["ms"],
        "kernel_ms": timing[5]["ms"],
        "plain_ms": timing[5]["plain_ms"],
        "bound_ms": timing[5]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": timing[5]["library_ms"],
        "graph_ms": timing[5]["graph_ms"],
        "shape": "one aggregation: 8 CNN leaves (213,630 values), K=5",
    }]
    report["kernels"] = kernels
    report["device"] = card
    report["total_s"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
