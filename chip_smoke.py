#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. device     — a CUDA card is present; its name and power limit;
  2. precision  — TF32 off for matmuls and cuDNN convolutions;
  3. build      — nvcc builds every kernel source of the port (sm_90a),
                  all at once, with each source's registers and spills;
  4. kernels    — each kernel (K1 quant_agg_stacked, K2
                  trimmed_agg_stacked, K3 quant_agg) against its plain
                  PyTorch version on the card, at the main path's shapes
                  and more, with timings beside the plain version, one
                  PyTorch library call and the bound;
  5. main path  — the quickstart pipeline (fedavg, fedavg_sch, autoflsat
                  with 10-bit QuAFL) on the card through FLySTacK, kernel
                  launches counted, then the same runs on the CPU: every
                  non-accuracy field of every RoundRecord must be equal;
  6. engines    — FedProxSch, FedProxSchV2, FedBuff, FedAvg with the
                  trimmed mean and FedBuff with the median, the same way:
                  K1 runs every FedProx round, K2 every robust round (and
                  K1 none), plain FedBuff neither;
  7. in-place   — the streamed in-place aggregation of one 10-bit cohort
                  through K3 against K1's cohort aggregation;
and then the ``kernels`` JSON line, the card's name and power limit, and
the result line. Each path runs with every launch count set to 0 just
before it and read just after. Details go to
``chiprun_out/chip_smoke.json``.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import json
import re
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


def kernel_name(mangled: str) -> str:
    """The function name of an Itanium-mangled ``_ZN...`` kernel symbol
    (the last length-prefixed component), with its one template argument
    as ``<n>``."""
    i, name = mangled.find("_ZN") + 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    m = re.match(r"IL[bi](\d+)E", mangled[i:])
    return name + (f"<{m.group(1)}>" if m else "")


def ptxas_summary(log: str) -> str:
    """One "kernel: registers, spilled bytes" entry per function compiled
    in an ``nvcc -Xptxas -v`` log."""
    out, name, spill = [], "?", "0"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
    return "; ".join(out)


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


def k1_phase(torch, qa):
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


def _close(torch, got, want, rtol, atol):
    """(allclose with NaN == NaN and equal infinities, max |got - want|
    where both are finite)."""
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol,
                             equal_nan=True))
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    return ok, err


def rank_weights(torch, k, kind, m):
    """(K,) rank weights of the trimmed mean (trim 0.2) or the median over
    the m valid rows, as ``core/aggregation.py`` forms them."""
    import numpy as np
    rw = np.zeros(k, np.float32)
    if kind == "median":
        rw[(m - 1) // 2] += 0.5
        rw[m // 2] += 0.5
    else:
        lo = min(int(0.2 * m), max((m - 1) // 2, 0))
        rw[lo:m - lo] = 1.0 / (m - 2 * lo)
    return torch.from_numpy(rw).cuda()


def timed_set(torch, impls):
    """Eager and CUDA-graph time of each of ``impls`` {key: fn}: "key" and
    "key" with "ms" -> "graph_ms"."""
    tot = {}
    for key, fn in impls.items():
        tot[key] = time_ms(torch, fn)
        tot[key.replace("ms", "graph_ms")] = time_ms(
            torch, captured(torch, fn).replay)
    return tot


def k2_phase(torch, ta):
    """K2 against its plain version on the card: every CNN leaf at K = 5
    and 10, n = 7 / 2049 / 100,003 at K = 1, 2, 4, 33, 100; trimmed-mean
    and median rank weights; for K > 2 the last two rows are +inf pads at
    zero-weight ranks; one NaN coordinate everywhere and one whole NaN
    row. Then one robust aggregation (8 leaves, K = 5) timed."""
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = [(n, k, kind, False) for n in CNN_LEAF_SIZES for k in (5, 10)
             for kind in ("trimmed_mean", "median")]
    cases += [(n, k, kind, False) for n in (7, 2049, 100_003)
              for k in (1, 2, 4, 33, 100)
              for kind in ("trimmed_mean", "median")]
    cases += [(2049, 5, "median", True), (4608, 10, "trimmed_mean", True)]
    max_err, rows = 0.0, []
    for n, k, kind, nan_row in cases:
        x = torch.randn(k, n, device="cuda", generator=g) * 0.05
        m = k - 2 if k > 2 else k
        x[m:] = float("inf")
        x[0, n // 2] = float("nan")
        if nan_row:
            x[1] = float("nan")
        rw = rank_weights(torch, k, kind, m)
        got = ta.trimmed_agg_stacked(x, rw)
        want = ta.trimmed_agg_stacked_plain(x, rw)
        torch.cuda.synchronize()
        ok, err = _close(torch, got, want, 1e-5, 1e-6)
        rows.append({"n": n, "K": k, "rank_weights": kind,
                     "nan_row": nan_row, "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"trimmed_agg_stacked n={n} K={k} {kind} "
                                 f"nan_row={nan_row}: max |kernel - plain| "
                                 f"= {err}")
        max_err = max(max_err, err)
    # one robust aggregation of the main path: 8 leaves, K = 5 valid rows,
    # trimmed-mean rank weights (ranks 1..3 at 1/3)
    k = 5
    rw = rank_weights(torch, k, "trimmed_mean", k)
    leaves = [torch.randn(k, n, device="cuda", generator=g) * 0.05
              for n in CNN_LEAF_SIZES]
    timing = timed_set(torch, {
        "ms": lambda: [ta.trimmed_agg_stacked(x, rw) for x in leaves],
        "plain_ms": lambda: [ta.trimmed_agg_stacked_plain(x, rw)
                             for x in leaves],
        # two library calls per leaf: a sort over the clients, then the
        # contraction with the rank weights
        "library_ms": lambda: [rw @ torch.sort(x, 0).values
                               for x in leaves],
    })
    nbytes = sum((4 * k + 4) * n + 4 * k for n in CNN_LEAF_SIZES)
    # a sorting network of K(K-1)/2 compares plus K multiply-adds per value
    ops = sum((k * (k - 1) // 2 + 2 * k) * n for n in CNN_LEAF_SIZES)
    timing["bytes"] = nbytes
    timing["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                             ops / FP32_FLOPS_PER_S) * 1e3
    return max_err, timing, rows


def k3_phase(torch, qa):
    """K3 against its plain version on the card at every CNN leaf size and
    n = 7 / 2049 / 100,003, with the scale a 0-d CUDA tensor (as the
    quantizer gives it) or a Python float. Then one in-place aggregation
    of five models (8 leaves each, 40 calls) timed."""
    g = torch.Generator(device="cuda").manual_seed(3)
    max_err, rows = 0.0, []
    for n in CNN_LEAF_SIZES + (7, 2049, 100_003):
        for tensor_scale in (True, False):
            acc = torch.randn(n, device="cuda", generator=g)
            q = torch.randint(-511, 512, (n,), device="cuda", generator=g,
                              dtype=torch.int32)
            scale = torch.rand((), device="cuda", generator=g) * 4e-3
            w = 0.2
            got = qa.quant_agg(acc, q, scale if tensor_scale
                               else float(scale), w)
            ws = torch.stack([torch.full((), w, device="cuda"), scale])
            want = qa.quant_agg_plain(acc, q, ws)
            torch.cuda.synchronize()
            ok, err = _close(torch, got, want, 1e-5, 1e-6)
            rows.append({"n": n, "tensor_scale": tensor_scale,
                         "max_abs_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"quant_agg n={n} tensor_scale="
                                     f"{tensor_scale}: max |kernel - "
                                     f"plain| = {err}")
            max_err = max(max_err, err)
    models = []
    for _ in range(5):
        models.append([(torch.randint(-511, 512, (n,), device="cuda",
                                      generator=g, dtype=torch.int32),
                        torch.rand((), device="cuda", generator=g) * 4e-3)
                       for n in CNN_LEAF_SIZES])
    accs = [torch.zeros(n, device="cuda") for n in CNN_LEAF_SIZES]
    host_ws = [[0.2 * float(s) for _, s in m] for m in models]

    def stream(step):
        out = accs
        for i, m in enumerate(models):
            out = [step(a, q, s, host_ws[i][j])
                   for j, (a, (q, s)) in enumerate(zip(out, m))]
        return out

    timing = timed_set(torch, {
        "ms": lambda: stream(lambda a, q, s, _: qa.quant_agg(a, q, s, 0.2)),
        "plain_ms": lambda: stream(lambda a, q, s, _: qa.quant_agg_plain(
            a, q, torch.stack([torch.full((), 0.2, device="cuda"), s]))),
        # one library call per leaf and model; alpha (= weight * scale)
        # is a host number, read back before the timed window
        "library_ms": lambda: stream(
            lambda a, q, s, ws: torch.add(a, q, alpha=ws)),
    })
    nbytes = 5 * sum(12 * n + 8 for n in CNN_LEAF_SIZES)
    ops = 5 * sum(2 * n + 1 for n in CNN_LEAF_SIZES)
    timing["bytes"] = nbytes
    timing["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                             ops / FP32_FLOPS_PER_S) * 1e3
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
    from repro_torch.kernels import trimmed_agg as ta
    from repro_torch.orbit.constellation import WalkerStar, satellite_elements
    from repro_torch.orbit.groundstations import gs_ecef
    from repro_torch.orbit.visibility import (elevation_mask_series,
                                              interplane_los_series)
    from repro_torch.sim.flystack import FLySTacK
    from repro_torch.sim.hardware import SMALLSAT_SBAND

    t_start = time.perf_counter()
    report = {}
    counters = ((qa, "launches"), (ta, "launches"), (qa, "single_launches"))

    def reset_counts():
        for mod, attr in counters:
            setattr(mod, attr, 0)

    def read_counts():
        return tuple(getattr(mod, attr) for mod, attr in counters)
    card = gpu_line()
    print(f"[1 device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    qs.full_precision()
    print("[2 precision] allow_tf32 = False for cuda matmul and cudnn "
          "(cuDNN runs float32 convolutions in TF32 by default, which "
          "breaks parity with the CPU)")

    t0 = time.perf_counter()
    sources = ["quant_agg", "trimmed_agg"]
    _build.build(sources)
    build_s = time.perf_counter() - t0
    report["build_s"] = build_s
    report["ptxas"] = {}
    for src in sources:
        log = _build.build_log.get(src, "")
        report["ptxas"][src] = log
        print(f"[3 build] {src}.cu -> sm_90a (all sources in {build_s:.2f} "
              f"s); {ptxas_summary(log)}")

    max_err, timing, rows = k1_phase(torch, qa)
    report["kernel_rows"] = rows
    report["timing"] = {str(k): v for k, v in timing.items()}
    t5 = timing[5]
    print(f"[4 kernels] K1 quant_agg_stacked vs plain: {len(rows)} shapes "
          f"allclose (rtol=atol=1e-5), max |err| {max_err:.3g}; one "
          f"aggregation (8 leaves, K=5) eager / CUDA graph: kernel "
          f"{t5['ms']:.4f} / {t5['graph_ms']:.4f} ms, plain "
          f"{t5['plain_ms']:.4f} / {t5['plain_graph_ms']:.4f} ms, addmv "
          f"{t5['library_ms']:.4f} / {t5['library_graph_ms']:.4f} ms, bound "
          f"{t5['bound_ms']:.5f} ms")
    k2_err, k2_time, k2_rows = k2_phase(torch, ta)
    report["k2_rows"], report["k2_timing"] = k2_rows, k2_time
    print(f"[4 kernels] K2 trimmed_agg_stacked vs plain: {len(k2_rows)} "
          f"cases allclose (rtol=1e-5, atol=1e-6; K up to 100, +inf pads, "
          f"NaN), max |err| {k2_err:.3g}; one robust aggregation (8 "
          f"leaves, K=5) eager / CUDA graph: kernel {k2_time['ms']:.4f} / "
          f"{k2_time['graph_ms']:.4f} ms, plain {k2_time['plain_ms']:.4f} / "
          f"{k2_time['plain_graph_ms']:.4f} ms, sort + matmul "
          f"{k2_time['library_ms']:.4f} / {k2_time['library_graph_ms']:.4f}"
          f" ms, bound {k2_time['bound_ms']:.5f} ms")
    k3_err, k3_time, k3_rows = k3_phase(torch, qa)
    report["k3_rows"], report["k3_timing"] = k3_rows, k3_time
    print(f"[4 kernels] K3 quant_agg vs plain: {len(k3_rows)} cases "
          f"allclose (rtol=1e-5, atol=1e-6), max |err| {k3_err:.3g}; one "
          f"in-place aggregation (5 models x 8 leaves, 40 calls) eager / "
          f"CUDA graph: kernel {k3_time['ms']:.4f} / "
          f"{k3_time['graph_ms']:.4f} ms, plain {k3_time['plain_ms']:.4f} / "
          f"{k3_time['plain_graph_ms']:.4f} ms, torch.add "
          f"{k3_time['library_ms']:.4f} / {k3_time['library_graph_ms']:.4f}"
          f" ms, bound {k3_time['bound_ms']:.5f} ms")

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

    reset_counts()
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
    k1_main, k2_main, k3_main = read_counts()
    report["main_path_s"] = time.perf_counter() - t0
    if k2_main or k3_main:
        raise AssertionError(f"phase 5 launched K2 {k2_main} / K3 {k3_main} "
                             "times; its path runs only K1")

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

    # -- phase 6: the other engines and the robust server ----------------
    engines = (("fedprox_sch", None), ("fedprox_schv2", None),
               ("fedbuff", None), ("fedavg", "trimmed_mean"),
               ("fedbuff", "median"))
    eng_report, k_launch = {}, [0, 0]
    for alg, agg in engines:
        tag = alg if agg is None else f"{alg}+{agg}"
        cfg = qs.quickstart_config(alg)
        cfg = dataclasses.replace(cfg, fl=dataclasses.replace(
            cfg.fl, aggregator=agg))
        reset_counts()
        sim = FLySTacK(cfg, hw=SMALLSAT_SBAND, plan=plan, device=dev)
        t_alg = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        t_alg = time.perf_counter() - t_alg
        n1, n2, n3 = read_counts()
        k_launch[0] += n1
        k_launch[1] += n2
        n_rounds = len(res.records)
        on_card = all(p.is_cuda for p in sim.algo.global_params.values()) \
            and sim.dataset.x.is_cuda and sim.dataset.y.is_cuda
        finite = all(bool(torch.isfinite(p).all())
                     for p in sim.algo.global_params.values())
        want = {"fedprox_sch": (8, 0), "fedprox_schv2": (8, 0),
                "fedbuff": (0, 0)}.get(tag, (0, 8))
        print(f"[6 {tag}] cuda: {json.dumps(res.summary())}; launches K1 "
              f"{n1}, K2 {n2}, K3 {n3} in {n_rounds} rounds; run "
              f"{t_alg:.3f} s ({t_alg / max(n_rounds, 1):.4f} s a round)")
        if not on_card:
            raise AssertionError(f"{tag}: parameters or data not on cuda")
        if not finite:
            raise AssertionError(f"{tag}: non-finite global parameters")
        if n_rounds < 3 or (n1, n2, n3) != (want[0] * n_rounds,
                                            want[1] * n_rounds, 0):
            raise AssertionError(
                f"{tag}: launches K1 {n1}, K2 {n2}, K3 {n3} over "
                f"{n_rounds} rounds; expected {want[0]} K1 and {want[1]} K2 "
                "a round")
        cpu_res = FLySTacK(cfg, hw=SMALLSAT_SBAND, plan=plan,
                           device="cpu").run()
        ok, why = records_equal(res.records, cpu_res.records)
        gaps = [round(512 * abs(a.accuracy - b.accuracy))
                for a, b in zip(res.records, cpu_res.records)]
        print(f"[6 {tag}] cpu run: records equal {ok}; accuracy gap per "
              f"round in test samples {gaps} {why}")
        if not ok:
            raise AssertionError(f"{tag}: card and CPU records differ: {why}")
        eng_report[tag] = {"rounds": n_rounds, "launches": [n1, n2, n3],
                           "run_s": t_alg, "s_per_round": t_alg / n_rounds,
                           "summary": res.summary(), "cpu_equal": ok,
                           "acc_gap_samples": gaps}
    report["engines"] = eng_report

    # -- phase 7: streamed in-place aggregation through K3 ---------------
    from repro_torch.core.aggregation import quantized_weighted_average
    from repro_torch.core.quantize import quantize_pytree
    from repro_torch.kernels.ops import quantized_inplace_aggregate
    from repro_torch.models.small import MODELS
    from repro_torch.rng import TorchRandom
    base = MODELS["cnn"][0](TorchRandom(7), (28, 28, 1), 62, device=dev)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cohort = [{k: v + 0.01 * torch.randn(v.shape, device="cuda",
                                         generator=gen)
               for k, v in base.items()} for _ in range(5)]
    weights = [32.0, 32.0, 16.0, 32.0, 8.0]
    stacked = {k: torch.stack([m[k] for m in cohort]) for k in base}
    reset_counts()
    qs_, ss_ = zip(*(quantize_pytree(m, 10) for m in cohort))
    inplace = quantized_inplace_aggregate(list(qs_), list(ss_), weights)
    torch.cuda.synchronize()
    n1, n2, n3 = read_counts()
    k1_ref = quantized_weighted_average(stacked, np.asarray(weights), 10)
    torch.cuda.synchronize()
    errs = {k: float((inplace[k] - k1_ref[k]).abs().max()) for k in base}
    close = all(torch.allclose(inplace[k], k1_ref[k], rtol=1e-5, atol=1e-6)
                for k in base)
    print(f"[7 in-place] 10-bit cohort of 5 CNN models: K3 {n3} launches "
          f"(K1 {n1}, K2 {n2}); allclose to K1's aggregate (rtol=1e-5, "
          f"atol=1e-6) {close}, max |err| {max(errs.values()):.3g}")
    if (n1, n2, n3) != (0, 0, 5 * len(base)) or not close:
        raise AssertionError(f"in-place aggregation: launches K1 {n1}, K2 "
                             f"{n2}, K3 {n3}; allclose {close}; {errs}")
    report["inplace"] = {"launches": n3, "max_abs_err": errs}
    k3_main = n3

    kernels = [{
        "name": "quant_agg_stacked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_agg.cu",
        "replaces": "src/repro/kernels/quant_agg.py:100",
        "launches": k1_main + k_launch[0],
        "max_abs_err": max_err,
        "ms": timing[5]["ms"],
        "kernel_ms": timing[5]["ms"],
        "plain_ms": timing[5]["plain_ms"],
        "bound_ms": timing[5]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": timing[5]["library_ms"],
        "graph_ms": timing[5]["graph_ms"],
        "plain_graph_ms": timing[5]["plain_graph_ms"],
        "library_graph_ms": timing[5]["library_graph_ms"],
        "library": "torch.addmv",
        "shape": "one aggregation: 8 CNN leaves (213,630 values), K=5",
    }, {
        "name": "trimmed_agg_stacked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trimmed_agg.cu",
        "replaces": "src/repro/kernels/trimmed_agg.py:79",
        "launches": k_launch[1],
        "max_abs_err": k2_err,
        "ms": k2_time["ms"],
        "kernel_ms": k2_time["ms"],
        "plain_ms": k2_time["plain_ms"],
        "bound_ms": k2_time["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k2_time["library_ms"],
        "graph_ms": k2_time["graph_ms"],
        "plain_graph_ms": k2_time["plain_graph_ms"],
        "library_graph_ms": k2_time["library_graph_ms"],
        "library": "torch.sort then rw @ sorted (two calls a leaf)",
        "shape": "one robust aggregation: 8 CNN leaves, K=5, trimmed mean",
    }, {
        "name": "quant_agg",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_agg.cu",
        "replaces": "src/repro/kernels/quant_agg.py:53",
        "launches": k3_main,
        "max_abs_err": k3_err,
        "ms": k3_time["ms"],
        "kernel_ms": k3_time["ms"],
        "plain_ms": k3_time["plain_ms"],
        "bound_ms": k3_time["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3_time["library_ms"],
        "graph_ms": k3_time["graph_ms"],
        "plain_graph_ms": k3_time["plain_graph_ms"],
        "library_graph_ms": k3_time["library_graph_ms"],
        "library": "torch.add(acc, q, alpha=w*s)",
        "shape": "one in-place aggregation: 5 models x 8 CNN leaves, "
                 "40 calls",
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
