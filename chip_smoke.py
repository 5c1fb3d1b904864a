#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. device     — a CUDA card is present; its name and power limit;
  2. precision  — TF32 off for matmuls and cuDNN convolutions, cuDNN's
                  algorithms deterministic;
  3. build      — nvcc builds every kernel source of the port (sm_90a),
                  all at once, with each source's registers and spills;
  4. kernels    — each kernel (K1 quant_agg_stacked, K2
                  trimmed_agg_stacked and K3 quant_agg: single leaves and
                  whole-cohort / whole-model leaf tables, K2 also with a
                  validity mask) against its plain PyTorch version on the
                  card, at the main path's shapes and more, with timings
                  beside the plain version, one PyTorch library call and
                  the bound (K2 also at a byte-bound shape);
  5. main path  — the quickstart pipeline (fedavg, fedavg_sch, autoflsat
                  with 10-bit QuAFL) on the card through FLySTacK, kernel
                  launches counted (one K1 table a round), then the same
                  runs on the CPU: every non-accuracy field of every
                  RoundRecord must be equal; the plan's visibility and
                  eclipse series card against CPU (samples that differ;
                  the PackedEclipse arrays must be equal);
  6. engines    — FedProxSch, FedProxSchV2, FedBuff, FedAvg with the
                  trimmed mean and FedBuff with the median, the same way:
                  K1 runs once every FedProx round, K2 once every robust
                  round or flush (one table for all 8 leaves; K1 none),
                  plain FedBuff neither; then the optional layers at the
                  quickstart configuration (``faulted_runs``: every engine
                  with faults and storms, battery energy, deadlines with
                  carry and discard, bounded retries, the energy-drain and
                  poison attacks, the deadline_aware / energy_aware /
                  oracle policies), one K1 or K2 launch a round, card
                  against CPU, with every fault counter firing somewhere
                  and the poisoned trimmed-mean run's lost updates
                  reaching K2's validity mask (rows masked beyond the
                  cohort's pads); and the full-width AutoFLSat of
                  ``repro_torch.constellation_train`` (4 x 10 satellites,
                  EuroSAT, 12 rounds) with energy, faults and a deadline:
                  seconds a round and one K1 launch a round on the card;
                  round 0 alone, card against CPU, records (accuracy
                  within ACC_TOL_EARLY) and global parameters (1e-5 but
                  for the coordinates a 10-bit snap moves); its first 3
                  records equal on the CPU;
  7. in-place   — the streamed in-place aggregation of one 10-bit cohort
                  through K3 (one launch per model), bitwise against a
                  per-leaf K3 stream and close to K1's cohort aggregation;
  8. LM kernels — K4 ssd_chunk (float32: its tensor-core instance in
                  split TF32, and its CUDA-core one at a state width
                  above 128) and K5 swa_attention (bfloat16 through its
                  tensor-core instance, float32 through its CUDA-core one)
                  against their plain versions on the card, at the smoke
                  shapes and at the full-width serving shapes, timed
                  beside the plain version, the bounds and (K5)
                  ``scaled_dot_product_attention``;
  9. serving    — ``repro_torch.launch.serve.generate`` (prefill, cache
                  handoff, 16 greedy tokens) at mamba2-1.3b (the whole
                  published config, ssm_impl="pallas": K4's tensor-core
                  instance) and mixtral-8x22b (full widths, 2 layers,
                  attn_impl="flash": K5's tensor-core instance),
                  bfloat16: launch counts,
                  prefill seconds, decode tokens/s, peak memory; the
                  prefill's last-token logits against the plain routes on
                  the card; a torch.profiler breakdown of one mixtral
                  prefill; the smoke configs' greedy tokens, card against
                  CPU, in float32;
 10. training   — (a) one float32 train step of each of the ten smoke
                  configs, card against CPU (loss and grad norm); (b) the
                  gradient of mamba2-1.3b at full widths, depth cut to 4
                  layers, card against CPU, every leaf; (c) the
                  whole-config mamba2-1.3b hierarchical run of
                  ``repro_torch.launch.train`` (2 clusters, 8 steps of 4 x
                  1024 tokens, bfloat16, 10-bit sync every 4 steps):
                  seconds a cluster-step, tokens/s, sync seconds, peak
                  memory, a falling loss, clusters bitwise equal after
                  every sync, no K1-K5 launch; a torch.profiler breakdown
                  of one step; (d) a reduced HFL state saved on the card,
                  restored on the CPU bitwise, a flipped bit caught;
 11. dry run    — (a) the dry run (``repro_torch.launch.dryrun``, a fake
                  process group) of (c)'s per-cluster step on a one-rank
                  mesh, against the same step on the card under the same
                  op-trace analyzer: matmul FLOPs equal, the predicted
                  peak within DRY_PEAK_BAR of ``max_memory_allocated``,
                  the step's seconds beside the roofline times; (b) a
                  reduced HFL state restored onto a one-rank ``cuda``
                  DeviceMesh with the HFL placements, bitwise; no K1-K5
                  launch in (a) and (b); (c) the one-rank dry runs of
                  phase 9's kernel-route prefills (K4 and K5 traced as
                  custom ops over meta tensors) against the same prefill
                  on the card, which launches K4 48 times and K5 twice:
                  matmul FLOPs equal, peak within DRY_PEAK_BAR;
 12. sharded dry run — the dry run on this machine's torch over ``cuda``
                  meshes of fake ranks, each case in a process of its own:
                  the thirteen small-mesh cases of ``tools/dryrun_small.py``
                  (8 ranks; matmul FLOPs 1 to 1.2 times a rank's share of
                  the one-rank trace, at most 1.05 times the JAX
                  package's dots, peak and link bytes at most 1.25 times
                  its figures) and mamba2-1.3b ``train_4k`` on the
                  256-rank mesh and mixtral-8x22b ``decode_32k`` on the
                  512-rank one at full width (FLOPs and peak at most 1.25
                  times the JAX package's record, link bytes at most 4
                  times); the JAX package's figures from
                  ``tests/dryrun_reference.json``;
and then the ``kernels`` JSON line, the card's name and power limit, and
the result line. Each path runs with every launch count set to 0 just
before it and read just after. Details go to
``chiprun_out/chip_smoke.json``.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's data-sheet rates, one source for the port and this script
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import \
    PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import \
    PEAK_FLOPS_FP32 as FP32_FLOPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import \
    PEAK_FLOPS_TF32 as TF32_FLOPS_PER_S  # noqa: E402

# Full-width serving shapes of phase 9: mamba2-1.3b prefill of 4 x 1024
# tokens (K4: b, nc, c, h, p, g, n) and mixtral-8x22b prefill of 4 x 8192
# tokens (K5: B, L, H, KH, hd, window).
K4_FULL = (4, 4, 256, 64, 64, 1, 128)
K5_FULL = (4, 8192, 48, 8, 128, 4096)
# K5's bfloat16 bar in relative L2 over a case, beside 2e-2 a value: an
# emulation of the tensor-core instance's rounding (bfloat16 p, output
# rounded to bfloat16) stays near 2e-3 of the plain version
# (tests/test_torch_swa_attention.py), so 1e-2 leaves it 5x room.
K5_BF16_REL_L2 = 1e-2
SERVE_BATCH, SERVE_GEN = 4, 16
SERVE_RUNS = (("mamba2-1.3b", 1024, 0, {"ssm_impl": "pallas"}),
              ("mixtral-8x22b", 8192, 2, {"attn_impl": "flash"}))
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
# the EuroSAT CNN of the full-width run (1,055,082 parameters); its
# aggregation is one K1 table over the 4 cluster models (10 at
# constellation_train --clusters 10)
EUROSAT_LEAF_SIZES = (432, 16, 4608, 32, 1_048_576, 128, 1280, 10)


def launch_counters():
    """(reset_counts, read_counts) over the kernels' launch counters: K1,
    K2, K3, K4 (both instances), K5 (both instances), K5's and K4's
    tensor-core instances."""
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
    return reset_counts, read_counts


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


def time_ms(torch, fn, reps=200, trials=7, warmup=10):
    """Median over ``trials`` of the mean per-call time of ``reps`` calls,
    with CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
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
    weight*scale products of the main path's size (|sw * q| <= 1): single
    leaves (a table of one) at every CNN leaf size and more, the full-width
    run's EuroSAT CNN leaves at K = 4 and 10 among them; then tables in
    place (the 8 CNN leaves; 40 leaves, two tables, some off the 16-byte
    grid; the 8 EuroSAT leaves at K = 4, and at K = 10 off the grid; a pad
    row with sw = 0), bitwise against the same leaves as tables of one.
    Then one aggregation (8 leaves) timed as the main
    path makes it (one table), as 8 tables of one, plain, and as 8
    ``addmv`` calls. Returns (max |kernel - plain|, timings, rows)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(n, k, False) for n in CNN_LEAF_SIZES for k in (5, 2)]
    cases += [(n, k, False) for n in (7, 2049, 100_003) for k in (1, 4, 10)]
    cases += [(n, k, False) for n in EUROSAT_LEAF_SIZES for k in (4, 10)]
    cases += [(4608, 5, True), (62, 5, True)]    # pad row with sw = 0
    cases += [(1_048_576, 4, True)]              # a cluster with no member
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
    sizes_40 = [int(n) for n in torch.randint(
        1, 5000, (40,), generator=torch.Generator().manual_seed(1))]
    for tag, sizes, shift, k in (("cnn", CNN_LEAF_SIZES, False, 5),
                                 ("40 leaves", sizes_40, True, 5),
                                 ("eurosat cnn", EUROSAT_LEAF_SIZES, False,
                                  4),
                                 ("eurosat cnn", EUROSAT_LEAF_SIZES, True,
                                  10)):
        buf = torch.randn(sum(sizes) + len(sizes), device="cuda",
                          generator=g)
        accs, off = [], 0
        for i, n in enumerate(sizes):
            off += shift and i % 3 == 1
            accs.append(buf[off:off + n])
            off += n
        qs = [torch.randint(-511, 512, (k, n), device="cuda", generator=g,
                            dtype=torch.int32) for n in sizes]
        sw = torch.rand(len(sizes), k, device="cuda", generator=g) * 2e-3
        sw[:, -1] = 0.0                          # the pad row
        for q in qs:
            q[-1] = 511
        per_leaf = [qa.quant_agg_stacked(a, q, w)
                    for a, q, w in zip(accs, qs, sw)]
        plain = [qa.quant_agg_stacked_plain(a, q, w)
                 for a, q, w in zip(accs, qs, sw)]
        before = qa.launches
        qa.quant_agg_stacked_inplace(accs, qs, list(sw))
        torch.cuda.synchronize()
        n_launch = qa.launches - before
        bitwise = all(bool(torch.equal(a, w)) for a, w in zip(accs, per_leaf))
        res = [_close(torch, a, w, 1e-5, 1e-5) for a, w in zip(accs, plain)]
        ok, err = all(r[0] for r in res), max(r[1] for r in res)
        want_launch = -(-len(sizes) // qa.TABLE_CAPACITY)
        rows.append({"table": tag, "leaves": len(sizes), "K": k,
                     "launches": n_launch, "bitwise_per_leaf": bitwise,
                     "max_abs_err": err, "ok": ok})
        if not (ok and bitwise and n_launch == want_launch):
            raise AssertionError(f"quant_agg_stacked_inplace {tag}: "
                                 f"{n_launch} launches (want {want_launch}),"
                                 f" bitwise {bitwise}, max |kernel - plain| "
                                 f"{err}")
        max_err = max(max_err, err)
    # timings at the main path's shapes: one FedAvg aggregation is one
    # table of the 8 CNN leaves at K = 5 (AutoFLSat's tier 2: K = 2),
    # written in place; "per_leaf_ms" makes the same aggregation as 8
    # tables of one (the launches of the path before the table), each
    # writing a new tensor. "graph_ms" replays the same calls from a CUDA
    # graph, which leaves out the host's launch cost.
    timing = {}
    for k in (5, 2):
        accs = [torch.randn(n, device="cuda", generator=g)
                for n in CNN_LEAF_SIZES]
        qs = [torch.randint(-511, 512, (k, n), device="cuda", generator=g,
                            dtype=torch.int32) for n in CNN_LEAF_SIZES]
        sws = list(torch.rand(len(CNN_LEAF_SIZES), k, device="cuda",
                              generator=g) * 2e-3)
        # the float copy of q is made here, outside the timed window
        qfs = [q.to(torch.float32).t() for q in qs]
        leaves = list(zip(accs, qs, sws, qfs))
        tot = timed_set(torch, {
            "ms": lambda: qa.quant_agg_stacked_inplace(accs, qs, sws),
            "per_leaf_ms": lambda: [qa.quant_agg_stacked(a, q, w)
                                    for a, q, w, _ in leaves],
            "plain_ms": lambda: [qa.quant_agg_stacked_plain(a, q, w)
                                 for a, q, w, _ in leaves],
            "library_ms": lambda: [torch.addmv(a, qf, w)
                                   for a, _, w, qf in leaves],
        })
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


def timed_set(torch, impls, **reps):
    """Eager and CUDA-graph time of each of ``impls`` {key: fn}: "key" and
    "key" with "ms" -> "graph_ms"; ``reps`` go to ``time_ms``."""
    tot = {}
    for key, fn in impls.items():
        tot[key] = time_ms(torch, fn, **reps)
        tot[key.replace("ms", "graph_ms")] = time_ms(
            torch, captured(torch, fn).replay, **reps)
    return tot


def _same(torch, a, b):
    """Bitwise equal, NaN for NaN (whatever the NaN's payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a.view(torch.int32)),
        torch.where(nb, 0, b.view(torch.int32))))


# compare-exchanges of K2's sorting network at the K of each timed shape:
# Batcher's odd-even merge sort of the bucket of 8, 16 or 32 keys, pruned
# to K (csrc/trimmed_agg.cu; tests/test_torch_trimmed_agg.py counts them)
K2_COMPARATORS = {5: 9, 10: 32, 32: 191}


def k2_phase(torch, ta, aggregation):
    """K2 against its plain version on the card: every CNN leaf at K = 5
    and 10, n = 7 / 2049 / 100,003 at K = 1, 2, 4, 33, 100, as tables of
    one with every row valid; trimmed-mean and median rank weights; for
    K > 2 the last two rows are +inf pads at zero-weight ranks; one NaN
    coordinate everywhere and one whole NaN row. Then masked cases: the
    pad rows hold garbage (NaN or a finite 7.0) that the host mask marks
    invalid, against the plain version on where(valid, x, inf); the 8 CNN
    leaves as one table against 8 tables of one, bitwise and NaN for NaN,
    masked and unmasked. Then one robust aggregation timed
    (``_rank_combine``: 8 leaves, K = 5) beside the per-leaf path it
    replaced, and the byte-bound shape (n = 2^24 at K = 10 and 32)."""
    import numpy as np
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
    # masked: garbage in the invalid rows, the mask and rank weights on the
    # host (by value up to K = 32, copied to the card above)
    masked = [(n, k, kind) for n in CNN_LEAF_SIZES for k in (5, 10)
              for kind in ("trimmed_mean", "median")]
    masked += [(n, k, kind) for n in (7, 2049, 100_003)
               for k in (2, 4, 16, 32, 33, 100)
               for kind in ("trimmed_mean", "median")]
    for i, (n, k, kind) in enumerate(masked):
        x = torch.randn(k, n, device="cuda", generator=g) * 0.05
        m = max(k - 2, 1)
        x[m:] = float("nan") if i % 2 else 7.0
        x[0, n // 2] = float("nan")
        valid = np.arange(k) < m
        rw = rank_weights(torch, k, kind, m)
        got, = ta.trimmed_agg_stacked_leaves([x], rw.cpu().numpy(), valid)
        vb = torch.from_numpy(valid).cuda()[:, None]
        want = ta.trimmed_agg_stacked_plain(torch.where(vb, x, torch.inf), rw)
        torch.cuda.synchronize()
        ok, err = _close(torch, got, want, 1e-5, 1e-6)
        rows.append({"n": n, "K": k, "m": m, "rank_weights": kind,
                     "masked": True, "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"trimmed_agg_stacked_leaves n={n} K={k} "
                                 f"m={m} {kind}: max |kernel - plain| = "
                                 f"{err}")
        max_err = max(max_err, err)
    # the 8 CNN leaves as one table against 8 tables of one
    for k, mask in ((5, None), (5, np.arange(5) < 3), (10, np.arange(10) < 8)):
        leaves = [torch.randn(k, n, device="cuda", generator=g) * 0.05
                  for n in CNN_LEAF_SIZES]
        for x in leaves:
            x[0, x.shape[1] // 2] = float("nan")
            if mask is not None:
                x[int(mask.sum()):] = float("nan")
        rw = rank_weights(torch, k, "median", k if mask is None
                          else int(mask.sum())).cpu().numpy()
        one = [ta.trimmed_agg_stacked_leaves([x], rw, mask)[0]
               for x in leaves]
        before = ta.launches
        table = ta.trimmed_agg_stacked_leaves(leaves, rw, mask)
        torch.cuda.synchronize()
        n_launch = ta.launches - before
        bitwise = all(_same(torch, a, b) for a, b in zip(table, one))
        rows.append({"table": "cnn", "K": k, "masked": mask is not None,
                     "launches": n_launch, "bitwise_per_leaf": bitwise})
        if not bitwise or n_launch != 1:
            raise AssertionError(f"trimmed_agg_stacked_leaves, 8 CNN leaves "
                                 f"K={k} masked={mask is not None}: "
                                 f"{n_launch} launches, bitwise {bitwise}")
    # one robust aggregation of the main path: 8 leaves, K = 5 valid rows,
    # trimmed-mean rank weights (ranks 1..3 at 1/3), as the aggregator
    # makes it; "per_leaf_ms" makes it as before the table (8 where + 8
    # tables of one), with the rank weights and the mask already on the
    # card (its two copies from the host left out); "kernel_ms" is the
    # table call alone
    k = 5
    rw_dev = rank_weights(torch, k, "trimmed_mean", k)
    rw = rw_dev.cpu().numpy()
    valid = np.ones(k, bool)
    vb = torch.from_numpy(valid).cuda()[:, None]
    leaves = [torch.randn(k, n, device="cuda", generator=g) * 0.05
              for n in CNN_LEAF_SIZES]
    stacked = {f"leaf{i}": x for i, x in enumerate(leaves)}
    timing = timed_set(torch, {
        "ms": lambda: aggregation._rank_combine(stacked, valid, rw),
        "kernel_ms": lambda: ta.trimmed_agg_stacked_leaves(leaves, rw,
                                                           valid),
        "per_leaf_ms": lambda: [
            ta.trimmed_agg_stacked(torch.where(vb, x, torch.inf), rw_dev)
            for x in leaves],
        "plain_ms": lambda: [ta.trimmed_agg_stacked_plain(x, rw_dev)
                             for x in leaves],
        # two library calls per leaf: a sort over the clients, then the
        # contraction with the rank weights
        "library_ms": lambda: [rw_dev @ torch.sort(x, 0).values
                               for x in leaves],
    })
    nbytes = sum((4 * k + 4) * n for n in CNN_LEAF_SIZES)
    # the network's compare-exchanges (an integer min and max each) plus a
    # multiply and an add per rank, per value
    ops = sum((2 * K2_COMPARATORS[k] + 2 * k) * n for n in CNN_LEAF_SIZES)
    timing["bytes"] = nbytes
    timing["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                             ops / FP32_FLOPS_PER_S) * 1e3
    # the byte-bound shape: one leaf of n = 2^24, K = 10 (8 valid) and 32
    # (30 valid), the pads NaN; the bound counts the valid rows read and
    # the output written
    n = 1 << 24
    timing["bytebound"] = []
    for k, m in ((10, 8), (32, 30)):
        x = torch.randn(k, n, device="cuda", generator=g) * 0.05
        x[m:] = float("nan")
        valid = np.arange(k) < m
        rw_dev = rank_weights(torch, k, "trimmed_mean", m)
        rw = rw_dev.cpu().numpy()
        got, = ta.trimmed_agg_stacked_leaves([x], rw, valid)
        vb = torch.from_numpy(valid).cuda()[:, None]
        want = ta.trimmed_agg_stacked_plain(torch.where(vb, x, torch.inf),
                                            rw_dev)
        torch.cuda.synchronize()
        ok, err = _close(torch, got, want, 1e-5, 1e-6)
        del want
        if not ok:
            raise AssertionError(f"trimmed_agg_stacked_leaves n=2^24 K={k}: "
                                 f"max |kernel - plain| = {err}")
        ms = time_ms(torch, lambda: ta.trimmed_agg_stacked_leaves(
            [x], rw, valid), reps=20, trials=5, warmup=3)
        nb = (m + 1) * n * 4
        ops = (2 * K2_COMPARATORS[k] + 2 * k) * n
        bound = max(nb / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S) * 1e3
        timing["bytebound"].append({
            "n": n, "K": k, "m": m, "ms": ms, "bound_ms": bound,
            "bound_share": bound / ms, "bytes": nb, "max_abs_err": err})
        max_err = max(max_err, err)
        del x, got
        torch.cuda.empty_cache()
    return max_err, timing, rows


def k3_phase(torch, qa):
    """K3 against its plain version on the card: single leaves (a table of
    one) at every CNN leaf size and n = 7 / 2049 / 100,003, with the scale
    a 0-d CUDA tensor (as the quantizer gives it) or a Python float; then
    whole-model tables in place (the 8 CNN leaves; 40 leaves, two tables,
    some off the 16-byte grid), bitwise against per-leaf calls. Then one
    in-place aggregation of five models (8 leaves each) timed: 5 launches,
    beside the 40 launches of the per-leaf path it replaced."""
    g = torch.Generator(device="cuda").manual_seed(3)
    max_err, rows = 0.0, []
    for n in CNN_LEAF_SIZES + (7, 2049, 100_003):
        for tensor_scale in (True, False):
            acc = torch.randn(n, device="cuda", generator=g)
            q = torch.randint(-511, 512, (n,), device="cuda", generator=g,
                              dtype=torch.int32)
            scale = torch.rand((), device="cuda", generator=g) * 4e-3
            sc = scale if tensor_scale else float(scale)
            got = qa.quant_agg(acc, q, sc, 0.2)
            want = qa.quant_agg_plain(acc, q, sc, 0.2)
            torch.cuda.synchronize()
            ok, err = _close(torch, got, want, 1e-5, 1e-6)
            rows.append({"n": n, "tensor_scale": tensor_scale,
                         "max_abs_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"quant_agg n={n} tensor_scale="
                                     f"{tensor_scale}: max |kernel - "
                                     f"plain| = {err}")
            max_err = max(max_err, err)
    sizes_40 = [int(n) for n in torch.randint(
        1, 5000, (40,), generator=torch.Generator().manual_seed(3))]
    for tag, sizes, shift, k in (("cnn", CNN_LEAF_SIZES, False, 5),
                                 ("40 leaves", sizes_40, True, 5),
                                 ("eurosat cnn", EUROSAT_LEAF_SIZES, False,
                                  4),
                                 ("eurosat cnn", EUROSAT_LEAF_SIZES, True,
                                  10)):
        buf = torch.randn(sum(sizes) + len(sizes), device="cuda",
                          generator=g)
        accs, off = [], 0
        for i, n in enumerate(sizes):
            off += shift and i % 3 == 1
            accs.append(buf[off:off + n])
            off += n
        qs = [torch.randint(-511, 512, (n,), device="cuda", generator=g,
                            dtype=torch.int32) for n in sizes]
        scales = [torch.rand((), device="cuda", generator=g) * 4e-3
                  for _ in sizes]
        scales = [s if i % 2 else float(s) for i, s in enumerate(scales)]
        per_leaf = [qa.quant_agg(a, q, s, 0.2)
                    for a, q, s in zip(accs, qs, scales)]
        plain = [qa.quant_agg_plain(a, q, s, 0.2)
                 for a, q, s in zip(accs, qs, scales)]
        before = qa.single_launches
        qa.quant_agg_inplace(accs, qs, scales, 0.2)
        torch.cuda.synchronize()
        n_launch = qa.single_launches - before
        bitwise = all(bool(torch.equal(a, w)) for a, w in zip(accs, per_leaf))
        res = [_close(torch, a, w, 1e-5, 1e-6) for a, w in zip(accs, plain)]
        ok, err = all(r[0] for r in res), max(r[1] for r in res)
        want_launch = -(-len(sizes) // qa.TABLE_CAPACITY)
        rows.append({"table": tag, "leaves": len(sizes),
                     "launches": n_launch, "bitwise_per_leaf": bitwise,
                     "max_abs_err": err, "ok": ok})
        if not (ok and bitwise and n_launch == want_launch):
            raise AssertionError(f"quant_agg_inplace {tag}: {n_launch} "
                                 f"launches (want {want_launch}), bitwise "
                                 f"{bitwise}, max |kernel - plain| {err}")
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

    def inplace():
        for m in models:
            qa.quant_agg_inplace(accs, [q for q, _ in m], [s for _, s in m],
                                 0.2)

    timing = timed_set(torch, {
        "ms": inplace,
        # the per-leaf path: one launch per leaf and model, new tensors
        "per_leaf_ms": lambda: stream(
            lambda a, q, s, _: qa.quant_agg(a, q, s, 0.2)),
        "plain_ms": lambda: stream(
            lambda a, q, s, _: qa.quant_agg_plain(a, q, s, 0.2)),
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


def ssd_inputs(torch, shape, gen):
    """K4's inputs on the card, drawn as tests/test_kernels.py draws them:
    dt post-softplus, A < 0, B and C at group width."""
    b, nc, c, h, p, g, n = shape

    def rn(*sh):
        return torch.randn(sh, device="cuda", generator=gen)
    dt = torch.nn.functional.softplus(rn(b, nc, c, h))
    return (rn(b, nc, c, h, p), dt, -torch.exp(rn(h) * 0.3),
            rn(b, nc, c, g, n) * 0.5, rn(b, nc, c, g, n) * 0.5)


def k4_cost(shape):
    """(operations, bytes) of one K4 call: per (b, chunk, head) C.B, the
    decay-and-dt scaling and W.x over the c(c+1)/2 pairs j <= i, and the
    state's x^T (B scaled); each input read once, each output written
    once (float32)."""
    b, nc, c, h, p, g, n = shape
    pairs = c * (c + 1) // 2
    ops = b * nc * h * (pairs * (2 * n + 2 * p + 3) + c * (2 * p * n + n + 2))
    nbytes = 4 * (2 * b * nc * c * h * p + b * nc * c * h + h
                  + 2 * b * nc * c * g * n + b * nc * h * p * n)
    return ops, nbytes


def k4_phase(torch, K4):
    """K4 against its plain version on the card (rtol = atol = 2e-4, the
    CPU parity bar): tests/test_kernels.py's three shapes, B and C
    head-repeated, a ragged chunk, the mamba2 smoke serving shape (4 x 24
    tokens) and the full-width prefill shape, all on the tensor-core
    instance, and a state width of 160, which ``route`` gives the CUDA-core
    one; each case checks that the instance ``route`` names ran. Then timed
    at the full shape: the tensor-core instance eager and from a CUDA
    graph, the CUDA-core instance, and the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(1, 4, 16, 2, 16, 1, 16), (2, 4, 32, 4, 32, 2, 32),
             (1, 3, 32, 2, 64, 1, 128), (2, 2, 32, 4, 32, 4, 32),
             (1, 2, 100, 4, 64, 2, 32), (4, 1, 24, 16, 32, 1, 32), K4_FULL,
             (1, 2, 64, 2, 32, 1, 160)]
    max_err, rows = 0.0, []
    for shape in cases:
        args = ssd_inputs(torch, shape, gen)
        tc_before = K4.tc_launches
        y, st = K4.ssd_chunk(*args)
        instance = ("tensor_core" if K4.tc_launches > tc_before
                    else "cuda_core")
        y_want, st_want = K4.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        ok_y, err_y = _close(torch, y, y_want, 2e-4, 2e-4)
        ok_s, err_s = _close(torch, st, st_want, 2e-4, 2e-4)
        err = max(err_y, err_s)
        rows.append({"shape": shape, "instance": instance,
                     "max_abs_err": err, "ok": ok_y and ok_s})
        if shape == K4_FULL:
            # the CUDA-core instance on the same inputs: how far float32
            # rounding in another order alone lands at this size
            y_cc, st_cc = K4._launch(*args, instance="cuda_core")
            torch.cuda.synchronize()
            rows[-1].update(
                cuda_core_max_abs_err=max(
                    _close(torch, y_cc, y_want, 2e-4, 2e-4)[1],
                    _close(torch, st_cc, st_want, 2e-4, 2e-4)[1]),
                y_abs_max=float(y_want.abs().max()))
        if instance != K4.route(shape[2], shape[4], shape[6]):
            raise AssertionError(f"ssd_chunk {shape} ran the {instance} "
                                 "instance")
        if not (ok_y and ok_s):
            raise AssertionError(f"ssd_chunk {shape} ({instance}): max "
                                 f"|kernel - plain| y {err_y}, states "
                                 f"{err_s}")
        max_err = max(max_err, err)
    args = ssd_inputs(torch, K4_FULL, gen)
    timing = timed_set(torch, {
        "ms": lambda: K4.ssd_chunk(*args),
        "plain_ms": lambda: K4.ssd_chunk_plain(*args),
    }, reps=10, trials=5, warmup=2)
    timing["cuda_core_ms"] = time_ms(
        torch, lambda: K4._launch(*args, instance="cuda_core"), reps=10,
        trials=5, warmup=2)
    ops, nbytes = k4_cost(K4_FULL)
    # the tensor-core instance does each product three times in TF32
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 3 * ops / TF32_FLOPS_PER_S) * 1e3
    fp32_bound_ms = max(nbytes / HBM_BYTES_PER_S,
                        ops / FP32_FLOPS_PER_S) * 1e3
    timing.update(ops=ops, bytes=nbytes, bound_ms=bound_ms,
                  bound_by="operations" if 3 * ops / TF32_FLOPS_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes",
                  bound_share=bound_ms / timing["ms"],
                  fp32_bound_ms=fp32_bound_ms,
                  fp32_bound_share=fp32_bound_ms / timing["ms"],
                  bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                  tflops=ops / timing["ms"] / 1e9)
    return max_err, timing, rows


def k5_cost(B, L, H, KH, hd, window, itemsize):
    """(visible pairs, operations, bytes) of one K5 call: 2 hd
    multiply-adds per visible (query, key) pair for q.k and as many for
    p.v; q, k, v read once and the output written once."""
    vis = sum(min(i + 1, window) if window else i + 1 for i in range(L))
    pairs = B * H * vis
    nbytes = itemsize * (2 * B * L * H + 2 * B * L * KH) * hd
    return pairs, 4 * hd * pairs, nbytes


def k5_slices(torch, K5, q, k, v, window):
    """K5's plain version at a full shape, one (batch, kv head) slice at a
    time (attention is independent per batch row and kv group; the plain
    version's (L, L) scores of the whole batch would not fit the card)."""
    rep = q.shape[2] // k.shape[2]
    return [((b, kh), K5.swa_attention_plain(
        q[b:b + 1, :, kh * rep:(kh + 1) * rep], k[b:b + 1, :, kh:kh + 1],
        v[b:b + 1, :, kh:kh + 1], window, True))
        for b in range(q.shape[0]) for kh in range(k.shape[2])]


def sdpa_ms(torch, F, K5, q, k, v, window):
    """K5's library yardstick: one ``scaled_dot_product_attention`` call
    with the band as a boolean mask, on the memory-efficient backend (the
    math backend would hold the (B, H, L, L) scores, 51 GB at the mixtral
    shape). With ``enable_gqa=True`` if that backend takes it, else with
    the kv heads repeated beforehand, outside the timed window."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mask = K5.band_mask(q.shape[1], window, True, "cuda")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the backend's refusal notes
        try:
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)
            how, args, kw = "enable_gqa=True", (qt, kt, vt), {
                "enable_gqa": True}
        except RuntimeError:
            rep = q.shape[2] // k.shape[2]
            how, kw = "kv heads repeated beforehand", {}
            args = (qt, kt.repeat_interleave(rep, 1),
                    vt.repeat_interleave(rep, 1))
        ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            *args, attn_mask=mask, **kw), reps=3, trials=3, warmup=1)
    return {"library_ms": ms, "library_how": how}


def k5_phase(torch, K5):
    """K5 against its plain version on the card, float32 (2e-5, the
    CUDA-core instance) and bfloat16 (2e-2 a value and 1e-2 in relative L2
    over each case; the output is rounded to bfloat16): the four window
    cases of tests/test_kernels.py, ragged lengths, a non-causal window,
    hd 40 and 256 (bfloat16 shapes the tensor-core instance refuses, so
    they hold the bfloat16 CUDA-core instance), the mixtral smoke serving
    shape (4 x 24 tokens, window 64) and the full-width prefill shape
    (compared slice by slice); each case checks that the instance
    ``route`` names ran. Then timed at the full shape: bfloat16 (the
    serving type) eager and from a CUDA graph, float32, plain and
    library."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    small = [(2, 128, 4, 2, 32, 0, True), (2, 128, 4, 2, 32, 48, True),
             (2, 256, 4, 2, 32, 64, True), (2, 128, 4, 2, 32, 16, True),
             (1, 100, 4, 2, 64, 0, True), (1, 1000, 6, 2, 128, 300, True),
             (2, 128, 4, 1, 32, 48, False), (2, 200, 4, 2, 40, 64, True),
             (1, 300, 4, 2, 256, 100, True), (4, 24, 8, 2, 32, 64, True)]
    max_err, rows = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        name = str(dtype).split(".")[-1]
        for B, L, H, KH, hd, window, causal in small + [K5_FULL + (True,)]:
            q, k, v = (torch.randn((B, L, n, hd), device="cuda",
                                   generator=gen).to(dtype)
                       for n in (H, KH, KH))
            tc_before = K5.tc_launches
            got = K5.swa_attention(q, k, v, window, causal)
            instance = ("tensor_core" if K5.tc_launches > tc_before
                        else "cuda_core")
            if instance != K5.route(dtype, hd):
                raise AssertionError(f"swa_attention {dtype} hd={hd} ran "
                                     f"the {instance} instance")
            if (B, L, H, KH, hd, window) == K5_FULL:
                rep = H // KH
                pairs = [(got[b:b + 1, :, kh * rep:(kh + 1) * rep], want)
                         for (b, kh), want in k5_slices(torch, K5, q, k, v,
                                                        window)]
            else:
                pairs = [(got, K5.swa_attention_plain(q, k, v, window,
                                                      causal))]
            torch.cuda.synchronize()
            res = [_close(torch, a.float(), w.float(), tol, tol)
                   for a, w in pairs]
            ok, err = all(r[0] for r in res), max(r[1] for r in res)
            # relative L2 over the whole case: a fault confined to some
            # rows (an edge tile missed) moves it, where the per-value bar
            # of 2e-2 is as large as a typical output far past the window
            sq = [(float((a.float() - w.float()).square().sum()),
                   float(w.float().square().sum())) for a, w in pairs]
            rel_l2 = (sum(d for d, _ in sq) / max(sum(n for _, n in sq),
                                                 1e-30)) ** 0.5
            if dtype == torch.bfloat16:
                ok = ok and rel_l2 <= K5_BF16_REL_L2
            case = (B, L, H, KH, hd, window, causal)
            rows.append({"case": case, "dtype": name, "instance": instance,
                         "max_abs_err": err, "rel_l2": rel_l2, "ok": ok})
            if not ok:
                raise AssertionError(f"swa_attention {case} {name}: max "
                                     f"|kernel - plain| = {err}, relative "
                                     f"L2 {rel_l2}")
            max_err[name] = max(max_err.get(name, 0.0), err)
            del q, k, v, got, pairs
    ran = {r["instance"] for r in rows if r["dtype"] == "bfloat16"}
    if ran != {"tensor_core", "cuda_core"}:
        raise AssertionError(f"the bfloat16 cases ran only {ran}")
    B, L, H, KH, hd, window = K5_FULL
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        q, k, v = (torch.randn((B, L, n, hd), device="cuda",
                               generator=gen).to(dtype) for n in (H, KH, KH))
        timing[f"{name}_ms"] = time_ms(
            torch, lambda: K5.swa_attention(q, k, v, window, True),
            reps=3, trials=3, warmup=1)
        if dtype == torch.bfloat16:
            timing["graph_ms"] = time_ms(torch, captured(
                torch, lambda: K5.swa_attention(q, k, v, window, True)
            ).replay, reps=3, trials=3, warmup=1)
            timing["plain_ms"] = time_ms(
                torch, lambda: k5_slices(torch, K5, q, k, v, window),
                reps=1, trials=3, warmup=1)
            timing.update(sdpa_ms(torch, F, K5, q, k, v, window))
        del q, k, v
    pairs, ops, nbytes = k5_cost(B, L, H, KH, hd, window, 2)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S) * 1e3
    timing.update(ms=timing["bfloat16_ms"], pairs=pairs, ops=ops,
                  bytes=nbytes, bound_ms=bound_ms,
                  tflops=ops / timing["bfloat16_ms"] / 1e9,
                  bound_share=bound_ms / timing["bfloat16_ms"],
                  bound_by="operations" if ops / BF16_FLOPS_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes",
                  fp32_core_ms=ops / FP32_FLOPS_PER_S * 1e3)
    return max_err, timing, rows


def serve_config(name, n_layers, impl, dtype="bfloat16"):
    """A full-width config of ``repro_torch.configs``; depth cut to
    ``n_layers`` when it is not 0; the kernel route set as the JAX
    package's tests set it."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(name), compute_dtype=dtype, **impl)
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


PLAIN_ROUTES = {"ssm_impl": "jnp", "attn_impl": "chunked"}
# The prefill's last-token logits through the kernels against the plain
# routes on the card. Float32: the two differ only in the order of the
# sums inside K4 / K5, carried through up to 48 layers, so 1e-3 on logits
# of order 1 (the CPU parity bars are 2e-4 / 3e-4 at 2 layers). Bfloat16,
# the served type: activations are rounded to 8 bits after every op and
# 48 random layers amplify a rounding that lands otherwise (the two
# bfloat16 routes were 5.0% apart in relative L2 at mamba2-1.3b). So the
# bar is on accuracy: the kernel route's relative L2 distance from the
# float32 plain-route logits is at most BF16_ERR_RATIO times the bfloat16
# plain route's own.
F32_LOGIT_TOL, BF16_ERR_RATIO = 1e-3, 2.0


def serve_phase(torch, reset_counts, read_counts):
    """Phase 9: ``generate`` at the two full-width configs through the
    kernels, then the plain-route and card-vs-CPU checks."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import tree_leaves
    out = {}
    for name, plen, n_layers, impl in SERVE_RUNS:
        cfg = serve_config(name, n_layers, impl)
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = M.init_params(cfg, gen, device="cuda")
        prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, plen),
                                device="cuda", generator=gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        tokens = generate(cfg, params, prompts, SERVE_GEN, stats=stats)
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kernel_logits = stats["prefill_logits"].float()
        want = ((0, 0, 0, cfg.n_layers, 0, 0, cfg.n_layers)
                if name.startswith("mamba")
                else (0, 0, 0, 0, cfg.n_layers, cfg.n_layers, 0))
        ok_tokens = tokens.shape == (SERVE_BATCH, plen + SERVE_GEN) \
            and bool((tokens[:, :plen] == prompts).all()) \
            and 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab
        finite = bool(torch.isfinite(kernel_logits).all())
        plain = dataclasses.replace(cfg, **PLAIN_ROUTES)
        lg = {("kernel", "bfloat16"): kernel_logits}
        with torch.inference_mode():
            for tag, c in (("plain", plain), ("kernel", cfg)):
                for dt in ("bfloat16", "float32"):
                    if (tag, dt) not in lg:
                        lg[tag, dt] = M.prefill(
                            params, dataclasses.replace(c, compute_dtype=dt),
                            {"tokens": prompts})[0][:, -1].float()

        def rel(a, b):
            return float((lg[a] - lg[b]).norm() / lg[b].norm())
        truth = ("plain", "float32")
        err_k, err_p = rel(("kernel", "bfloat16"), truth), \
            rel(("plain", "bfloat16"), truth)
        rel_bf16 = rel(("kernel", "bfloat16"), ("plain", "bfloat16"))
        f32_err = float((lg["kernel", "float32"] - lg[truth]).abs().max())
        f32_ok = bool(torch.allclose(lg["kernel", "float32"], lg[truth],
                                     rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL))
        rec = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                          "d_model": cfg.d_model, "vocab": cfg.vocab,
                          "params": n_params, **impl},
               "batch": SERVE_BATCH, "prompt_len": plen, "gen": SERVE_GEN,
               "init_s": init_s, "prefill_s": stats["prefill_s"],
               "decode_s": stats["decode_s"],
               "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN
               / stats["decode_s"],
               "prefill_tokens_per_s": SERVE_BATCH * plen
               / stats["prefill_s"],
               "peak_gib": peak, "launches": list(counts),
               "bf16_rel_l2_vs_plain": rel_bf16,
               "bf16_kernel_rel_l2_vs_f32": err_k,
               "bf16_plain_rel_l2_vs_f32": err_p,
               "f32_max_abs_vs_plain": f32_err,
               "logit_abs_max": float(lg[truth].abs().max()),
               "sample": tokens[0, -SERVE_GEN:].tolist()}
        print(f"[9 {name}] {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
              f"params, batch {SERVE_BATCH} x prompt {plen} + {SERVE_GEN} "
              f"greedy: prefill {stats['prefill_s']:.4f} s, decode "
              f"{rec['decode_tokens_per_s']:.2f} tokens/s, peak "
              f"{peak:.2f} GiB; launches K1-K5, K5 tensor-core, K4 "
              f"tensor-core {list(counts)}; last-token "
              f"logits vs plain routes: f32 max |err| {f32_err:.3g} (bar "
              f"rtol=atol={F32_LOGIT_TOL}); bf16 rel L2 from the f32 "
              f"logits: kernel route {err_k:.4g}, plain route {err_p:.4g} "
              f"(bar: kernel <= {BF16_ERR_RATIO} x plain); bf16 routes "
              f"apart {rel_bf16:.4g}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{want} (one per layer per prefill; K4 "
                                 "and K5 through their tensor-core "
                                 "instances)")
        if not (ok_tokens and finite):
            raise AssertionError(f"{name}: tokens {tuple(tokens.shape)} ok "
                                 f"{ok_tokens}, finite logits {finite}")
        if err_k > BF16_ERR_RATIO * err_p or not f32_ok:
            raise AssertionError(f"{name}: prefill logits vs plain routes: "
                                 f"f32 max |err| {f32_err}; bf16 rel L2 "
                                 f"from f32: kernel {err_k}, plain {err_p}")
        if name.startswith("mixtral"):
            rec["profile"] = prefill_profile(torch, M, params, cfg, prompts)
            prof = rec["profile"]
            idle = ("not measured: no device events" if prof["idle"] is None
                    else f"{100 * prof['idle']:.1f}%")
            print(f"[9 {name} profile] warm prefill (no cache handoff) "
                  f"{prof['warm_prefill_s']:.4f} s; one more under "
                  f"torch.profiler: wall {prof['wall_s']:.4f} s, device busy "
                  f"{prof['busy_s']:.4f} s (idle {idle}); device time by "
                  "group: " + ", ".join(f"{k} {v:.4f} s"
                                        for k, v in prof["groups"].items()))
        out[name] = rec
        del params, prompts, tokens, stats, lg
        torch.cuda.empty_cache()
    out["smoke_card_vs_cpu"] = smoke_tokens(torch, generate, M)
    return out


# kernel name patterns of the profile's groups, first match wins
PROFILE_GROUPS = (
    ("K5 swa_attention", ("swa_tc_kernel", "swa_fwd_kernel")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("MoE dispatch (sort, gather, scatter)",
     ("sort", "radix", "scatter", "gather", "index", "cub::")),
    ("casts and copies", ("copy", "cast", "CatArray")),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "norm")),
)


def prefill_profile(torch, M, params, cfg, prompts):
    """One prefill through the kernels (``models.model.prefill``, without
    ``generate``'s cache handoff) timed warm on the host clock, then one
    under ``torch.profiler`` (``profile_window``)."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(params, cfg, {"tokens": prompts})
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        prof = profile_window(
            torch, lambda: M.prefill(params, cfg, {"tokens": prompts}),
            PROFILE_GROUPS)
    return {"warm_prefill_s": warm, **prof}


def profile_window(torch, fn, groups_of):
    """``fn()`` once under ``torch.profiler``: device time by kernel and by
    the kernel-name groups ``groups_of`` (first match wins), the device's
    busy time (union of kernel intervals) and its idle share of the host's
    wall time of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e6
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e6
    groups = {g: 0.0 for g, _ in groups_of}
    groups["other"] = 0.0
    for kname, sec in by_name.items():
        low = kname.lower()
        group = next((g for g, pats in groups_of
                      if any(pt.lower() in low for pt in pats)), "other")
        groups[group] += sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    # the aten ops that launched the device time (self time, not children)
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0) / 1e6)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=lambda kv: -kv[1])[:15]
    return {"wall_s": wall, "busy_s": busy,
            "idle": 1.0 - busy / wall if spans else None,
            "device_events": len(spans), "groups": groups,
            "top_kernels": [{"name": k[:160], "s": v} for k, v in top],
            "top_ops": [{"name": k, "s": v} for k, v in ops if v > 0]}


def _to(tree, device):
    """Every tensor of a tree (dicts, tuples, NamedTuples) on ``device``."""
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda t: t.to(device), tree)


def smoke_tokens(torch, generate, M):
    """The smoke configs of both families through their kernel route, in
    float32: greedy tokens on the card equal those on the CPU (the plain
    versions), with the same params and prompts."""
    from repro_torch.configs import get_smoke_config
    res = {}
    for name, impl in (("mixtral-8x22b", {"attn_impl": "flash"}),
                       ("mamba2-1.3b", {"ssm_impl": "pallas"})):
        cfg = dataclasses.replace(get_smoke_config(name),
                                  compute_dtype="float32", **impl)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        prompts = torch.randint(0, cfg.vocab, (4, 24),
                                generator=torch.Generator().manual_seed(1))
        cpu = generate(cfg, params, prompts, 12)
        card = generate(cfg, _to(params, "cuda"), prompts.cuda(), 12).cpu()
        equal = bool(torch.equal(cpu, card))
        res[name] = {"equal": equal, "tokens": card[0, -12:].tolist()}
        print(f"[9 smoke {name}] greedy tokens card vs CPU (f32, batch 4 x "
              f"24 + 12): equal {equal}")
        if not equal:
            raise AssertionError(f"{name} smoke: greedy tokens differ card "
                                 f"vs CPU: {card.tolist()} vs {cpu.tolist()}")
    return res


# Phase 10. The whole-config HFL run of launch/train.py: mamba2-1.3b, 2
# clusters, 10-bit QuAFL sync every 4 steps, 8 steps of 4 x 1024 tokens a
# cluster, bfloat16 compute over float32 master weights and moments,
# remat "full" (the config's own).
TRAIN_ARGV = ["--arch", "mamba2-1.3b", "--hfl", "--clusters", "2",
              "--sync-every", "4", "--quant-bits", "10", "--steps", "8",
              "--batch", "4", "--seq", "1024", "--warmup", "2",
              "--dtype", "bfloat16", "--log-every", "1"]
# Card against CPU in float32 (TF32 off): the loss and grad norm of one
# step within 1e-4 relative (the CPU parity bar against the JAX package
# is 1e-5 on the loss); at full widths every gradient leaf within 1e-3 in
# relative L2 (4 layers; phase 9's float32 prefill logits sit near 1.5e-4
# from the plain route over 48).
TRAIN_RTOL, TRAIN_GRAD_REL_L2 = 1e-4, 1e-3
FULL_TRAIN_LAYERS, FULL_TRAIN_SEQ = 4, 256
# kernel name patterns of the training profile's groups, first match wins
TRAIN_PROFILE_GROUPS = (
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("scans (cumsum)", ("scan", "cumsum")),
    ("embedding, gather and scatter", ("embedding", "index", "gather",
                                       "scatter")),
    ("reductions (sums, norms, logsumexp)", ("reduce", "softmax", "norm")),
    ("casts and copies (stack, cat)", ("copy", "cast", "CatArray")),
    ("elementwise", ("elementwise",)),
)


def _smoke_batch(torch, cfg, b, seq, seed):
    """A bigram batch of ``cfg``'s vocab on the CPU, plus the stub frames /
    patches its encoder or vision tower reads."""
    from repro_torch.data.tokens import synthetic_lm_batches
    batch = next(synthetic_lm_batches(cfg.vocab, b, seq, 1, seed=seed,
                                      device="cpu"))
    gen = torch.Generator().manual_seed(seed)
    if cfg.encoder is not None:
        batch["frames"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), generator=gen) * 0.02
    if cfg.vision is not None:
        batch["patches"] = torch.randn(
            (b, cfg.vision.n_img_tokens, cfg.vision.d_vision),
            generator=gen) * 0.02
    return batch


def train_phase(torch, reset_counts, read_counts):
    """Phase 10: (a) one float32 train step of each smoke config, card
    against CPU; (b) the gradient of mamba2-1.3b at full widths, depth
    cut to 4, card against CPU; (c) the whole-config HFL run through
    ``repro_torch.launch.train``; (d) a reduced HFL state saved on the
    card and restored on the CPU, and a flipped byte caught."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import (ChecksumError, restore_pytree,
                                        save_pytree)
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.core import hierarchy as H
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import (AdamWConfig, adamw_update,
                                              tree_leaves)
    from repro_torch.train import steps as TS
    out, zero = {}, (0,) * 7

    # (a) the smoke configs: one step, card against CPU
    smoke = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        state = TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        batch = _smoke_batch(torch, cfg, 2, 32, seed=3)
        step = TS.make_train_step(cfg)
        # the step consumes its state: the card's copy is made before
        card_state = _to(state, "cuda")
        _, cpu = step(state, batch)
        reset_counts()
        _, card = step(card_state, _to(batch, "cuda"))
        torch.cuda.synchronize()
        counts = read_counts()
        rel = {k: abs(float(card[k]) - float(cpu[k]))
               / max(abs(float(cpu[k])), 1e-30)
               for k in ("loss", "grad_norm")}
        smoke[arch] = {"loss": float(card["loss"]),
                       "cpu_loss": float(cpu["loss"]), "rel": rel,
                       "launches": list(counts)}
        if max(rel.values()) > TRAIN_RTOL or counts != zero:
            raise AssertionError(f"[10 smoke {arch}] card vs CPU rel "
                                 f"{rel} (bar {TRAIN_RTOL}), launches "
                                 f"{counts}")
    out["smoke_card_vs_cpu"] = smoke
    worst = max(max(r["rel"].values()) for r in smoke.values())
    print(f"[10 train smoke] {len(smoke)} smoke configs, one float32 train "
          f"step (batch 2 x 32) card vs CPU: loss and grad norm within "
          f"{worst:.3g} relative (bar {TRAIN_RTOL}); launches K1-K5 0")

    # (b) mamba2-1.3b at full widths, 4 layers: the gradient card vs CPU
    cfg = dataclasses.replace(get_config("mamba2-1.3b"),
                              n_layers=FULL_TRAIN_LAYERS,
                              compute_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = _smoke_batch(torch, cfg, 1, FULL_TRAIN_SEQ, seed=4)
    t0 = time.perf_counter()
    (cpu_loss, _), cpu_g = TS.value_and_grad(params, cfg, batch)
    cpu_s = time.perf_counter() - t0
    reset_counts()
    (card_loss, _), card_g = TS.value_and_grad(_to(params, "cuda"), cfg,
                                               _to(batch, "cuda"))
    torch.cuda.synchronize()
    counts = read_counts()
    loss_rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_rel = max(float((a.cpu() - b).norm() / b.norm())
                   for a, b in zip(tree_leaves(card_g), tree_leaves(cpu_g)))
    out["full_width_grad"] = {
        "n_layers": cfg.n_layers, "seq": FULL_TRAIN_SEQ,
        "params": sum(t.numel() for t in tree_leaves(params)),
        "loss": float(card_loss), "loss_rel": loss_rel,
        "max_leaf_rel_l2": grad_rel, "cpu_s": cpu_s,
        "launches": list(counts)}
    print(f"[10 train full width] mamba2-1.3b, {cfg.n_layers} layers at "
          f"full widths, one float32 gradient (batch 1 x {FULL_TRAIN_SEQ}) "
          f"card vs CPU: loss {float(card_loss):.6f} rel {loss_rel:.3g} "
          f"(bar {TRAIN_RTOL}), worst leaf rel L2 {grad_rel:.3g} (bar "
          f"{TRAIN_GRAD_REL_L2}); launches K1-K5 0; CPU {cpu_s:.2f} s")
    if loss_rel > TRAIN_RTOL or grad_rel > TRAIN_GRAD_REL_L2 \
            or counts != zero:
        raise AssertionError(f"full-width gradient: loss rel {loss_rel}, "
                             f"leaf rel L2 {grad_rel}, launches {counts}")
    del params, cpu_g, card_g

    # (c) the whole-config HFL run
    args = LT.parse_args(TRAIN_ARGV)
    unequal = []

    def check(i, state, rec):
        if rec["sync_s"] is None:
            return
        for leaf in tree_leaves((state.params, state.opt["m"],
                                 state.opt["v"])):
            if not torch.equal(leaf[0], leaf[1]):
                unequal.append(i)
                return
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cfg, state, hist = LT.train(args, on_step=check)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(np.mean(r["loss"])) for r in hist]
    warm = [r["step_s"] for r in hist[1:]]
    step_s = statistics.median(warm)
    syncs = [r["sync_s"] for r in hist if r["sync_s"] is not None]
    nc, tokens = args.clusters, args.clusters * args.batch * args.seq
    n_params = sum(t[0].numel() for t in tree_leaves(state.params))
    rec = {"argv": TRAIN_ARGV, "params": n_params, "losses": losses,
           "step_s": [r["step_s"] for r in hist],
           "cluster_step_s": step_s / nc, "tokens_per_s": tokens / step_s,
           "sync_s": syncs, "peak_gib": peak, "run_s": run_s,
           "launches": list(counts), "unequal_after_sync": unequal}
    print(f"[10 train hfl] mamba2-1.3b ({n_params / 1e9:.3f} B params), "
          f"{nc} clusters x {args.batch} x {args.seq} tokens, bf16, remat "
          f"{cfg.remat}, 10-bit sync every 4: losses "
          f"{[round(x, 4) for x in losses]}; warm step (median of steps "
          f"1-7) {step_s:.4f} s = {step_s / nc:.4f} s a cluster-step, "
          f"{tokens / step_s:.1f} tokens/s; syncs "
          f"{[round(x, 4) for x in syncs]} s; peak {peak:.2f} GiB; run "
          f"{run_s:.1f} s; clusters bitwise equal after every sync: "
          f"{not unequal}; launches K1-K5 {list(counts)}")
    if not all(np.isfinite(losses)) or \
            np.mean(losses[-2:]) >= losses[0] or unequal or counts != zero \
            or len(syncs) != args.steps // 4:
        raise AssertionError(f"hfl run: losses {losses}, unequal after "
                             f"sync at steps {unequal}, launches {counts}, "
                             f"syncs {syncs}")

    # where a step's time goes: one more tier-1 step under torch.profiler,
    # and one cluster's gradient and AdamW update apart on the host clock
    local = H.make_hfl_local_step(cfg, AdamWConfig(lr=args.lr,
                                                   warmup_steps=2))
    bs = [next(synthetic_lm_batches(cfg.vocab, args.batch, args.seq, 1,
                                    seed=90 + c, device="cuda"))
          for c in range(nc)]
    prof = profile_window(torch, lambda: local(state, bs),
                          TRAIN_PROFILE_GROUPS)
    one = H.cluster_slice(state, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, _), grads = TS.value_and_grad(one.params, cfg, bs[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        adamw_update(AdamWConfig(), one.params, grads, one.opt)
    torch.cuda.synchronize()
    rec.update(profile=prof, grad_s=t1 - t0,
               adamw_s=time.perf_counter() - t1)
    idle = ("not measured: no device events" if prof["idle"] is None
            else f"{100 * prof['idle']:.1f}%")
    print(f"[10 train profile] one tier-1 step ({nc} clusters) under "
          f"torch.profiler: wall {prof['wall_s']:.4f} s, device busy "
          f"{prof['busy_s']:.4f} s (idle {idle}); device time by group: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(
              prof["groups"].items(), key=lambda kv: -kv[1]))
          + f"; one cluster apart: gradient {rec['grad_s']:.4f} s, AdamW "
          f"update {rec['adamw_s']:.4f} s; top ops by device time: "
          + ", ".join(f"{o['name']} {o['s']:.4f} s"
                      for o in prof["top_ops"][:6]))
    out["hfl"] = rec
    del state, grads, one, local
    torch.cuda.empty_cache()

    # (d) the reduced HFL state: saved on the card, restored on the CPU
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              compute_dtype="float32")
    state = H.init_hfl_state(cfg, 2, torch.Generator("cuda").manual_seed(0),
                             device="cuda")
    state, _ = H.make_hfl_local_step(cfg)(state, [
        _to(_smoke_batch(torch, cfg, 2, 32, seed=s), "cuda")
        for s in (5, 6)])
    with tempfile.TemporaryDirectory() as d:
        path = save_pytree(Path(d) / "hfl", state, extra_meta={"steps": 1})
        template = H.abstract_hfl_state(cfg, 2)
        back = restore_pytree(path, template, device="cpu")
        equal = all(torch.equal(a.cpu(), b) for a, b in
                    zip(tree_leaves(state), tree_leaves(back)))
        data = dict(np.load(path, allow_pickle=False))
        key = "params/tok_embed"
        raw = data[key].copy()
        raw.reshape(-1).view(np.uint8)[7] ^= 0x10      # one bit on disk
        data[key] = raw
        np.savez(path, **data)
        try:
            restore_pytree(path, template, device="cpu")
            caught = False
        except ChecksumError:
            caught = True
        leaves = len(tree_leaves(state))
    out["checkpoint"] = {"leaves": leaves, "equal": equal,
                         "flip_caught": caught}
    print(f"[10 train checkpoint] reduced mamba2 HFL state ({leaves} "
          f"leaves, 2 clusters) saved from the card, restored on the CPU: "
          f"bitwise equal {equal}; a flipped bit raises ChecksumError: "
          f"{caught}")
    if not (equal and caught):
        raise AssertionError(f"checkpoint round trip: equal {equal}, flip "
                             f"caught {caught}")
    return out


# Phase 11: the dry run of phase 10's per-cluster step on a one-rank mesh
# against the same step on the card (peak bar: the predicted peak within
# this share of max_memory_allocated), the same for phase 9's two
# kernel-route prefills (K4 and K5 are custom ops: the dry run traces
# them through their fake implementations over meta tensors, in a process
# of its own, and bills each by the reference grid's products; the card
# side launches them, and those launches are the kernels line's
# phase11_launches), and the sharded restore. Phase 12 traces the sharded
# dry runs themselves on this machine's torch (sharded_dryrun_phase).
DRY_ARCH, DRY_SHAPE = "mamba2-1.3b", ("chip_train", 1024, 4, "train")
DRY_PEAK_BAR = 0.10
DRY_TIMEOUT_S = 300

DRY_PREFILL = """
import dataclasses, json
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun as D
cfg = dataclasses.replace(get_config(%(arch)r), compute_dtype="bfloat16",
                          **%(impl)r)
if %(n_layers)d:
    cfg = dataclasses.replace(cfg, n_layers=%(n_layers)d)
rec = D.run_one(%(arch)r, InputShape("chip_prefill", %(plen)d, %(batch)d,
                                     "prefill"), "local", cfg=cfg,
                mesh_shape=(1, 1))
print(json.dumps(rec))
"""

DRY_ONE_RANK = """
import dataclasses, json, sys
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun as D
cfg = dataclasses.replace(get_config(%(arch)r), compute_dtype="bfloat16",
                          remat="full")
rec = D.run_one(%(arch)r, InputShape(*%(shape)r), "local", cfg=cfg,
                mesh_shape=(1, 1))
print(json.dumps(rec))
"""


def _spawn(argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _collect(proc, what):
    try:
        out, err = proc.communicate(timeout=DRY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no result in {DRY_TIMEOUT_S} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}: {err[-3000:]}")
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# Phase 12: the sharded dry run on this machine's torch, on cuda meshes of
# fake ranks (the shards are meta: no card is used), each case in a
# process of its own (a process group is per process), SHARDED_JOBS at
# once, each within DRY_TIMEOUT_S: the small-mesh cases of
# tools/dryrun_small.py (their mesh and a one-rank trace of the same step)
# held to tests/test_torch_dryrun.py's four bars against the JAX package's
# figures committed in tests/dryrun_reference.json, and two production
# cases at full width held to tools/dryrun_compare.py's bars against the
# JAX package's sweep records committed there.
SHARDED_JOBS = 6
SHARDED_PRODUCTION = ("mamba2-1.3b:train_4k:single",
                      "mixtral-8x22b:decode_32k:multi")
SHARDED_ONE = """
import json
from repro_torch.launch import dryrun as D
print(json.dumps(D.run_one(%(arch)r, %(shape)r, %(mesh)r, device=%(device)r)))
"""


def _pooled(jobs, n):
    """Run ``jobs`` ({name: argv}) as processes, ``n`` at once, each within
    DRY_TIMEOUT_S; {name: (stdout, wall seconds)}. A process that fails
    or overruns raises, after every process has ended."""
    todo, running, out, bad = list(jobs), {}, {}, []
    while todo or running:
        while todo and len(running) < n:
            name = todo.pop(0)
            running[name] = (time.perf_counter(), _spawn(jobs[name]))
        time.sleep(0.2)
        for name, (t0, proc) in list(running.items()):
            wall = time.perf_counter() - t0
            if proc.poll() is None and wall < DRY_TIMEOUT_S:
                continue
            del running[name]
            try:
                out[name] = (_collect(proc, name), wall)
            except AssertionError as e:
                bad.append(str(e)[-1500:])
    if bad:
        raise AssertionError("phase 12: " + " | ".join(bad))
    return out


def sharded_dryrun_phase(torch, device="cuda"):
    """Phase 12: the sharded dry run (``repro_torch.launch.dryrun``) on
    this machine's torch, on ``cuda`` meshes of fake ranks: the thirteen
    small-mesh cases of ``tools/dryrun_small.py``, each held to its four
    bars (matmul FLOPs from 1 to 1.2 times a rank's share of the one-rank
    trace run here, at most 1.05 times the reference's dots, peak and link
    bytes at most 1.25 times the reference's), and the production cases
    of SHARDED_PRODUCTION at full width, held to
    ``tools/dryrun_compare.py``'s bars (FLOPs and peak at most 1.25 times
    the reference's, link bytes at most 4 times). The reference's figures
    are the JAX package's, committed in ``tests/dryrun_reference.json``
    (this machine has no JAX). One line a case; every failed case fails
    the phase, after all have run. ``device``: the meshes' device type
    (``cpu`` rehearses the phase on a torch without CUDA)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import dryrun_compare as DC
    import dryrun_small as DS
    yard = json.loads((ROOT / "tests" / "dryrun_reference.json").read_text())
    jobs = {}
    for case in SHARDED_PRODUCTION:          # the longest first
        arch, shape, mesh = case.split(":")
        jobs[case] = [sys.executable, "-c", SHARDED_ONE % {
            "arch": arch, "shape": shape, "mesh": mesh, "device": device}]
    jobs.update({c["id"]: [sys.executable,
                           str(ROOT / "tools" / "dryrun_small.py"),
                           "--device", device, c["id"]] for c in DS.CASES})
    t0 = time.perf_counter()
    done = _pooled(jobs, SHARDED_JOBS)
    out, bad = {"cases": {}}, []
    for name, (text, wall) in done.items():
        rec = json.loads(text.strip().splitlines()[-1])
        if name in DS.BY_ID:
            ratios, fails = DS.bars(rec, yard["small"][name])
            trace_s = [rec[k].get("trace_s") for k in ("mesh", "one")]
        else:
            key = "__".join(name.split(":"))
            fails = [] if rec["status"] == "ok" else [
                f"{rec['status']}: {rec.get('error')}"]
            ratios = DC.ratios(rec, yard["production"][key]) if not fails \
                else {}
            fails += [f"{k} {v:.4f} x the reference's (bar {DC.BARS[k]})"
                      for k, v in ratios.items() if v > DC.BARS[k]]
            trace_s = [rec.get("trace_s")]
        out["cases"][name] = {"ok": not fails, "trace_s": trace_s,
                              "wall_s": wall, "ratios": ratios,
                              "failures": fails}
        print(f"[12 sharded dry run] {name}: "
              f"{'ok' if not fails else 'FAILED'}, trace {trace_s} s "
              f"({wall:.1f} s wall); " + ", ".join(
                  f"{k} {v:.4f}" for k, v in ratios.items())
              + ("; " + "; ".join(fails) if fails else ""), flush=True)
        if fails:
            bad.append(f"{name}: {'; '.join(fails)}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[12 sharded dry run] {len(done)} cases on torch "
          f"{torch.__version__} ({device} meshes) in {out['phase_s']:.1f} s, "
          f"{SHARDED_JOBS} at once; failed {len(bad)}")
    if bad:
        raise AssertionError("phase 12: " + " | ".join(bad))
    return out


def dryrun_phase(torch, reset_counts, read_counts):
    """Phase 11: (a) the dry run (``repro_torch.launch.dryrun``) of
    whole-config mamba2-1.3b's train step on a one-rank mesh (in a process
    of its own: a process group is per process; started first), against
    the same step on the card under the same analyzer: matmul FLOPs equal,
    the predicted peak within DRY_PEAK_BAR of ``max_memory_allocated``;
    the step's seconds (a second run, without the analyzer) beside the
    roofline times; (b) a reduced HFL state saved on the card and restored
    onto a one-rank ``cuda`` DeviceMesh with the HFL placements, every
    local shard bitwise equal to the CPU restore; (c) the one-rank dry
    runs of phase 9's kernel-route prefills (``SERVE_RUNS``: mamba2-1.3b
    through K4, mixtral-8x22b at 2 layers through K5; started first, in
    processes of their own) against the same prefill on the card under
    the analyzer: matmul FLOPs equal (each kernel op billed by the same
    formula on both sides), the peak within DRY_PEAK_BAR, one launch of
    the kernel a layer on the card."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs import InputShape, get_config, get_smoke_config
    from repro_torch.core import hierarchy as H
    from repro_torch.launch import specs as LS
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                         make_local_mesh)
    from repro_torch.launch.op_analysis import OpAnalyzer
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.sharding import named
    from repro_torch.train import steps as ST
    out, zero = {}, (0,) * 7
    t0 = time.perf_counter()
    one_rank = _spawn([sys.executable, "-c", DRY_ONE_RANK % {
        "arch": DRY_ARCH, "shape": DRY_SHAPE}])
    prefills = {name: _spawn([sys.executable, "-c", DRY_PREFILL % {
        "arch": name, "plen": plen, "n_layers": n_layers, "impl": impl,
        "batch": SERVE_BATCH}]) for name, plen, n_layers, impl in SERVE_RUNS}

    # (a) the same step on the card, under the analyzer, then timed
    cfg = dataclasses.replace(get_config(DRY_ARCH),
                              compute_dtype="bfloat16", remat="full")
    shape = InputShape(*DRY_SHAPE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reset_counts()
    state = ST.init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                                device="cuda")
    batch = LS.concrete_inputs(cfg, shape, torch.Generator().manual_seed(1),
                               device="cuda")["batch"]
    step = ST.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    an = OpAnalyzer("cuda")
    an.track(tree_leaves((state, batch)))
    with an:
        new, metrics = step(state, batch)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - base
    loss = float(metrics["loss"])
    del new, metrics
    card = an.stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    new, _ = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    del new, state, batch
    torch.cuda.empty_cache()

    # (b) the sharded restore onto a one-rank cuda mesh
    rcfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                               compute_dtype="float32")
    hstate = H.init_hfl_state(rcfg, 2,
                              torch.Generator("cuda").manual_seed(0),
                              device="cuda")
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, pod=1, device_type="cuda")
        with tempfile.TemporaryDirectory() as d:
            path = save_pytree(Path(d) / "hfl", hstate)
            template = H.abstract_hfl_state(rcfg, 2)
            sharded = restore_pytree(
                path, template, device="cuda", mesh=mesh,
                placements=named(mesh, H.hfl_state_specs(rcfg, mesh)))
            plain = restore_pytree(path, template, device="cpu")
        pairs = list(zip(tree_leaves(sharded), tree_leaves(plain)))
        restore_equal = all(torch.equal(a.to_local().cpu(), b)
                            for a, b in pairs)
        placements = sorted({str(tuple(a.placements)) for a, _ in pairs})
    finally:
        dist.destroy_process_group()
    counts = read_counts()
    del hstate, sharded, plain, pairs

    # (c) the kernel-route prefills on the card against their dry runs
    out["kernel_routes"] = {}
    phase_launches = [0] * 7
    for name, plen, n_layers, impl in SERVE_RUNS:
        rec = kernel_route_prefill(torch, name, plen, n_layers, impl,
                                   prefills[name], reset_counts,
                                   read_counts)
        out["kernel_routes"][name] = rec
        phase_launches = [a + b for a, b in zip(phase_launches,
                                                rec["launches"])]

    dry = json.loads(_collect(one_rank, "one-rank dry run").splitlines()[-1])
    if dry["status"] != "ok":
        raise AssertionError(f"[11 dry run] one-rank dry run: {dry}")
    phase_s = time.perf_counter() - t0

    pred = dry["mem_peak_bytes_per_dev"]
    peak_err = abs(pred - card_peak) / card_peak
    flops_t = card.flops / PEAK_FLOPS_BF16
    bytes_t = card.bytes / HBM_BW
    out["one_rank"] = {
        "arch": DRY_ARCH, "shape": DRY_SHAPE, "dry": dry,
        "card": {"matmul_flops": card.matmul_flops, "flops": card.flops,
                 "bytes": card.bytes, "n_ops": card.n_ops,
                 "analyzer_peak_bytes": card.peak_bytes,
                 "max_memory_allocated_bytes": card_peak,
                 "step_s": step_s, "loss": loss,
                 "roofline_flops_s": flops_t, "roofline_bytes_s": bytes_t},
        "peak_rel_err": peak_err}
    print(f"[11 dry run one rank] {DRY_ARCH} train step, "
          f"{shape.global_batch} x {shape.seq_len} tokens, bf16, remat "
          f"full, float32 AdamW: dry run (1 x 1 fake mesh, "
          f"{dry['trace_s']} s to trace) matmul FLOPs "
          f"{dry['op_matmul_flops_per_dev']:.6e} vs the card's "
          f"{card.matmul_flops:.6e} (equal: "
          f"{dry['op_matmul_flops_per_dev'] == card.matmul_flops}); "
          f"predicted peak {pred / 2 ** 30:.3f} GiB vs max_memory_allocated "
          f"{card_peak / 2 ** 30:.3f} GiB (rel {peak_err:.4f}, bar "
          f"{DRY_PEAK_BAR}; the analyzer on the card "
          f"{card.peak_bytes / 2 ** 30:.3f} GiB); step {step_s:.4f} s vs "
          f"roofline {flops_t:.4f} s (FLOPs {card.flops:.4e} at "
          f"{PEAK_FLOPS_BF16:.3g}/s) and {bytes_t:.4f} s (bytes "
          f"{card.bytes:.4e} at {HBM_BW:.3g} B/s); loss {loss:.4f}")
    out["restore"] = {"leaves": len(tree_leaves(template)),
                      "equal": restore_equal, "placements": placements}
    print(f"[11 dry run restore] reduced mamba2 HFL state "
          f"({len(tree_leaves(template))} leaves, 2 clusters) saved from "
          f"the card, restored onto a one-rank cuda DeviceMesh (pod, data, "
          f"model) with the HFL placements {placements}: every local shard "
          f"bitwise equal to the CPU restore: {restore_equal}; launches "
          f"K1-K5 {list(counts)}; phase {phase_s:.1f} s")
    out["launches"] = list(counts)
    out["phase_launches"] = phase_launches
    out["phase_s"] = phase_s
    if dry["op_matmul_flops_per_dev"] != card.matmul_flops \
            or peak_err > DRY_PEAK_BAR or not restore_equal \
            or counts != zero:
        raise AssertionError(
            f"phase 11: matmul FLOPs {dry['op_matmul_flops_per_dev']} vs "
            f"{card.matmul_flops}, peak rel {peak_err}, restore equal "
            f"{restore_equal}, launches {counts}")
    return out


def kernel_route_prefill(torch, name, plen, n_layers, impl, proc,
                         reset_counts, read_counts):
    """Phase 11 (c): one prefill of ``serve_config(name, n_layers,
    impl)`` (batch SERVE_BATCH x ``plen``, bfloat16) on the card under
    ``OpAnalyzer("cuda")``, launches counted, against the one-rank dry run
    of the same step that ``proc`` prints."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as LS
    from repro_torch.launch.op_analysis import OpAnalyzer
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import steps as ST
    cfg = serve_config(name, n_layers, impl)
    shape = InputShape("chip_prefill", plen, SERVE_BATCH, "prefill")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    batch = LS.concrete_inputs(cfg, shape, torch.Generator().manual_seed(1),
                               device="cuda")["batch"]
    # the dry run's prefill: the step's body under no_grad (in inference
    # mode the analyzer would see matmul and einsum undecomposed)
    step = D._no_grad(ST.make_prefill_step(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    an = OpAnalyzer("cuda")
    an.track(tree_leaves((params, batch)))
    reset_counts()
    t0 = time.perf_counter()
    with an:
        logits, cache = step(params, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = read_counts()
    card_peak = torch.cuda.max_memory_allocated() - base
    finite = bool(torch.isfinite(logits).all())
    del logits, cache, params, batch
    torch.cuda.empty_cache()
    card = an.stats()
    dry = json.loads(_collect(proc, f"{name} prefill dry run"
                              ).splitlines()[-1])
    if dry["status"] != "ok":
        raise AssertionError(f"[11 dry run {name}] {dry}")
    pred = dry["mem_peak_bytes_per_dev"]
    peak_err = abs(pred - card_peak) / card_peak
    k4 = name.startswith("mamba")
    want = ((0, 0, 0, cfg.n_layers, 0, 0, cfg.n_layers) if k4
            else (0, 0, 0, 0, cfg.n_layers, cfg.n_layers, 0))
    rec = {"arch": name, "n_layers": cfg.n_layers, "prompt_len": plen,
           "batch": SERVE_BATCH, **impl, "dry": dry,
           "card": {"matmul_flops": card.matmul_flops, "flops": card.flops,
                    "bytes": card.bytes, "kernel_flops": card.kernel_flops,
                    "kernel_calls": card.kernel_calls,
                    "analyzer_peak_bytes": card.peak_bytes,
                    "max_memory_allocated_bytes": card_peak,
                    "step_s": step_s, "finite": finite},
           "peak_rel_err": peak_err, "launches": list(counts)}
    print(f"[11 dry run {name}] prefill {SERVE_BATCH} x {plen}, "
          f"{cfg.n_layers} layers, bf16, {impl}: dry run (1 x 1 fake mesh, "
          f"{dry['trace_s']} s) matmul FLOPs "
          f"{dry['op_matmul_flops_per_dev']:.6e} vs the card's "
          f"{card.matmul_flops:.6e} (equal: "
          f"{dry['op_matmul_flops_per_dev'] == card.matmul_flops}); kernel "
          f"ops billed {dry['op_kernel_flops_per_dev']} vs "
          f"{card.kernel_flops}; predicted peak {pred / 2 ** 30:.3f} GiB vs "
          f"max_memory_allocated {card_peak / 2 ** 30:.3f} GiB (rel "
          f"{peak_err:.4f}, bar {DRY_PEAK_BAR}); step {step_s:.4f} s under "
          f"the analyzer; launches K1-K5, K5 tensor-core, K4 tensor-core "
          f"{list(counts)}; logits finite {finite}")
    if dry["op_matmul_flops_per_dev"] != card.matmul_flops \
            or dry["op_kernel_flops_per_dev"] != card.kernel_flops \
            or peak_err > DRY_PEAK_BAR or counts != want or not finite:
        raise AssertionError(
            f"phase 11 {name}: matmul FLOPs {dry['op_matmul_flops_per_dev']}"
            f" vs {card.matmul_flops}, kernel ops "
            f"{dry['op_kernel_flops_per_dev']} vs {card.kernel_flops}, peak "
            f"rel {peak_err}, launches {counts} (want {want}), finite "
            f"{finite}")
    return rec


def records_equal(a, b, accuracy=True):
    """Every non-accuracy RoundRecord field equal; accuracy within
    ACC_TOL_EARLY for the first EARLY_ROUNDS rounds, ACC_TOL_LATE after
    (not compared when ``accuracy`` is False)."""
    if len(a) != len(b):
        return False, f"{len(a)} vs {len(b)} rounds"
    for ra, rb in zip(a, b):
        da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
        tol = ACC_TOL_EARLY if ra.round < EARLY_ROUNDS else ACC_TOL_LATE
        for f in da:
            if f == "accuracy":
                if not accuracy:
                    continue
                if abs(da[f] - db[f]) > tol + 1e-12:
                    return False, (f"round {ra.round} accuracy {da[f]} "
                                   f"vs {db[f]}")
            elif da[f] != db[f]:
                return False, f"round {ra.round} {f}: {da[f]} vs {db[f]}"
    return True, ""


# Fault counters that phase 6's faulted runs must each fire in some round.
DEADLINE_S = 2 * 3600.0     # phase 6's round deadline (rounds run 0.5-5 h)
FAULT_COUNTERS = ("dropped_contacts", "corrupted_updates", "deadline_expired",
                  "storm_events", "skipped_low_power")
# the faulted run whose lost updates must reach K2's validity mask
POISONED = "fedavg+trimmed_mean+poison"
# The full-width run: examples/constellation_train.py's AutoFLSat (4 x 10
# satellites, 3 days, EuroSAT) with energy, faults and a deadline; the
# CPU replays its first CPU_ROUNDS rounds.
CPU_ROUNDS = 3
# Round 0 of the full-width run, card against CPU: a cluster model's
# coordinate within rounding noise of a half step snaps to the other
# 10-bit level on one side (a quarter step in the mean of 4 clusters).
# 282-498 of its 1,055,082 coordinates do (tools/full_width_round0.py);
# a wrong leaf or weight would move most of them.
FW_SNAP_SHARE = 1e-3


def faulted_runs(qs):
    """Phase 6's faulted runs at the quickstart configuration, as (tag,
    algorithm, FLConfig overrides, kernel): ``kernel`` is what each
    aggregation launches once ("K1": a quantized cohort; "K2": a robust
    one). In every run each round aggregates (each flush, for FedBuff), so
    a run makes one launch a round. Every engine runs with faults; energy
    is on in four runs (FedBuff's among them); the deadline closes rounds
    under "carry" and "discard" with bounded retries; the poisoned
    trimmed-mean run (POISONED) loses updates to drops (a retry budget of
    one), which reach K2 as zero-weight rows through its validity mask.
    It has one compromised satellite: with two (satellites 2 and 7, no
    retries) the trimmed mean keeps a poisoned row, the model grows
    without bound and is NaN from round 7, in the JAX package as in the
    port (tests/test_torch_optional_engines.py::
    test_two_attackers_diverge_as_in_reference)."""
    from repro_torch.sim.energy import EnergyConfig
    from repro_torch.sim.faults import (EnergyDrainAttack, FaultConfig,
                                        PoisonAttack, StormConfig,
                                        StormEvent)
    K = qs.CLUSTERS * qs.SPC
    storm = StormConfig(events=(StormEvent(6 * 3600.0, 4 * 3600.0, 1, 1.0),),
                        outage_prob=0.5, drop_prob=0.5)
    base = dict(mean_up_s=8 * 3600.0, mean_down_s=1800.0, drop_prob=0.3,
                radiation_rate_per_day=1.0, seed=5)
    # half the fleet starts below the battery floor
    drained = EnergyConfig(battery_capacity_wh=10.0, min_soc=0.4,
                           initial_soc=tuple(1.0 if k % 2 == 0 else 0.1
                                             for k in range(K)))
    return (
        ("fedavg_sch+faults+energy+carry", "fedavg_sch",
         dict(faults=FaultConfig(storms=storm, corrupt_prob=0.05, **base),
              energy=drained, round_deadline_s=DEADLINE_S, quorum=3,
              late_policy="carry", max_retries=3), "K1"),
        ("fedprox_schv2+faults+discard", "fedprox_schv2",
         dict(faults=FaultConfig(**base), round_deadline_s=DEADLINE_S,
              late_policy="discard", max_retries=2), "K1"),
        ("autoflsat+faults+energy", "autoflsat",
         dict(faults=FaultConfig(storms=storm, **base), energy=drained),
         "K1"),
        ("fedavg+trimmed_mean+poison", "fedavg",
         dict(aggregator="trimmed_mean", max_retries=1,
              faults=FaultConfig(poison=PoisonAttack(satellites=(3,),
                                                     scale=3.0),
                                 drop_prob=0.4, seed=5)), "K2"),
        ("fedbuff+median+faults+drain", "fedbuff",
         dict(aggregator="median", energy=EnergyConfig(),
              faults=FaultConfig(attack=EnergyDrainAttack(duty=0.5),
                                 **base)), "K2"),
        ("fedavg_sch+deadline_aware", "fedavg_sch",
         dict(policy="deadline_aware", round_deadline_s=DEADLINE_S,
              faults=FaultConfig(storms=storm, **base)), "K1"),
        ("fedavg+energy_aware", "fedavg",
         dict(policy="energy_aware", energy=drained), "K1"),
        ("fedavg_sch+oracle", "fedavg_sch",
         dict(policy="oracle", faults=FaultConfig(**base)), "K1"),
    )


def full_width_config(rounds=None):
    """``constellation_train``'s experiment with the optional layers on:
    battery energy over a mixed FLyCube / S-band power fleet (a quarter
    of it starting below the floor), faults (outages, resets, contact and
    ISL pair drops, SEU corruption, one storm), a 90-minute deadline with
    quorum and carry, and three retries."""
    from repro_torch import constellation_train
    from repro_torch.sim.energy import EnergyConfig, mixed_fleet
    from repro_torch.sim.faults import FaultConfig, StormConfig, StormEvent
    from repro_torch.sim.hardware import FLYCUBE, SMALLSAT_SBAND
    cfg = constellation_train.sim_config()
    K = cfg.n_clusters * cfg.sats_per_cluster
    fl = dataclasses.replace(
        cfg.fl, max_rounds=rounds or cfg.fl.max_rounds,
        energy=EnergyConfig(
            fleet=mixed_fleet((FLYCUBE, SMALLSAT_SBAND), K),
            battery_capacity_wh=20.0, min_soc=0.3,
            initial_soc=tuple(0.2 if k % 4 == 0 else 0.9 for k in range(K))),
        faults=FaultConfig(
            mean_up_s=12 * 3600.0, mean_down_s=1800.0, drop_prob=0.2,
            corrupt_prob=0.02, radiation_rate_per_day=0.5,
            storms=StormConfig(events=(StormEvent(6 * 3600.0, 3 * 3600.0, 1,
                                                  1.0),),
                               outage_prob=0.5, drop_prob=0.5)),
        round_deadline_s=5400.0, quorum=20, late_policy="carry",
        max_retries=3)
    return dataclasses.replace(cfg, fl=fl)


def full_width_phase(torch, dev, reset_counts, read_counts):
    """``[6 constellation_train]``: the full-width AutoFLSat of
    ``repro_torch.constellation_train`` with energy, faults and a deadline
    (``full_width_config``), every round on the card with one K1 launch a
    round. Then round 0 alone on the card and on the CPU: the records
    equal (accuracy within ACC_TOL_EARLY), the global parameters finite
    and within rtol = atol = 1e-5 but for at most FW_SNAP_SHARE of the
    coordinates, which sit one 10-bit level of a cluster model apart.
    Then the first CPU_ROUNDS rounds on the CPU: their records must equal
    the card's in every non-accuracy field (the global model is at chance
    after round 0 and NaN after round 2, on the card and on the CPU
    alike: SEU-corrupted updates reach the plain mean unfiltered)."""
    from repro_torch import constellation_train
    from repro_torch.sim.flystack import FLySTacK
    from repro_torch.sim.hardware import SMALLSAT_SBAND
    cfg = full_width_config()
    t0 = time.perf_counter()
    sim = FLySTacK(cfg, hw=SMALLSAT_SBAND, device=dev)
    setup_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n1, n2, n3, n4, n5, *_ = read_counts()
    n_rounds = len(res.records)
    summ = res.summary()
    oap, feasible = constellation_train.power_report(res)
    K = cfg.n_clusters * cfg.sats_per_cluster
    print(f"[6 constellation_train] cuda: AutoFLSat, {K} satellites "
          f"({cfg.n_clusters} x {cfg.sats_per_cluster}), {cfg.dataset} x "
          f"{cfg.n_per_client} a client, energy + faults + deadline "
          f"{cfg.fl.round_deadline_s:.0f} s: {n_rounds} rounds in "
          f"{run_s:.3f} s ({run_s / max(n_rounds, 1):.4f} s a round; set-up "
          f"{setup_s:.2f} s); K1 {n1} launches, K2 {n2}; epochs "
          f"{[r.epochs for r in res.records]}; {json.dumps(summ)}; added "
          f"OAP {oap:.0f} mW (feasible {feasible})")
    finite = all(bool(torch.isfinite(p).all())
                 for p in sim.algo.global_params.values())
    acc = [round(r.accuracy, 4) for r in res.records]
    print(f"[6 constellation_train] accuracy per round {acc}; corrupted "
          f"updates per round {[r.corrupted_updates for r in res.records]};"
          f" global model finite after {n_rounds} rounds: {finite}")
    if n_rounds < CPU_ROUNDS or (n1, n2, n3, n4, n5) != (n_rounds, 0, 0, 0,
                                                          0):
        raise AssertionError(
            f"full width: launches K1 {n1}, K2 {n2}, K3 {n3}, K4 {n4}, K5 "
            f"{n5} over {n_rounds} rounds; expected one K1 launch a round")
    # round 0 again, on the card and on the CPU: the global model after it
    one = {}
    for d in (dev, "cpu"):
        s1 = FLySTacK(full_width_config(1), hw=SMALLSAT_SBAND, device=d)
        one[d] = (s1.run().records,
                  {k: v.cpu() for k, v in s1.algo.global_params.items()})
    (rec_card, p_card), (rec_cpu, p_cpu) = one[dev], one["cpu"]
    ok0, why0 = records_equal(res.records[:1], rec_card)
    if ok0:
        ok0, why0 = records_equal(rec_card, rec_cpu)
    coords = sum(p.numel() for p in p_cpu.values())
    snapped = sum(int((~torch.isclose(p_card[k], p_cpu[k], rtol=1e-5,
                                      atol=1e-5)).sum()) for k in p_cpu)
    worst = max(float((p_card[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    step = max(float(p.abs().max()) for p in p_cpu.values()) / 511
    gap0 = round(512 * abs(rec_card[0].accuracy - rec_cpu[0].accuracy))
    finite0 = all(bool(torch.isfinite(p).all())
                  for p in (*p_card.values(), *p_cpu.values()))
    print(f"[6 constellation_train] round 0 alone, card vs CPU: records "
          f"equal {ok0} (accuracy gap {gap0} test samples) {why0}; global "
          f"parameters finite {finite0}, outside rtol=atol=1e-5: {snapped} "
          f"of {coords} "
          f"(bar {FW_SNAP_SHARE:.0e} of them), max |diff| {worst:.3g} = "
          f"{worst / step:.3f} of the largest leaf's 10-bit step")
    if not (ok0 and finite0) or snapped > FW_SNAP_SHARE * coords:
        raise AssertionError(f"full width, round 0: card and CPU differ: "
                             f"{why0}; finite {finite0}; {snapped} "
                             "coordinates outside 1e-5")
    t0 = time.perf_counter()
    cpu_res = FLySTacK(full_width_config(CPU_ROUNDS), hw=SMALLSAT_SBAND,
                       device="cpu").run()
    cpu_s = time.perf_counter() - t0
    ok, why = records_equal(res.records[:CPU_ROUNDS], cpu_res.records,
                            accuracy=False)
    gaps = [round(512 * abs(a.accuracy - b.accuracy))
            for a, b in zip(res.records, cpu_res.records)]
    print(f"[6 constellation_train] cpu run, first {CPU_ROUNDS} rounds in "
          f"{cpu_s:.1f} s (set-up included): non-accuracy fields equal {ok};"
          f" accuracy gap in test samples {gaps} {why}")
    if not ok:
        raise AssertionError(f"full width: card and CPU records differ: "
                             f"{why}")
    return {"rounds": n_rounds, "run_s": run_s,
            "s_per_round": run_s / n_rounds, "setup_s": setup_s,
            "launches": [n1, n2, n3], "summary": summ, "finite": finite,
            "oap_added_mw": float(oap), "power_feasible": bool(feasible),
            "records": [dataclasses.asdict(r) for r in res.records],
            "round0": {"acc_gap_samples": gap0, "finite": finite0,
                       "outside_1e-5": snapped,
                       "coords": coords, "max_abs_diff": worst,
                       "step": step},
            "cpu_rounds": CPU_ROUNDS, "cpu_s": cpu_s, "cpu_equal": ok,
            "acc_gap_samples": gaps}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import quickstart as qs
    from repro_torch.core import aggregation
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_agg as qa
    from repro_torch.kernels import ssd_scan as K4
    from repro_torch.kernels import swa_attention as K5
    from repro_torch.kernels import trimmed_agg as ta
    from repro_torch.orbit.constellation import WalkerStar, satellite_elements
    from repro_torch.orbit.eclipse import eclipse_series
    from repro_torch.orbit.groundstations import gs_ecef
    from repro_torch.orbit.visibility import (elevation_mask_series,
                                              interplane_los_series)
    from repro_torch.sim.flystack import FLySTacK
    from repro_torch.sim.hardware import SMALLSAT_SBAND

    t_start = time.perf_counter()
    report = {}
    reset_counts, read_counts = launch_counters()
    card = gpu_line()
    print(f"[1 device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    qs.full_precision()
    print("[2 precision] allow_tf32 = False for cuda matmul and cudnn "
          "(cuDNN runs float32 convolutions in TF32 by default, which "
          "breaks parity with the CPU); cudnn deterministic = True (the "
          "default heuristics may switch algorithms call to call)")

    t0 = time.perf_counter()
    sources = ["quant_agg", "trimmed_agg", "ssd_scan", "ssd_scan_tc",
               "swa_attention", "swa_attention_tc"]
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
    print(f"[4 kernels] K1 quant_agg_stacked vs plain: {len(rows)} cases "
          f"allclose (rtol=atol=1e-5; the full-width EuroSAT CNN's leaves "
          f"at K=4 and 10 among them; leaf tables of 8 and 40 bitwise equal "
          f"to tables of one), max |err| {max_err:.3g}; one aggregation (8 "
          f"leaves, K=5) eager / CUDA graph: kernel, one table "
          f"{t5['ms']:.4f} / {t5['graph_ms']:.4f} ms, 8 tables of one "
          f"{t5['per_leaf_ms']:.4f} / {t5['per_leaf_graph_ms']:.4f} ms, plain "
          f"{t5['plain_ms']:.4f} / {t5['plain_graph_ms']:.4f} ms, 8 addmv "
          f"{t5['library_ms']:.4f} / {t5['library_graph_ms']:.4f} ms, bound "
          f"{t5['bound_ms']:.5f} ms")
    k2_err, k2_time, k2_rows = k2_phase(torch, ta, aggregation)
    report["k2_rows"], report["k2_timing"] = k2_rows, k2_time
    big = "; ".join(f"K={r['K']} (m={r['m']}) {r['ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ({100 * r['bound_share']:.1f}%)"
                    for r in k2_time["bytebound"])
    print(f"[4 kernels] K2 trimmed_agg_stacked vs plain: {len(k2_rows)} "
          f"cases allclose (rtol=1e-5, atol=1e-6; K up to 100, +inf pads, "
          f"NaN, masked garbage rows; the 8-leaf table bitwise equal to "
          f"tables of one), max |err| {k2_err:.3g}; one robust aggregation "
          f"(_rank_combine, 8 leaves, K=5) eager / CUDA graph: "
          f"{k2_time['ms']:.4f} / {k2_time['graph_ms']:.4f} ms (the table "
          f"call alone {k2_time['kernel_ms']:.4f} / "
          f"{k2_time['kernel_graph_ms']:.4f}), per leaf (8 where + 8 "
          f"launches) {k2_time['per_leaf_ms']:.4f} / "
          f"{k2_time['per_leaf_graph_ms']:.4f} ms, plain "
          f"{k2_time['plain_ms']:.4f} / {k2_time['plain_graph_ms']:.4f} ms, "
          f"sort + matmul {k2_time['library_ms']:.4f} / "
          f"{k2_time['library_graph_ms']:.4f} ms, bound "
          f"{k2_time['bound_ms']:.5f} ms; n=2^24: {big}")
    k3_err, k3_time, k3_rows = k3_phase(torch, qa)
    report["k3_rows"], report["k3_timing"] = k3_rows, k3_time
    print(f"[4 kernels] K3 quant_agg vs plain: {len(k3_rows)} cases "
          f"allclose (rtol=1e-5, atol=1e-6; leaf tables bitwise equal to "
          f"per-leaf calls), max |err| {k3_err:.3g}; one in-place "
          f"aggregation (5 models x 8 leaves) eager / CUDA graph: kernel, 5 "
          f"launches {k3_time['ms']:.4f} / {k3_time['graph_ms']:.4f} ms, "
          f"per leaf (40 launches) {k3_time['per_leaf_ms']:.4f} / "
          f"{k3_time['per_leaf_graph_ms']:.4f} ms, plain "
          f"{k3_time['plain_ms']:.4f} / "
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
    # the eclipse series of the same constellation: dense on the plan's
    # grid, packed on that grid and on the battery engine's (60 s)
    ecl = {d: eclipse_series(c, raan, phase, incl, times, device=d)
           for d in ("cuda", "cpu")}
    ecl_flips = int((ecl["cuda"] != ecl["cpu"]).sum())
    packed_equal = True
    for grid in (times, np.arange(0.0, 2 * 86400, 60.0)):
        pk = {d: eclipse_series(c, raan, phase, incl, grid, packed=True,
                                device=d) for d in ("cuda", "cpu")}
        packed_equal &= pk["cuda"].t0 == pk["cpu"].t0 and all(
            np.array_equal(getattr(pk["cuda"], f), getattr(pk["cpu"], f))
            for f in ("init_eclipsed", "trans_t", "offsets"))
    print(f"[5 eclipse] eclipse samples differing card vs CPU: {ecl_flips} "
          f"of {ecl['cpu'].size} (visibility: {flips} GS, {los_flips} ISL); "
          f"{int(ecl['cpu'].mean() * 1000) / 10}% eclipsed; PackedEclipse "
          f"arrays equal (30 s and 60 s grids): {packed_equal}")
    report["eclipse_flips"] = {"samples": int(ecl["cpu"].size),
                               "flips": ecl_flips,
                               "packed_equal": bool(packed_equal)}
    if not packed_equal:
        raise AssertionError("PackedEclipse arrays differ card vs CPU")

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
              f"K1 launches in {n_rounds} rounds; run {t_alg:.3f} s "
              f"({t_alg / max(n_rounds, 1):.4f} s a round)")
        if not on_card:
            raise AssertionError(f"{alg}: parameters or data not on cuda")
        if n_rounds < 3 or n_launch != n_rounds:
            raise AssertionError(f"{alg}: {n_launch} K1 launches over "
                                 f"{n_rounds} rounds, expected one per "
                                 "round (one table for all 8 leaves)")
        finite = all(bool(torch.isfinite(p).all())
                     for p in sim.algo.global_params.values())
        if not finite:
            raise AssertionError(f"{alg}: non-finite global parameters")
    k1_main, *others = read_counts()
    report["main_path_s"] = time.perf_counter() - t0
    if any(others):
        raise AssertionError(f"phase 5 launched K2-K5 (K5, K4 tensor-core) "
                             f"{others} times; its path runs only K1")

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
        n1, n2, n3, n4, n5, *_ = read_counts()
        k_launch[0] += n1
        k_launch[1] += n2
        n_rounds = len(res.records)
        on_card = all(p.is_cuda for p in sim.algo.global_params.values()) \
            and sim.dataset.x.is_cuda and sim.dataset.y.is_cuda
        finite = all(bool(torch.isfinite(p).all())
                     for p in sim.algo.global_params.values())
        # a quantized FedProx round makes one K1 table for its 8 leaves; a
        # robust round or flush one K2 table for its 8 leaves
        want = {"fedprox_sch": (1, 0), "fedprox_schv2": (1, 0),
                "fedbuff": (0, 0)}.get(tag, (0, 1))
        print(f"[6 {tag}] cuda: {json.dumps(res.summary())}; launches K1 "
              f"{n1}, K2 {n2}, K3 {n3} in {n_rounds} rounds; run "
              f"{t_alg:.3f} s ({t_alg / max(n_rounds, 1):.4f} s a round)")
        if not on_card:
            raise AssertionError(f"{tag}: parameters or data not on cuda")
        if not finite:
            raise AssertionError(f"{tag}: non-finite global parameters")
        if n_rounds < 3 or (n1, n2, n3, n4, n5) != (
                want[0] * n_rounds, want[1] * n_rounds, 0, 0, 0):
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

    # -- phase 6, faulted: faults, storms, energy, deadlines, policies ----
    fault_report, fired = {}, dict.fromkeys(FAULT_COUNTERS, 0)
    for tag, alg, over, kern in faulted_runs(qs):
        cfg = qs.quickstart_config(alg)
        cfg = dataclasses.replace(cfg, fl=dataclasses.replace(cfg.fl,
                                                              **over))
        reset_counts()
        ta.masked_rows = 0
        sim = FLySTacK(cfg, hw=SMALLSAT_SBAND, plan=plan, device=dev)
        t_alg = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        t_alg = time.perf_counter() - t_alg
        n1, n2, n3, n4, n5, *_ = read_counts()
        masked = ta.masked_rows
        k_launch[0] += n1
        k_launch[1] += n2
        n_rounds = len(res.records)
        # every round of these runs aggregates (per flush for FedBuff):
        # one launch of the cohort's kernel a round
        want = (n_rounds, 0) if kern == "K1" else (0, n_rounds)
        summ = res.summary()
        for c in FAULT_COUNTERS:
            fired[c] += int(any(getattr(r, c) > 0 for r in res.records))
        finite = all(bool(torch.isfinite(p).all())
                     for p in sim.algo.global_params.values())
        on_card = all(p.is_cuda for p in sim.algo.global_params.values())
        print(f"[6 {tag}] cuda: {json.dumps(summ)}; launches K1 {n1}, K2 "
              f"{n2}, K3 {n3} in {n_rounds} rounds; K2 rows masked {masked};"
              f" run {t_alg:.3f} s ({t_alg / max(n_rounds, 1):.4f} s a round)")
        if not on_card or not finite:
            raise AssertionError(f"{tag}: parameters off the card ({on_card})"
                                 f" or not finite ({finite})")
        if n_rounds < 3 or (n1, n2, n3, n4, n5) != (*want, 0, 0, 0):
            raise AssertionError(
                f"{tag}: launches K1 {n1}, K2 {n2}, K3 {n3}, K4 {n4}, K5 "
                f"{n5} over {n_rounds} rounds; expected one {kern} launch a "
                "round")
        if tag == POISONED:
            # the cohort's pad rows (fewer selected than clients_per_round)
            # carry weight 0 too: more masked rows than pads means lost
            # updates went through K2's mask
            pads = sum(cfg.fl.clients_per_round - len(r.participants)
                       for r in res.records)
            lost = sum(r.retries_exhausted for r in res.records)
            print(f"[6 {tag}] K2 rows masked {masked}: {pads} pad rows, "
                  f"{lost} updates lost at the retry budget")
            if not (lost > 0 and masked > pads):
                raise AssertionError(f"{tag}: no lost update reached K2's "
                                     f"mask ({masked} rows masked, {pads} "
                                     f"pads, {lost} lost)")
        cpu_res = FLySTacK(cfg, hw=SMALLSAT_SBAND, plan=plan,
                           device="cpu").run()
        ok, why = records_equal(res.records, cpu_res.records)
        gaps = [round(512 * abs(a.accuracy - b.accuracy))
                for a, b in zip(res.records, cpu_res.records)]
        print(f"[6 {tag}] cpu run: records equal {ok}; accuracy gap per "
              f"round in test samples {gaps} {why}")
        if not ok:
            raise AssertionError(f"{tag}: card and CPU records differ: {why}")
        fault_report[tag] = {"rounds": n_rounds, "launches": [n1, n2, n3],
                             "masked_rows": masked, "run_s": t_alg,
                             "s_per_round": t_alg / n_rounds,
                             "summary": summ, "cpu_equal": ok,
                             "acc_gap_samples": gaps}
    report["faulted"] = fault_report
    print(f"[6 faults] rounds with each counter > 0, by run: {fired}")
    if not all(fired.values()):
        raise AssertionError(f"a fault counter never fired: {fired}")

    # -- phase 6, full width: constellation_train with the optional layers
    report["full_width"] = full_width_phase(torch, dev, reset_counts,
                                            read_counts)
    k_launch[0] += report["full_width"]["launches"][0]

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
    qs_, ss_ = zip(*(quantize_pytree(m, 10) for m in cohort))
    reset_counts()
    inplace = quantized_inplace_aggregate(list(qs_), list(ss_), weights)
    torch.cuda.synchronize()
    n1, n2, n3, n4, n5, *_ = read_counts()
    # the same aggregation as a per-leaf K3 stream (the per-leaf path)
    tot = sum(weights)
    stream = {k: torch.zeros(v.shape, device="cuda") for k, v in base.items()}
    for qm, sm, w in zip(qs_, ss_, weights):
        stream = {k: qa.quant_agg(a, qm[k], sm[k], w / tot)
                  for k, a in stream.items()}
    bitwise = all(bool(torch.equal(inplace[k], stream[k])) for k in base)
    k1_ref = quantized_weighted_average(stacked, np.asarray(weights), 10)
    torch.cuda.synchronize()
    errs = {k: float((inplace[k] - k1_ref[k]).abs().max()) for k in base}
    close = all(torch.allclose(inplace[k], k1_ref[k], rtol=1e-5, atol=1e-6)
                for k in base)
    print(f"[7 in-place] 10-bit cohort of 5 CNN models: K3 {n3} launches "
          f"(K1 {n1}, K2 {n2}); bitwise equal to the per-leaf K3 stream "
          f"{bitwise}; allclose to K1's aggregate (rtol=1e-5, atol=1e-6) "
          f"{close}, max |err| {max(errs.values()):.3g}")
    if (n1, n2, n3, n4, n5) != (0, 0, len(cohort), 0, 0) or not close \
            or not bitwise:
        raise AssertionError(f"in-place aggregation: launches K1 {n1}, K2 "
                             f"{n2}, K3 {n3} (want one per model); bitwise "
                             f"{bitwise}; allclose {close}; {errs}")
    report["inplace"] = {"launches": n3, "bitwise_per_leaf": bitwise,
                         "max_abs_err": errs}
    k3_main = n3

    # -- phase 8: the LM kernels against their plain versions ------------
    k4_err, k4_time, k4_rows = k4_phase(torch, K4)
    report["k4_rows"], report["k4_timing"] = k4_rows, k4_time
    full = next(r for r in k4_rows if r["shape"] == K4_FULL)
    print(f"[8 kernels] K4 ssd_chunk vs plain: {len(k4_rows)} shapes "
          f"allclose (rtol=atol=2e-4), max |err| {k4_err:.3g}; instances "
          f"{[r['instance'] for r in k4_rows]}; at the mamba2-1.3b prefill "
          f"shape {K4_FULL} (b,nc,c,h,p,g,n): max |err| "
          f"{full['max_abs_err']:.3g}, the CUDA-core instance on the same "
          f"inputs {full['cuda_core_max_abs_err']:.3g}, |y| up to "
          f"{full['y_abs_max']:.3g}; eager / CUDA graph: "
          f"tensor-core instance {k4_time['ms']:.4f} / "
          f"{k4_time['graph_ms']:.4f} ms ({k4_time['tflops']:.1f} TFLOP/s "
          f"of float32 work), CUDA-core instance "
          f"{k4_time['cuda_core_ms']:.4f} ms, plain "
          f"{k4_time['plain_ms']:.4f} / {k4_time['plain_graph_ms']:.4f} ms; "
          f"bounds: split TF32 (3 x {k4_time['ops'] / 1e9:.2f} GFLOP at 495 "
          f"TFLOP/s) {k4_time['bound_ms']:.4f} ms "
          f"({100 * k4_time['bound_share']:.1f}% of it), float32 CUDA cores "
          f"{k4_time['fp32_bound_ms']:.4f} ms "
          f"({100 * k4_time['fp32_bound_share']:.1f}%), bytes "
          f"{k4_time['bytes_ms']:.4f} ms; ptxas ssd_scan_tc: "
          f"{ptxas_summary(report['ptxas']['ssd_scan_tc'])}; no single "
          "library call computes it")
    k5_err, k5_time, k5_rows = k5_phase(torch, K5)
    report["k5_rows"], report["k5_timing"] = k5_rows, k5_time
    print(f"[8 kernels] K5 swa_attention vs plain: {len(k5_rows)} cases "
          f"allclose (f32 2e-5, bf16 2e-2), max |err| f32 "
          f"{k5_err['float32']:.3g}, bf16 {k5_err['bfloat16']:.3g}, bf16 "
          f"relative L2 at most "
          f"{max(r['rel_l2'] for r in k5_rows if r['dtype'] == 'bfloat16'):.3g}"
          f" (bar {K5_BF16_REL_L2}; full shape "
          f"{k5_rows[-1]['rel_l2']:.3g}); at the "
          f"mixtral-8x22b prefill shape {K5_FULL} (B,L,H,KH,hd,window), "
          f"bf16 tensor-core instance: {k5_time['ms']:.3f} / graph "
          f"{k5_time['graph_ms']:.3f} ms ({k5_time['tflops']:.1f} TFLOP/s, "
          f"{100 * k5_time['bound_share']:.1f}% of the bound), f32 CUDA-core "
          f"instance "
          f"{k5_time['float32_ms']:.3f} ms, plain (32 slices) "
          f"{k5_time['plain_ms']:.3f} ms, scaled_dot_product_attention "
          f"{k5_time['library_ms']:.3f} ms, bound {k5_time['bound_ms']:.4f}"
          f" ms ({k5_time['bound_by']}; {k5_time['pairs'] / 1e9:.3f} G "
          f"visible pairs; {k5_time['fp32_core_ms']:.2f} ms at the f32 "
          "CUDA-core rate)")

    # -- phase 9: LM serving at full width through K4 and K5 -------------
    t0 = time.perf_counter()
    report["serve"] = serve_phase(torch, reset_counts, read_counts)
    report["serve_s"] = time.perf_counter() - t0

    # -- phase 10: LM training and the hierarchical trainer --------------
    t0 = time.perf_counter()
    report["train"] = train_phase(torch, reset_counts, read_counts)
    report["train_s"] = time.perf_counter() - t0
    # -- phase 11: the dry run against the card, the sharded restore ---
    t0 = time.perf_counter()
    report["dryrun"] = dryrun_phase(torch, reset_counts, read_counts)
    report["dryrun_s"] = time.perf_counter() - t0
    # -- phase 12: the sharded dry run on this machine's torch ----------
    t0 = time.perf_counter()
    report["sharded_dryrun"] = sharded_dryrun_phase(torch)
    report["sharded_dryrun_s"] = time.perf_counter() - t0
    dry_launches = report["dryrun"]["phase_launches"]
    train_launches = report["train"]["hfl"]["launches"]
    k4_main = report["serve"]["mamba2-1.3b"]["launches"][3]
    k4_tc_main = report["serve"]["mamba2-1.3b"]["launches"][6]
    k5_main = report["serve"]["mixtral-8x22b"]["launches"][5]

    kernels = [{
        "name": "quant_agg_stacked",
        "train_launches": train_launches[0],
        "phase11_launches": dry_launches[0],
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
        "per_leaf_ms": timing[5]["per_leaf_ms"],
        "per_leaf_graph_ms": timing[5]["per_leaf_graph_ms"],
        "library": "torch.addmv (8 calls)",
        "shape": "one aggregation: 8 CNN leaves (213,630 values), K=5, one "
                 "table launch (per_leaf: 8 tables of one)",
    }, {
        "name": "trimmed_agg_stacked",
        "train_launches": train_launches[1],
        "phase11_launches": dry_launches[1],
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trimmed_agg.cu",
        "replaces": "src/repro/kernels/trimmed_agg.py:79",
        "launches": k_launch[1],
        "max_abs_err": k2_err,
        "ms": k2_time["ms"],
        "kernel_ms": k2_time["kernel_ms"],
        "plain_ms": k2_time["plain_ms"],
        "bound_ms": k2_time["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k2_time["library_ms"],
        "graph_ms": k2_time["graph_ms"],
        "kernel_graph_ms": k2_time["kernel_graph_ms"],
        "plain_graph_ms": k2_time["plain_graph_ms"],
        "library_graph_ms": k2_time["library_graph_ms"],
        "per_leaf_ms": k2_time["per_leaf_ms"],
        "per_leaf_graph_ms": k2_time["per_leaf_graph_ms"],
        "bytebound": k2_time["bytebound"],
        "library": "torch.sort then rw @ sorted (two calls a leaf)",
        "shape": "one robust aggregation (_rank_combine): 8 CNN leaves "
                 "(213,630 values), K=5, trimmed mean, one table launch "
                 "(per_leaf: 8 where + 8 tables of one; bytebound: one "
                 "leaf of n=2^24 at K=10 and 32, pads masked)",
    }, {
        "name": "quant_agg",
        "train_launches": train_launches[2],
        "phase11_launches": dry_launches[2],
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
        "per_leaf_ms": k3_time["per_leaf_ms"],
        "per_leaf_graph_ms": k3_time["per_leaf_graph_ms"],
        "shape": "one in-place aggregation: 5 models x 8 CNN leaves, one "
                 "launch per model (library: 40 calls)",
    }, {
        "name": "ssd_chunk",
        "train_launches": train_launches[3],
        "phase11_launches": dry_launches[3],
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
        "cuda_core_source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:51",
        "launches": k4_main,
        "tc_launches": k4_tc_main,
        "max_abs_err": k4_err,
        "ms": k4_time["ms"],
        "kernel_ms": k4_time["ms"],
        "plain_ms": k4_time["plain_ms"],
        "bound_ms": k4_time["bound_ms"],
        "bound_by": k4_time["bound_by"],
        "library_ms": None,
        "graph_ms": k4_time["graph_ms"],
        "plain_graph_ms": k4_time["plain_graph_ms"],
        "cuda_core_ms": k4_time["cuda_core_ms"],
        "fp32_bound_ms": k4_time["fp32_bound_ms"],
        "bound_share": k4_time["bound_share"],
        "library": None,
        "shape": "mamba2-1.3b prefill, one layer: (b,nc,c,h,p,g,n) = "
                 f"{K4_FULL}, float32, tensor-core instance (3xTF32; "
                 "bound_ms at 495 TFLOP/s TF32 for 3x the operations, "
                 "fp32_bound_ms at 67 TFLOP/s float32; cuda_core_ms: the "
                 "CUDA-core instance)",
    }, {
        "name": "swa_attention",
        "train_launches": train_launches[4],
        "phase11_launches": dry_launches[4],
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention_tc.cu",
        "cuda_core_source": "src/repro_torch/kernels/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention.py:79",
        "launches": k5_main,
        "max_abs_err": max(k5_err.values()),
        "ms": k5_time["ms"],
        "kernel_ms": k5_time["ms"],
        "plain_ms": k5_time["plain_ms"],
        "bound_ms": k5_time["bound_ms"],
        "bound_by": k5_time["bound_by"],
        "library_ms": k5_time["library_ms"],
        "graph_ms": k5_time["graph_ms"],
        "float32_ms": k5_time["float32_ms"],
        "tflops": k5_time["tflops"],
        "bound_share": k5_time["bound_share"],
        "library": "F.scaled_dot_product_attention, band mask, "
                   "memory-efficient backend, " + k5_time["library_how"],
        "shape": "mixtral-8x22b prefill, one layer: (B,L,H,KH,hd,window) "
                 f"= {K5_FULL}, bfloat16, tensor-core instance "
                 "(float32_ms: the CUDA-core instance in float32)",
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
