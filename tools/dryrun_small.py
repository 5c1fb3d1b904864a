#!/usr/bin/env python3
"""The dry run's small-mesh cases, the port's side of them.

    python3 tools/dryrun_small.py [--device cpu|cuda] [--ops] CASE_ID

Sixteen smoke-config steps on 8 fake ranks, each the size at which one
fault of the production sweep showed (``CASES``; the first three are the
JAX package's own, ``tests/test_dryrun_small.py``). For one case this
traces the step on its mesh and on one rank (``repro_torch.launch.
dryrun.run_one``, the shards ``meta``) and prints one JSON line,
``{"mesh": record, "one": record}``. ``tests/test_torch_dryrun.py``
(on a ``cpu`` mesh) and ``chip_smoke.py`` phase 12 (on a ``cuda`` one)
run each case in a process of its own (a process group is per process)
and hold it to ``bars``: the reference's figures are computed by the
test and kept for the card in ``tests/dryrun_reference.json``.

``record_ops`` records each op that reaches DTensor's sharding
propagator, which ``tests/test_torch_dryrun_ops.py`` holds against the
ops the card machine's torch has rules for.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _case(arch, kind, mesh=(4, 2), seq=128, batch=8, over=None, id=None,
          share=None):
    """A case: ``over`` replaces fields of the smoke config (``moe``: a
    dict of fields of its ``MoEConfig``); ``share="reference"``: a rank's
    matmul FLOPs are held to at most the reference's dots' multiple of
    the share (``share_bar``), not ``SHARE``, where the reference's own
    program repeats work (the reason beside the case)."""
    case = {"id": id or f"{arch}-{kind}", "arch": arch, "kind": kind,
            "mesh": tuple(mesh), "seq": seq, "batch": batch,
            "over": over or {}}
    if share is not None:
        case["share"] = share
    if case["over"].get("attn_impl") == "flash":
        # a rank's K5 FLOPs over its share of the one-rank trace's: its
        # ceil(h / m) query heads over h / m, as XLA pads the heads
        h, m = case["over"]["n_heads"], mesh[-1]
        case["k5_share"] = -(-h // m) / (h / m)
    return case


CASES = (
    _case("qwen3-14b", "train"),
    _case("mixtral-8x22b", "decode"),
    _case("mamba2-1.3b", "decode"),
    # a cache long enough to dominate the step: its write moved the whole
    # cache (1.296x the share, 13.3x the reference's link bytes)
    _case("phi-3-vision-4.2b", "decode", seq=2048,
          id="phi-3-vision-4.2b-decode-long-cache"),
    # a vocab that model does not divide: the lm head ran whole on each
    # model rank (1.565x the share, peak 1.757x, link bytes 1.760x)
    _case("mamba2-1.3b", "decode", over={"vocab": 4097},
          id="mamba2-1.3b-decode-vocab-4097"),
    # the port's own buffers, which the reference donates or never holds:
    # each SSM layer's conv tail a view of its whole xbc, kept in the
    # prefill cache (peak 1.795x the reference's)
    _case("mamba2-1.3b", "prefill", seq=512, over={"n_layers": 24},
          id="mamba2-1.3b-prefill-24-layers"),
    # the decode cache restacked beside the one given (1.356x)
    _case("mamba2-1.3b", "decode", batch=64, over={"n_layers": 32},
          id="mamba2-1.3b-decode-64-rows-32-layers"),
    # AdamW's new params and moments as whole trees beside the state
    # (1.561x)
    _case("mixtral-8x22b", "train", seq=16, id="mixtral-8x22b-train-seq-16"),
    # a train step on the (pod, data, model) mesh: DTensor's planner took
    # over 15 minutes here while the strided query shard of the scores'
    # gradient was gathered
    _case("qwen2-72b", "train", mesh=(2, 2, 2), seq=64,
          id="qwen2-72b-train-multi-pod"),
    # one sequence and a 2048-slot cache, as at long_500k: the cache's
    # sequence on data, which cannot split the batch
    *[_case(arch, "decode", seq=2048, batch=1,
            id=f"{arch}-decode-one-sequence")
      for arch in ("qwen3-14b", "mamba2-1.3b", "jamba-v0.1-52b",
                   "mixtral-8x22b")],
    # K5 where model divides neither head count, at the ratio of qwen3-14b
    # (40 heads of 8) and whisper-small (12 of 12) on 16 ranks: each rank
    # ran K5 on all the heads (4.0x its share of K5; the 6 heads' view
    # after K5 did not trace); two sequences a data rank, which model
    # cannot split
    _case("qwen3-14b", "prefill", mesh=(2, 4), batch=4,
          over={"n_heads": 10, "n_kv_heads": 2, "attn_impl": "flash"},
          id="qwen3-14b-prefill-flash-10-of-2-heads"),
    _case("whisper-small", "prefill", mesh=(2, 4), batch=4,
          over={"n_heads": 6, "n_kv_heads": 6, "attn_impl": "flash"},
          id="whisper-small-prefill-flash-6-of-6-heads"),
    # a MoE train step on the (pod, data, model) mesh with experts that
    # model does not divide (mixtral-8x22b's 8 on 16 ranks): the gradient
    # of the experts' hidden layer, its d_model contraction on data, was
    # split over model along that contraction too, each rank holding the
    # whole (experts, capacity, d_ff) product partial over both and
    # reducing it (link 1.294x; mixtral-8x22b's train_4k on the multi-pod
    # mesh: 8.59e10 B a rank, peak 1.239x). The reference repeats the
    # experts' products on each pod as the port does (its dots are 1.85x
    # a rank's share of the one-rank trace): the port is held to that
    _case("mixtral-8x22b", "train", mesh=(2, 2, 2), batch=4,
          over={"moe": {"n_experts": 3}}, share="reference",
          id="mixtral-8x22b-train-multi-pod-3-experts"),
)
BY_ID = {c["id"]: c for c in CASES}

# the bars of a small-mesh case: a rank's matmul FLOPs from 1 to SHARE
# times its share of the one-rank trace, at most DOTS times the
# reference's HLO dots; peak and link bytes at most PEAK and LINK times
# the reference's; a flash case's K5 FLOPs its case's ``k5_share`` times
# its share
SHARE, DOTS, PEAK, LINK = 1.2, 1.05, 1.25, 1.25
K5 = "repro_torch::swa_attention"


def run_case(case, device="cpu"):
    """``{"mesh": record, "one": record}`` of ``case`` traced on its mesh
    and on one rank, in this process (each trace joins and leaves a fake
    process group of its own size)."""
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.launch import dryrun as D
    over = dict(case["over"])
    moe = over.pop("moe", None)
    cfg = dataclasses.replace(get_smoke_config(case["arch"]), **over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    shape = InputShape("t", case["seq"], case["batch"], case["kind"])
    out = {}
    for name, mesh in (("mesh", tuple(case["mesh"])),
                       ("one", (1,) * len(case["mesh"]))):
        rec = D.run_one(case["arch"], shape, "local", cfg=cfg,
                        mesh_shape=mesh, device=device)
        out[name] = rec
    return out


def share_bar(case, ref, port):
    """The bar on a rank's matmul FLOPs over its share of the one-rank
    trace: ``SHARE``, or for a case whose ``share`` is "reference" the
    reference's dots over the same share."""
    if (case or {}).get("share") != "reference":
        return SHARE
    return ref["dot_flops"] * port["mesh"]["n_devices"] \
        / port["one"]["op_matmul_flops_per_dev"]


def k5_share(port):
    """A rank's K5 FLOPs over its share of the one-rank trace's (None
    where the step runs no K5)."""
    r, one = port["mesh"], port["one"]
    total = one.get("op_kernel_flops_per_dev", {}).get(K5)
    if not total:
        return None
    return r["op_kernel_flops_per_dev"].get(K5, 0.0) * r["n_devices"] / total


def bars(port, ref, case=None):
    """``(ratios, failures)`` of a case's port records (``run_case``)
    against the reference's figures (``dot_flops``, ``peak``, ``link``):
    ``ratios`` holds share, dots, peak and link as multiples (and ``k5``,
    K5's share, for a flash ``case``); a failure names the bar it
    breaks."""
    r, one = port["mesh"], port["one"]
    bad = [f"{k} trace: {v.get('error')}" for k, v in
           (("mesh", r), ("one rank", one)) if v.get("status") != "ok"]
    if bad:
        return {}, bad
    share = one["op_matmul_flops_per_dev"] / r["n_devices"]
    mm = r["op_matmul_flops_per_dev"]
    ratios = {"share": mm / share, "dots": mm / ref["dot_flops"],
              "peak": r["mem_peak_bytes_per_dev"] / ref["peak"],
              "link": r["collective_link_bytes_per_dev"] / ref["link"]}
    bar = share_bar(case, ref, port)
    if not 1 <= ratios["share"] <= bar:
        bad.append(f"matmul FLOPs {ratios['share']:.4f} x the share "
                   f"(bar {bar:.4f})")
    for k, bar in (("dots", DOTS), ("peak", PEAK), ("link", LINK)):
        if ratios[k] > bar:
            bad.append(f"{k} {ratios[k]:.4f} x the reference's (bar {bar})")
    if case is not None and "k5_share" in case:
        ratios["k5"] = k5_share(port) or 0.0
        if abs(ratios["k5"] - case["k5_share"]) > 1e-9 * case["k5_share"]:
            bad.append(f"K5 {ratios['k5']:.4f} x the share (want "
                       f"{case['k5_share']:.4f})")
    return ratios, bad


def spawn(case_id, device="cpu", env=None, ops=False):
    """A process that runs ``case_id`` and prints its JSON line."""
    env = dict(env or os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "dryrun_small.py"), "--device",
         device, case_id] + (["--ops"] if ops else []), cwd=ROOT, env=env,
        text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def ops_with_rules(propagator):
    """The ops ``propagator`` (DTensor's ``ShardingPropagator``) has a
    rule or strategy for, by name, from whichever of its registries this
    torch has."""
    names = set()
    for reg in ("op_strategy_funcs", "op_to_rules",
                "op_single_dim_strategy_funcs"):
        names.update(str(op) for op in getattr(propagator, reg, {}))
    return names


@contextlib.contextmanager
def record_ops(seen):
    """Add to the set ``seen`` the name of each op that reaches DTensor's
    sharding propagator while the context is open (an op's first schema
    of each placement passes through it; later ones may be served from a
    cache)."""
    from torch.distributed.tensor import DTensor
    sp = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in ("propagate_op_sharding",
                         "propagate_op_sharding_non_cached")
             if hasattr(sp, n)]
    before = {n: sp.__dict__.get(n) for n in names}

    def recording(fn):
        def call(op_schema, *a, **k):
            seen.add(str(op_schema.op))
            return fn(op_schema, *a, **k)
        return call
    for n in names:
        setattr(sp, n, recording(getattr(sp, n)))
    try:
        yield seen
    finally:
        for n, fn in before.items():
            if fn is None:
                delattr(sp, n)
            else:
                setattr(sp, n, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=sorted(BY_ID))
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--ops", action="store_true",
                    help="add the ops that reached DTensor's sharding "
                         "propagator (record_ops) under \"ops\"")
    args = ap.parse_args(argv)
    seen = set()
    with record_ops(seen) if args.ops else contextlib.nullcontext():
        out = run_case(BY_ID[args.case], args.device)
    if args.ops:
        out["ops"] = sorted(seen)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
