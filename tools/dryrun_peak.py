#!/usr/bin/env python3
"""What one dry run holds at its peak, by the op that made each storage.

    PYTHONPATH=src python3 tools/dryrun_peak.py --arch qwen2-72b \\
        --kind train --seq 4096 --batch 256 --mesh 2,16,16 --set n_layers=1
    PYTHONPATH=src python3 tools/dryrun_peak.py --arch mamba2-1.3b \\
        --kind prefill --seq 1024 --batch 4 --mesh 1,1 \\
        --set compute_dtype=bfloat16 --set ssm_impl=pallas

Traces one step as ``launch.dryrun.run_one`` does (a fake process group
of the mesh's size, DTensors over meta shards on a ``cpu`` mesh
(``--device cuda``: a ``cuda`` one), the full
config of ``--arch``, or its smoke config with ``--smoke``, with ``--set``
overrides), and prints the record's per-rank peak, FLOPs and link bytes,
then the storages live at the peak, largest first, each with the local op
that made it, its shapes and dtype, and the DTensor op it ran under with
that op's input placements; then the same storages summed by op. With
``--ops`` it also prints every DTensor op as it is dispatched, with its
inputs' and output's global shapes and placements (the backward's too),
which is where two meshes' programs can be compared line by line. A
one-rank mesh (``--mesh 1,1``) traces plain meta tensors: the prediction
``chip_smoke.py`` phase 11 holds against the card. Nothing here runs a
kernel or needs a card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys


def _placed(t):
    from torch.distributed.tensor import DTensor
    import torch
    if isinstance(t, DTensor):
        pl = "".join(str(p) for p in t.placements)
        return f"{tuple(t.shape)}{pl}".replace("Shard(dim=", "S(").replace(
            "Replicate()", "R").replace("Partial(sum)", "P")
    if isinstance(t, torch.Tensor):
        return f"plain{tuple(t.shape)}"
    if isinstance(t, (list, tuple)):
        return "[" + ",".join(_placed(x) for x in t) + "]"
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--kind", default="train",
                    choices=["train", "prefill", "decode"])
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--mesh", required=True,
                    help="data,model or pod,data,model")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="a config field, key=value (int where it parses)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="the mesh's device type (a torch with CUDA traces "
                         "cuda meshes, as chip_smoke.py phase 12 does)")
    args = ap.parse_args(argv)

    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import InputShape, get_config, get_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import op_analysis as OA

    over = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        over[k] = int(v) if v.lstrip("-").isdigit() else v
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, **over)
    state = {"dtensor_op": None, "n": 0, "an": None}

    class Peak(OA.OpAnalyzer):
        """The analyzer, keeping what made each storage and the live set
        each time the peak rises."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.made = {}
            self.at_peak = []
            self._op = None
            state["an"] = self

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                state["dtensor_op"] = (func._opname, " ".join(
                    _placed(a) for a in args
                    if isinstance(a, (torch.Tensor, list, tuple))))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _account(self, func, args, outs):
            self._op = (f"{func.namespace}.{func._opname}",
                        [tuple(t.shape) for t in outs][:2],
                        str(outs[0].dtype).replace("torch.", ""),
                        state["dtensor_op"])
            super()._account(func, args, outs)

        def _add(self, t, own=False):
            key = id(t.untyped_storage())
            if key not in self._live:
                self.made[key] = self._op or (
                    "argument", [tuple(t.shape)],
                    str(t.dtype).replace("torch.", ""), None)
            before = self.peak
            super()._add(t, own)
            if self.peak > before:
                self.at_peak = [(n, self.made.get(k))
                                for k, (_, n) in self._live.items()]

    class Logged(D.PartitionerPlacements):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if any(issubclass(t, DTensor) for t in types):
                state["n"] += 1
                ins = " ".join(_placed(a) for a in args
                               if isinstance(a, (torch.Tensor, list, tuple)))
                print(f"{state['n']:6d} {func._opname:28s} {ins} -> "
                      f"{_placed(out)}", flush=True)
            return out

    D.OpAnalyzer = Peak
    if args.ops:
        D.PartitionerPlacements = Logged
    mesh = tuple(int(x) for x in args.mesh.split(","))
    rec = D.run_one(args.arch, InputShape("peak", args.seq, args.batch,
                                          args.kind), "local", cfg=cfg,
                    mesh_shape=mesh, device=args.device)
    if rec["status"] != "ok":
        print(rec.get("traceback", rec.get("error", "")), file=sys.stderr)
        return 1
    print(f"{args.arch} {args.kind} {args.batch} x {args.seq} on {mesh}: "
          f"peak {rec['mem_peak_bytes_per_dev']:.4g} B, matmul FLOPs "
          f"{rec['op_matmul_flops_per_dev']:.4g}, link "
          f"{rec['collective_link_bytes_per_dev']:.4g} B, trace "
          f"{rec['trace_s']} s (a rank; this host's CPU)")
    rows = sorted(state["an"].at_peak, key=lambda r: -r[0])
    total = sum(n for n, _ in rows) or 1
    by_op = collections.defaultdict(lambda: [0, 0])
    for n, made in rows:
        by_op[made[0] if made else "?"][0] += n
        by_op[made[0] if made else "?"][1] += 1
    for n, made in rows[:args.top]:
        print(f"{n:.3e} {100 * n / total:5.1f}% {made}")
    print("by op:")
    for op, (n, c) in sorted(by_op.items(), key=lambda kv: -kv[1][0]):
        print(f"  {op:48s} {n:.3e} {100 * n / total:5.1f}% x{c}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
