#!/usr/bin/env python3
"""What this machine's torch offers the sharded dry run, and where it
refuses it.

    python3 tools/dryrun_probe.py [--device cuda|cpu] [--jobs N]
        [--timeout S] [--go-on] [--out FILE] [CASE ...]

Prints ``torch.__version__``, the size of each registry of DTensor's
sharding propagator (``op_strategy_funcs``, ``op_to_rules``,
``op_single_dim_strategy_funcs``, those this torch has) and whether
``placement_types._StridedShard`` exists, then traces each CASE in a
process of its own (a process group is per process), several at once,
on a mesh of ``--device`` (default ``cuda``: the shards are meta, so no
card is used). A CASE is a small-mesh case of ``tools/dryrun_small.py``
(its id; ``small`` for all thirteen, each also on one rank), a
production case ``ARCH:SHAPE:MESH``, ``production`` (mamba2-1.3b
``train_4k`` single, mixtral-8x22b ``decode_32k`` multi; the default
with ``small``) or ``single`` / ``multi`` (every arch and shape on that
mesh).

One line a case: ok and the trace seconds, or the error and the last
frames of its traceback. Each case also records the ops that reached the
sharding propagator. With ``--go-on`` a case does not stop at the first
refusal: an op that DTensor refuses is recorded (op, placements, error,
frames) and run on replicated inputs instead, and a redistribution the
planner refuses goes through replicated, so one run lists every refusal
of a case (its figures then mean nothing). Writes everything, the
registries' op names included, to ``--out`` (default
``chiprun_out/dryrun_probe.json``). Exits 0 when every case ran to a
record, ok or not (it asks; it does not hold a bar).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "src"))

import dryrun_small as DS  # noqa: E402

PRODUCTION = ("mamba2-1.3b:train_4k:single", "mixtral-8x22b:decode_32k:multi")


def registries():
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types
    sp = DTensor._op_dispatcher.sharding_propagator
    regs = {name: sorted(str(op) for op in getattr(sp, name))
            for name in ("op_strategy_funcs", "op_to_rules",
                         "op_single_dim_strategy_funcs")
            if hasattr(sp, name)}
    return {"torch": torch.__version__,
            "strided_shard": hasattr(placement_types, "_StridedShard"),
            "registries": regs,
            "ops_with_rules": sorted(DS.ops_with_rules(sp))}


def _frames(tb, n=4):
    """The last ``n`` frames of the port's code and the last ``n`` of
    all, one line each."""
    lines = [f"{f.filename.split('site-packages/')[-1]}:{f.lineno} "
             f"{f.name}: {f.line}" for f in traceback.extract_tb(tb)]
    port = [ln for ln in lines if "repro_torch" in ln]
    return list(dict.fromkeys(port[-n:] + lines[-n:]))


@contextlib.contextmanager
def going_on(failures, go_on):
    """Record each op DTensor refuses under the dry run's modes (and each
    redistribution its planner refuses) in ``failures``; with ``go_on``,
    run the op on replicated inputs (redistribute through replicated)
    and go on."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor import _redistribute as R
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.utils import _pytree as pytree
    from repro_torch.launch import dryrun as D
    seen = set()

    def record(entry, e):
        key = (entry["op"], str(entry.get("placements")),
               str(e).splitlines()[0][:120] if str(e) else type(e).__name__)
        if key in seen:
            return
        seen.add(key)
        entry.update(error=f"{type(e).__name__}: {str(e)[:600]}",
                     frames=_frames(e.__traceback__))
        failures.append(entry)

    def replicated(func, args, kwargs):
        flat, spec = pytree.tree_flatten((args, kwargs))
        dts = [a for a in flat if isinstance(a, DTensor)]
        mesh, dev = dts[0].device_mesh, dts[0]._local_tensor.device
        full = [torch.empty_strided(tuple(a.shape), a.stride(),
                                    dtype=a.dtype, device=dev)
                if isinstance(a, DTensor) else a for a in flat]
        if func._schema.is_mutable:
            return args[0]
        a2, k2 = pytree.tree_unflatten(full, spec)
        try:
            out = func(*a2, **k2)
        except Exception:
            if str(func._schema.returns[0].type) == "bool":
                return True
            raise
        return pytree.tree_map_only(
            torch.Tensor, lambda t: DTensor.from_local(
                t, mesh, [Replicate()] * mesh.ndim, run_check=False), out)

    plain = D.PartitionerPlacements.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        try:
            return plain(self, func, types, args, kwargs)
        except Exception as e:
            record({"op": str(func), "placements": [
                str(a.placements) for a in pytree.tree_leaves((args, kwargs))
                if isinstance(a, DTensor)], "shapes": [
                list(a.shape) for a in pytree.tree_leaves((args, kwargs))
                if isinstance(a, DTensor)]}, e)
            if not go_on:
                raise
            return replicated(func, args, kwargs or {})

    def planner(fn):
        def call(src, dst, *a, **k):
            try:
                return fn(src, dst, *a, **k)
            except Exception as e:
                record({"op": "redistribute planner", "placements": [
                    str(src.placements), str(dst.placements)],
                    "shapes": [list(src.shape)]}, e)
                if not go_on:
                    raise
                rep = DTensorSpec(src.mesh, (Replicate(),) * src.mesh.ndim,
                                  tensor_meta=src.tensor_meta)
                return list(fn(src, rep, *a, **k)) + list(fn(rep, dst, *a,
                                                            **k))
        return call
    names = [n for n in ("_gen_transform_infos",
                         "_gen_transform_infos_non_cached") if hasattr(R, n)]
    before = {n: getattr(R, n) for n in names}
    D.PartitionerPlacements.__torch_dispatch__ = dispatch
    for n in names:
        setattr(R, n, planner(before[n]))
    try:
        yield
    finally:
        D.PartitionerPlacements.__torch_dispatch__ = plain
        for n, fn in before.items():
            setattr(R, n, fn)


def child(case, device, go_on):
    import torch
    from repro_torch.launch import dryrun as D
    seen, failures = set(), []
    t0 = time.time()
    with DS.record_ops(seen), going_on(failures, go_on):
        if ":" in case:
            arch, shape, mesh = case.split(":")
            recs = {"mesh": D.run_one(arch, shape, mesh, device=device)}
        else:
            recs = DS.run_case(DS.BY_ID[case], device)
    return {"torch": torch.__version__, "wall_s": round(time.time() - t0, 2),
            "records": recs, "ops": sorted(seen), "failures": failures}


def expand(cases):
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    out = []
    for c in cases:
        if c == "small":
            out += [k["id"] for k in DS.CASES]
        elif c == "production":
            out += list(PRODUCTION)
        elif c in ("single", "multi"):
            out += [f"{a}:{s}:{c}" for a in ARCH_IDS for s in INPUT_SHAPES]
        else:
            out.append(c)
    return list(dict.fromkeys(out))


def _line(case, res):
    if "records" not in res:
        return f"[probe] {case}: {res['status']}: {res.get('stderr', '')[-400:]}"
    parts = []
    for name, rec in res["records"].items():
        s = rec["status"]
        if s == "ok":
            parts.append(f"{name} ok {rec['trace_s']} s")
        elif s == "skipped":
            parts.append(f"{name} skipped")
        else:
            frames = [ln.strip() for ln in rec.get("traceback", "")
                      .splitlines() if ln.strip().startswith("File")][-3:]
            parts.append(f"{name} {s}: {rec.get('error', '')[:300]} (at "
                         f"{' | '.join(frames)})")
    f = res["failures"]
    if f:
        parts.append(f"{len(f)} refusal(s), first {f[0]['op']} "
                     f"{f[0].get('placements')}: {f[0]['error'][:200]}")
    return f"[probe] {case} ({res['wall_s']} s, {len(res['ops'])} ops): " \
        + "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="*", default=["small", "production"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--go-on", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "dryrun_probe.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.device, args.go_on)))
        return 0
    reg = registries()
    print(f"[probe] torch {reg['torch']}; _StridedShard "
          f"{reg['strided_shard']}; " + ", ".join(
              f"{k} {len(v)}" for k, v in reg["registries"].items()),
          flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    todo, running, out, rc = expand(args.cases), {}, {}, 0
    while todo or running:
        while todo and len(running) < args.jobs:
            case = todo.pop(0)
            argv = [sys.executable, __file__, "--child", case, "--device",
                    args.device] + (["--go-on"] if args.go_on else [])
            running[case] = (time.time(), subprocess.Popen(
                argv, cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
        time.sleep(0.5)
        for case, (t0, proc) in list(running.items()):
            if proc.poll() is None and time.time() - t0 < args.timeout:
                continue
            del running[case]
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
                out[case] = {"status": "timeout", "timeout_s": args.timeout}
                rc = 1
            else:
                so, se = proc.communicate()
                if proc.returncode or not so.strip():
                    out[case] = {"status": f"exit {proc.returncode}",
                                 "stderr": se[-3000:]}
                    rc = 1
                else:
                    out[case] = json.loads(so.strip().splitlines()[-1])
            print(_line(case, out[case]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"registry": reg, "cases": out},
                                         indent=1))
    print(f"[probe] -> {args.out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
