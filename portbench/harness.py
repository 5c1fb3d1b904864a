"""One run of one cell: ``python3 portbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout.

The cell's configuration, traffic mix and limits are data files found by
the names in ``BENCHMARK.json``: ``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json`` (whose ``kind`` names the driver in
``portbench/drivers/``) and ``portbench/limits/<workload>.json``. A
per-layer metric is a reader ``portbench/metrics/<name>.py`` with a
function ``read(ctx)`` that returns a number, or None where it finds
nothing to read.

With ``--trace 0`` the run prints the cell's end-to-end metrics; with
``--trace 1`` a shorter window runs under ``torch.profiler`` and the run
prints the cell's per-layer metrics, the device's busy and window
seconds and a breakdown. Either way the run checks what its timed path
produced against the plain reference, prints each number compared beside
its limit as the last lines of standard error, and prints one JSON line
last on standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(bench, workload, root=ROOT):
    """Everything one cell needs, from ``BENCHMARK.json`` and the data
    files it names."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in names]
    return {
        "cell": cell,
        "config": load_json(root / config["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    names compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_info():
    """The card's name, power limit, SM clock, power draw and temperature
    (``nvidia-smi``), or why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    return out.stdout.strip() or out.stderr.strip()


def say(msg):
    print(msg, file=sys.stderr, flush=True)


class Env:
    """What a driver gets: the cell's data, the device, the seed, the
    window's length, the set-up clock and the spans."""

    def __init__(self, torch, spec, seed, seconds, trace, device, t0):
        from portbench.tracing import Spans
        self.torch, self.spec, self.seed = torch, spec, seed
        self.seconds, self.trace = seconds, bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.traffic = spec["traffic"]
        self.config = spec["config"]
        self.spans = Spans(torch, self.trace, self.device)
        self.t0 = self.t_mark = t0
        self.parts = {}
        self.setup_s = None
        self.peak_bytes = None
        self.card_after = None
        self.prof = None

    def mark(self, part):
        """Close the set-up part ``part`` (seconds since the last mark)."""
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.t_mark
        self.t_mark = now

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def program_config(self, path):
        """The program's ``ModelConfig`` of this cell's configuration on
        one of its paths ("train" or "prefill")."""
        from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
        c = self.config
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {k: v for k, v in c.items() if k in fields}
        if c.get("moe"):
            kw["moe"] = MoEConfig(**c["moe"])
        if c.get("ssm"):
            kw["ssm"] = SSMConfig(**c["ssm"])
        kw.update({k: v for k, v in c["paths"][path].items()
                   if k in fields})
        return ModelConfig(**kw)

    def reference(self):
        """The configuration's plain reference module
        (``portbench/reference/<reference>.py``)."""
        return importlib.import_module(
            f"portbench.reference.{self.config['reference']}")

    def load_kernels(self, path):
        """Build (first run in a checkout) or find the program's kernels
        this path launches, in the program's build directory inside the
        checkout."""
        names = self.config["paths"][path].get("kernels", [])
        if names and self.cuda:
            from repro_torch.kernels import _build
            _build.build(names)
        self.mark("kernels")

    def start_window(self):
        """Set-up ends here: the device is drained, and the window starts
        (under the profiler in a traced run). Python's cyclic garbage
        collector stays off through the window (the objects set-up made
        are frozen first), so that none of its passes lands at a random
        point of the host's launches."""
        self.sync()
        gc.collect()
        gc.freeze()
        gc.disable()
        self.mark("warmup")
        self.setup_s = time.perf_counter() - self.t0
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            from portbench.tracing import WINDOW_SPAN
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._span = self.torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()
        return time.perf_counter()

    def end_window(self):
        """The window's end: the device drained, the profiler stopped.
        Returns the host clock at the drained end."""
        self.sync()
        t = time.perf_counter()
        gc.enable()
        gc.unfreeze()
        if self.prof is not None:
            self._span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            say(f"profiler stopped in {time.perf_counter() - t:.1f} s")
        if self.cuda:
            self.peak_bytes = self.torch.cuda.max_memory_allocated(
                self.device)
            self.card_after = card_info()
        return t

    @property
    def window_seconds(self):
        """The window's length: the traffic's ``trace_seconds`` in a
        traced run, else the run's ``--seconds``."""
        if self.trace:
            return min(self.seconds, self.traffic["trace_seconds"])
        return self.seconds

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def read_layer_metrics(spec, ctx):
    """{name: value} of the cell's per-layer metrics, each by its reader;
    a reader that returns None leaves its metric out."""
    out = {}
    for m in spec["per_layer"]:
        path = HERE / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{m['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = v
    return out


def run_cell(spec, seed, seconds, trace, device, t0):
    """One run of the cell ``spec`` (see ``cell_spec``) on ``device``:
    the result line's dict, the numbers compared under "checks", last."""
    import torch

    from portbench import checks
    from portbench.tracing import reduce_trace, top
    drv = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['kind']}")
    env = Env(torch, spec, seed, seconds, trace, device, t0)
    env.mark("imports")
    if env.cuda:
        torch.cuda.init()
        torch.zeros(1, device=env.device)
        torch.cuda.reset_peak_memory_stats(env.device)
        env.mark("cuda_context")
        say(f"card before the window: {card_info()}")
        env.mark("card_info")

    r = drv.run(env)

    if env.cuda:
        say(f"card after the window: {env.card_after}")
    say("setup_s parts: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in env.parts.items())
        + f"; setup_s {env.setup_s:.3f} s")
    correct, rows = checks.judge(r["numbers"], spec["limits"]["numbers"])
    extra = {k: v for k, v in r["numbers"].items() if k not in rows}
    if extra:
        say(f"not compared: {extra}")
    units = {m["name"]: m["unit"]
             for m in spec["end_to_end"] + spec["per_layer"]}
    peak = env.peak_bytes or 0
    device_rec = {"platform": "gpu" if env.cuda else "cpu",
                  "kind": (torch.cuda.get_device_name(env.device)
                           if env.cuda else "cpu"),
                  "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": r["attempted"],
              "failed": r["failed"]}
    if trace:
        t_reduce = time.perf_counter()
        tr = reduce_trace(env.prof)
        say(f"trace reduced in {time.perf_counter() - t_reduce:.1f} s: "
            f"{tr['device_events']} device events")
        ctx = {"trace": tr, "spans": r["spans"], "counts": r["counts"],
               "config": spec["config"], "traffic": spec["traffic"]}
        values = read_layer_metrics(spec, ctx)
        device_rec.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in values.items()}
        result["device"] = device_rec
        result["breakdown"] = {"device_ops": top(tr["ops"]),
                               "idle_gaps": top(tr["idle_gaps"])}
    else:
        values = dict(r["end_to_end"], setup_s=env.setup_s,
                      peak_gib=peak / 2 ** 30)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec["end_to_end"]}
        result["device"] = device_rec
    result["checks"] = rows     # last: the numbers beside their limits
    return result


def main(argv, t0):
    args = parse_args(argv)
    spec = cell_spec(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        say(f"no result: the cell needs {need} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    result = run_cell(spec, args.seed, args.seconds, args.trace, "cuda", t0)
    bad = forbidden_modules()
    if bad:
        say(f"no result: the process loaded {bad}")
        return 3
    for name, row in result["checks"].items():
        say(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
