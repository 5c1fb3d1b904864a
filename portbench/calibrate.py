"""Readings the limits of ``portbench/limits/<workload>.json`` are set
from. Not part of a benchmark run; run on the card, one process a cell:

    python3 portbench/calibrate.py --workload mamba2-hfl-train \\
        --seeds 11,12,13 --control-seeds 21,22,23 --out chiprun_out/cal.json

For each of ``--seeds``: the program's numbers against the reference, as
a run computes them (for training the first round and the sync check;
for prefill the cell's ``check_calls`` calls at its own load). For each
of ``--control-seeds``: the control, the reference computed with every
weight product in float8 (the step below the configuration's bfloat16)
in the program's place, and the planted faults the cell can have:
training, half of each batch left out and the tier-2 exchange left out
(a state left unchanged reads 1 by the change number and needs no run);
prefill, each served token altered where it is produced and one slot of
every batch served wrongly, all at the positions and with the statistics
that a run compares. Each reading is also judged against the cell's
``limits/<workload>.json`` ("correct"). Prints one JSON line a reading
and writes them all to ``--out``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench import harness  # noqa: E402


def train_readings(env, seeds, control_seeds, emit):
    from portbench.drivers import hfl_train as D
    for seed in seeds:
        t = D.Trainer(env, seed)
        prog = D.host(t.first_round(), t.nc)
        sync_gap = t.sync_check()
        del t
        env.free()
        ref = D.reference(env, seed)
        where = {}
        nums = dict(D.numbers(prog, ref, where), sync_gap=sync_gap)
        emit("program", seed, nums, not_compared=where)
        env.free()
    for seed in control_seeds:
        t = D.Trainer(env, seed)
        t.first_round()
        left_out = t.sync_check(sync=lambda state: state)
        del t
        env.free()
        emit("fault_exchange_left_out", seed, {"sync_gap": left_out})
        ref = D.reference(env, seed)
        where = {}
        nums = D.numbers(D.reference(env, seed, "fp8"), ref, where)
        emit("control_fp8", seed, nums, not_compared=where)
        where = {}
        nums = D.numbers(D.reference(env, seed, fault="half_batch"), ref,
                         where)
        emit("fault_half_batch", seed, nums, not_compared=where)
        env.free()


def prefill_readings(env, seeds, control_seeds, emit):
    import random

    from portbench import checks
    from portbench.drivers import prefill as D
    n = env.traffic["check_calls"]
    limits = env.spec["limits"]["numbers"]
    moe = env.config["arch_type"] == "moe"

    def judged(kind, seed, nums, **detail):
        ok, _ = checks.judge(nums, limits)
        emit(kind, seed, nums, correct=ok, **detail)

    for seed in seeds:
        # the program's numbers as a run computes them: ``check_calls``
        # calls at the cell's own batch and length
        s = D.Server(env, seed)
        b = s.shape[0]
        s.call(s.draw(s.warm_prompts))[1].tolist()
        calls = []
        for _ in range(n):
            tok = s.draw()
            last, first = s.call(tok)
            first.tolist()
            calls.append((tok, last, first))
        g_all, e_all, keep, rows = [], [], [], []
        for tok, last, first in calls:
            stats = {}
            ref = D.reference_logits(env, s.w, tok, stats=stats)
            g, e = D.gaps(ref, first), D.errors(ref, last)
            g_all += g
            e_all += e
            keep += D.near_ties(env, stats.get("margin"), len(g))
            for r in range(len(g)):
                rows.append({"token_gap": g[r], "logit_err": e[r]})
                if moe:
                    rows[-1].update(router_margin=float(stats["margin"][r]),
                                    dropped=stats["dropped"])
        judged("program", seed, D.numbers(g_all, e_all, b, keep),
               requests=rows)
        del s, calls
        env.free()
    for seed in control_seeds:
        # at the positions a run compares (each request's last) and with
        # the same statistics: the control (the reference in float8 in the
        # program's place), each served token altered where it is
        # produced, and one slot of every batch served wrongly (its
        # last-position logits shifted by one vocabulary entry)
        s = D.Server(env, seed)
        b = s.shape[0]
        rng = random.Random(seed)
        ctl_g, ctl_e, alt, prog_e, slot_g, slot_e, keep, margins = \
            [], [], [], [], [], [], [], []
        for _ in range(n):
            tok = s.draw()
            last, first = s.call(tok)
            stats = {}
            ref = D.reference_logits(env, s.w, tok, stats=stats)
            keep += D.near_ties(env, stats.get("margin"), b)
            if moe:
                margins += [float(m) for m in stats["margin"]]
            ctl = D.reference_logits(env, s.w, tok, "fp8")
            ctl_g += D.gaps(ref, ctl.argmax(-1))
            ctl_e += D.errors(ref, ctl)
            v = ref.shape[-1]
            bad = (ref.argmax(-1) + rng.randrange(1, v)) % v
            alt += D.gaps(ref, bad)
            prog_e += D.errors(ref, last)
            one = last.clone()
            one[b - 1] = one[b - 1].roll(1, dims=-1)
            slot_g += D.gaps(ref, one.argmax(-1))
            slot_e += D.errors(ref, one)
            del ref, ctl, last, first, one
        judged("control_fp8", seed, D.numbers(ctl_g, ctl_e, b, keep),
               last_position_errors=ctl_e, last_position_gaps=ctl_g,
               router_margins=margins)
        judged("fault_token_altered", seed, D.numbers(alt, prog_e, b, keep))
        judged("fault_one_slot", seed, D.numbers(slot_g, slot_e, b, keep))
        del s
        env.free()


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    spec = harness.cell_spec(harness.load_json(ROOT / "BENCHMARK.json"),
                             args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.say("no CUDA device")
        return 2
    env = harness.Env(torch, spec, 0, 0.0, 0, "cuda", T0)
    rows = []

    def emit(kind, seed, nums, **detail):
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               "numbers": nums, "t_s": time.perf_counter() - T0, **detail}
        rows.append(row)
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))

    harness.say(f"card: {harness.card_info()}")
    kind = spec["traffic"]["kind"]
    fn = train_readings if kind == "hfl_train" else prefill_readings
    fn(env, ints(args.seeds), ints(args.control_seeds), emit)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
