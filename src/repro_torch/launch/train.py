"""End-to-end LM training driver. Port of the JAX package's
``launch/train.py``, with its flags and its printed lines.

Modes:
  * plain:   synchronous training of any --arch (reduced or full config)
             on synthetic bigram token streams;
  * hfl:     the paper's AutoFLSat hierarchical mode — per-cluster replicas,
             H local steps between cluster syncs (H fixed or derived from a
             simulated constellation's ISL schedule), optional QuAFL-
             quantized sync.

Runs on the card unless ``--device cpu`` is given. Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --reduced --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --reduced --hfl --clusters 2 --sync-every orbit --steps 60
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import hierarchy as H
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.launch.serve import synced_clock
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train import steps as ST


def build_cfg(args):
    cfg = get_smoke_config(args.arch) if args.reduced else get_config(args.arch)
    over = {"compute_dtype": args.dtype}
    if args.vocab:
        over["vocab"] = args.vocab
    return dataclasses.replace(cfg, **over)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda")
    # hierarchical (AutoFLSat) mode
    ap.add_argument("--hfl", action="store_true")
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--sync-every", default="8",
                    help="steps between cluster syncs, or 'orbit' to derive "
                         "from a simulated constellation's ISL schedule")
    ap.add_argument("--quant-bits", type=int, default=0)
    ap.add_argument("--fleet", default="smallsat_sband",
                    help="with --hfl --sync-every orbit: comma-separated "
                         "hardware profiles (flycube | smallsat_sband) "
                         "cycled over the simulated constellation; a mixed "
                         "fleet bottlenecks the ISL schedule on its "
                         "slowest radio")
    ap.add_argument("--power-check", action="store_true",
                    help="with --hfl --sync-every orbit: report whether the "
                         "derived schedule's duty cycle fits the eclipse-"
                         "aware power budget of the simulated constellation")
    ap.add_argument("--policy", default="",
                    help="with --hfl --sync-every orbit: selection policy "
                         "(repro_torch.core.policy name, e.g. "
                         "deadline_aware) — derives per-member tier-1 step "
                         "budgets over the simulated fleet and weights the "
                         "tier-2 cluster sync accordingly; empty keeps the "
                         "uniform (bitwise pre-policy) sync")
    return ap.parse_args(argv)


def orbit_schedule(args, state, dev):
    """(H, cluster weights or None) from a simulated constellation's ISL
    schedule (``--sync-every orbit``), printing the ``[hfl]`` lines."""
    from repro_torch.core.contact_plan import build_contact_plan
    from repro_torch.core.quantize import transmit_bytes
    from repro_torch.sim.hardware import FLYCUBE, SMALLSAT_SBAND, FleetProfile
    nc = args.clusters
    named = {"flycube": FLYCUBE, "smallsat_sband": SMALLSAT_SBAND}
    try:
        cycle = [named[n.strip()] for n in args.fleet.split(",")
                 if n.strip()]
    except KeyError as e:
        raise SystemExit(f"unknown --fleet profile {e}; choose "
                         f"from {sorted(named)}")
    if not cycle:
        raise SystemExit(f"--fleet needs at least one profile "
                         f"from {sorted(named)}")
    spc = 10
    plan = build_contact_plan(nc, spc, 3, horizon_s=86400.0, dt_s=60.0,
                              with_isl_pairs=True, device=dev)
    fleet = FleetProfile.from_profiles(
        [cycle[i % len(cycle)] for i in range(nc * spc)])
    # bill the ISL exchange at the same (possibly quantized) wire size as
    # every other link so the schedule stays consistent; a mixed fleet's
    # exchange is gated by its slowest ISL radio
    wire = transmit_bytes(state.params, args.quant_bits) / nc
    h_sync = H.sync_interval_from_orbits(plan, fleet, wire, step_time_s=1.0)
    print(f"[hfl] ISL schedule ({args.fleet}) => sync every "
          f"H={h_sync} steps")
    cluster_w = None
    if args.policy:
        w = H.policy_cluster_weights(plan, fleet, args.policy, epochs=h_sync)
        if not np.allclose(w, 1.0):
            cluster_w = w
        print(f"[hfl] policy '{args.policy}': tier-2 cluster "
              f"weights = {[round(float(x), 3) for x in w]}"
              + ("" if cluster_w is not None
                 else " (uniform => exact unweighted sync)"))
    if args.power_check:
        from repro_torch.orbit.eclipse import mean_eclipse_fraction
        from repro_torch.sim.hardware import oap_added_mw, power_feasible
        ecl = mean_eclipse_fraction(plan.constellation, device=dev)
        # each satellite class pays its own duty cycle: check the schedule
        # against every distinct profile in the fleet
        for hw in dict.fromkeys(fleet.profiles):
            tx_s = float(hw.tx_time(wire, "isl"))
            duty_tx = min(tx_s / max(h_sync * 1.0, 1e-9), 1.0)
            duty = {"training": 1.0 - duty_tx, "training_tx": duty_tx}
            oap = oap_added_mw(duty, hw.power)
            # solar input flows only outside eclipse; idle always on
            budget = hw.power_generation_mw * (1.0 - ecl) - hw.power.idle
            ok = power_feasible(duty, hw, eclipse_fraction=ecl)
            verdict = "OK" if ok else "OVER BUDGET (expect SoC-gated stalls)"
            print(f"[hfl] power check [{hw.name}]: eclipse {ecl:.1%}, "
                  f"schedule adds {oap:.0f} mW vs {budget:.0f} mW "
                  f"sunlit-average margin => {verdict}")
    return h_sync, cluster_w


def train(args, on_step=None):
    """The training run ``args`` describe. Returns (cfg, final state,
    history): one record a step with ``loss`` (a list, one a cluster in
    hfl mode), ``grad_norm``, ``step_s`` (the local step) and ``sync_s``
    (the tier-2 sync that followed it, else None), host clock synchronised
    with the device; the batch is drawn before the clock starts.
    ``on_step(i, state, record)`` is called after every step (and its
    sync)."""
    dev = resolve_device(args.device)
    cfg = build_cfg(args)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    history = []

    if args.hfl:
        nc = args.clusters
        state = H.init_hfl_state(cfg, nc, gen, device=dev)
        local = H.make_hfl_local_step(cfg, opt_cfg)
        if args.policy and args.sync_every != "orbit":
            raise SystemExit("--policy needs --hfl --sync-every orbit (the "
                             "policy budgets are derived from the simulated "
                             "fleet and ISL schedule)")
        if args.sync_every == "orbit":
            h_sync, cluster_w = orbit_schedule(args, state, dev)
        else:
            h_sync, cluster_w = int(args.sync_every), None
        sync = H.make_cluster_sync(cfg, quant_bits=args.quant_bits,
                                   cluster_weights=cluster_w)
        # each cluster sees its own (non-IID) stream
        streams = [synthetic_lm_batches(cfg.vocab, args.batch, args.seq,
                                        args.steps, seed=args.seed + 17 * c,
                                        device=dev)
                   for c in range(nc)]
        for i in range(args.steps):
            bs = [next(s) for s in streams]
            ta = synced_clock(dev)
            state, m = local(state, bs)
            tb = synced_clock(dev)
            rec = {"step": i, "loss": m["loss"].tolist(),
                   "grad_norm": m["grad_norm"].tolist(),
                   "step_s": tb - ta, "sync_s": None}
            if (i + 1) % h_sync == 0:
                state = sync(state)
                rec["sync_s"] = synced_clock(dev) - tb
            history.append(rec)
            if on_step is not None:
                on_step(i, state, rec)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss/cluster="
                      f"{[round(x, 4) for x in rec['loss']]} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        final_loss = float(np.mean(history[-1]["loss"]))
    else:
        state = ST.init_train_state(cfg, gen, device=dev)
        step = ST.make_train_step(cfg, opt_cfg)
        stream = synthetic_lm_batches(cfg.vocab, args.batch, args.seq,
                                      args.steps, seed=args.seed, device=dev)
        for i, batch in enumerate(stream):
            ta = synced_clock(dev)
            state, m = step(state, batch)
            rec = {"step": i, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "step_s": synced_clock(dev) - ta, "sync_s": None}
            history.append(rec)
            if on_step is not None:
                on_step(i, state, rec)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss={rec['loss']:.4f} "
                      f"gnorm={rec['grad_norm']:.3f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        final_loss = history[-1]["loss"]

    if args.checkpoint:
        save_pytree(args.checkpoint, state.params,
                    extra_meta={"steps": args.steps})
        print(f"checkpoint -> {args.checkpoint}")
    print(json.dumps({"arch": cfg.name, "steps": args.steps,
                      "final_loss": round(final_loss, 4),
                      "wall_s": round(time.time() - t0, 1)}))
    return cfg, state, history


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
