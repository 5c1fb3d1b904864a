"""Beyond-paper: AutoFLSat's hierarchy as a large-model training schedule.

Trains a reduced qwen3-family LM with the hierarchical trainer: 2 clusters
each holding their own replica, training locally on non-IID token streams,
syncing parameters every H steps where H comes from a simulated
constellation's inter-satellite-link schedule; then fully synchronous
training on the same token budget. The counterpart of the JAX package's
``examples/hierarchical_llm_train.py``, with the same configuration. Run:

    PYTHONPATH=src python -m repro_torch.hierarchical_llm_train
        [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core import hierarchy as H
from repro_torch.core.contact_plan import build_contact_plan
from repro_torch.core.quantize import transmit_bytes
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.sim.hardware import SMALLSAT_SBAND
from repro_torch.train import steps as ST

CFG = dataclasses.replace(get_smoke_config("qwen3-14b"),
                          compute_dtype="float32", vocab=512)
NC, STEPS, BATCH, SEQ = 2, 40, 4, 64
OPT = AdamWConfig(lr=3e-3, warmup_steps=5)


def run(device="cuda"):
    """(hfl losses, sync losses, H) of the two schedules."""
    dev = resolve_device(device)
    # --- derive H from orbital mechanics ---------------------------------
    state = H.init_hfl_state(CFG, NC, torch.Generator(dev).manual_seed(0),
                             device=dev)
    plan = build_contact_plan(NC, 10, 3, horizon_s=86400.0, dt_s=60.0,
                              with_isl_pairs=True, device=dev)
    # ISL exchange billed at the same 10-bit QuAFL wire size the sync uses
    h_sync = H.sync_interval_from_orbits(
        plan, SMALLSAT_SBAND, transmit_bytes(state.params, 10) / NC,
        step_time_s=5.0, max_h=10)
    print(f"ISL schedule => cluster sync every H={h_sync} steps")

    local = H.make_hfl_local_step(CFG, OPT)
    sync = H.make_cluster_sync(CFG, quant_bits=10)
    streams = [list(synthetic_lm_batches(CFG.vocab, BATCH, SEQ, STEPS,
                                         seed=31 * c, device=dev))
               for c in range(NC)]
    hfl_losses = []
    for i in range(STEPS):
        state, m = local(state, [s[i] for s in streams])
        hfl_losses.append(float(m["loss"].mean()))
        if (i + 1) % h_sync == 0:
            state = sync(state)

    # --- fully synchronous reference (same token budget) -----------------
    ref_state = ST.init_train_state(CFG, torch.Generator(dev).manual_seed(0),
                                    device=dev)
    step = ST.make_train_step(CFG, OPT)
    ref_losses = []
    for i in range(STEPS):
        # sync baseline sees the union of both streams, alternating
        ref_state, m = step(ref_state, streams[i % NC][i])
        ref_losses.append(float(m["loss"]))

    print(f"hfl  (H={h_sync}, 10-bit QuAFL sync): "
          f"loss {hfl_losses[0]:.3f} -> {hfl_losses[-1]:.3f}")
    print(f"sync (every-step all-reduce):        "
          f"loss {ref_losses[0]:.3f} -> {ref_losses[-1]:.3f}")
    print(f"cross-cluster syncs: hfl={STEPS // h_sync} vs sync={STEPS} "
          f"(a {STEPS / max(STEPS // h_sync, 1):.0f}x cut in slow-link "
          f"exchanges — the paper's round-duration insight)")
    return hfl_losses, ref_losses, h_sync


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
