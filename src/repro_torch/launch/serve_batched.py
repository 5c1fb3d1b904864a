"""Batched serving example: prefill + cache decode on a reduced Mixtral
(sliding-window ring-buffer KV cache) and a reduced Mamba-2 (O(1) state).
Port of the JAX package's ``examples/serve_batched.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import generate, synced_clock
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    for arch in ("mixtral-8x22b", "mamba2-1.3b"):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        prompts = torch.randint(0, cfg.vocab, (4, 24), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(1))
        t0 = synced_clock(dev)
        out = generate(cfg, params, prompts, gen_len=12, temperature=0.8)
        dt = synced_clock(dev) - t0
        print(f"{arch:16s} batch=4 prompt=24 gen=12 -> {tuple(out.shape)} "
              f"({4 * 12 / dt:.1f} tok/s)  sample={out[0, -6:].tolist()}")


if __name__ == "__main__":
    main()
