"""Batched serving driver: prefill a batch of prompts, then decode N tokens
per request with the KV/SSM-cache serve path (greedy or temperature
sampling). Port of the JAX package's ``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
      --reduced --batch 4 --prompt-len 32 --gen 16

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M


def synced_clock(dev):
    """Host seconds, after the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.inference_mode()
def generate(cfg, params, prompts, gen_len, temperature=0.0, seed=0,
             stats=None):
    """prompts (B, P) integer tensor -> (B, P + gen_len) tokens, on the
    prompts' device. Greedy is an exact ``argmax`` (first index on ties);
    temperature > 0 samples from softmax(logits / temperature) with a
    ``torch.Generator`` seeded with ``seed`` on that device. A ``stats``
    dict receives ``prefill_s``, ``decode_s`` (host clock, synchronised
    with the device) and the prefill's last-token ``prefill_logits``."""
    b, plen = prompts.shape
    total = plen + gen_len
    dev = prompts.device
    batch = {"tokens": prompts}
    cd = M.cdtype(cfg)
    if cfg.vision is not None:
        batch["patches"] = torch.zeros(
            (b, cfg.vision.n_img_tokens, cfg.vision.d_vision), dtype=cd,
            device=dev)
    if cfg.encoder is not None:
        batch["frames"] = torch.zeros((b, cfg.encoder.n_frames, cfg.d_model),
                                      dtype=cd, device=dev)
    t0 = synced_clock(dev) if stats is not None else 0.0
    logits, pcache = M.prefill(params, cfg, batch)
    cache = M.convert_prefill_cache(cfg, pcache, plen, total)
    if stats is not None:
        t1 = synced_clock(dev)
        stats.update(prefill_s=t1 - t0, prefill_logits=logits[:, -1, :])

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [prompts]
    lg = logits[:, -1, :]
    for t in range(plen - 1, total - 1):
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        nxt = nxt.to(prompts.dtype)[:, None]
        out.append(nxt)
        pos = torch.full((b,), t + 1, dtype=torch.int64, device=dev)
        lg_step, cache = M.decode_step(params, cfg, cache, nxt, pos)
        lg = lg_step[:, 0, :]
    if stats is not None:
        stats["decode_s"] = synced_clock(dev) - t1
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev)
    stats = {}
    t0 = synced_clock(dev)
    tokens = generate(cfg, params, prompts, args.gen,
                      temperature=args.temperature, seed=args.seed,
                      stats=stats)
    dt = synced_clock(dev) - t0
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": args.gen,
        "total_shape": list(tokens.shape),
        "tokens_per_s": round(args.batch * args.gen / dt, 2),
        "wall_s": round(dt, 2),
        "prefill_s": round(stats["prefill_s"], 4),
        "decode_tokens_per_s": round(args.batch * args.gen
                                     / stats["decode_s"], 2),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }))
    print("sample:", tokens[0, -args.gen:].tolist())


if __name__ == "__main__":
    main()
