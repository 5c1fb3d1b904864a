"""Plain AdamW with decoupled weight decay (Loshchilov and Hutter,
arXiv:1711.05101), global-norm gradient clipping, and the QuAFL
quantized average of AutoFLSat's tier-2 exchange, float32.

Hyper-parameters are the traffic file's ``adamw``: lr, b1, b2, eps,
weight_decay, grad_clip, warmup_steps. Update t (1, 2, ...) runs at
lr * min((t + 1) / warmup_steps, 1).
"""
from __future__ import annotations

import torch


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so that their global norm is at most ``max_norm``,
    the global norm before)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return [g * scale for g in grads], norm


class AdamW:
    def __init__(self, params, hp):
        self.params, self.hp, self.t = params, hp, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        hp = self.hp
        self.t += 1
        t = self.t
        lr = hp["lr"] * min((t + 1) / max(hp["warmup_steps"], 1), 1.0)
        b1, b2 = hp["b1"], hp["b2"]
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t))
                                          + hp["eps"])
            p.sub_(lr * (step + hp["weight_decay"] * p))


def quantized_mean(x, bits):
    """QuAFL: each cluster's tensor x[c] quantized to ``bits`` bits,
    symmetric and uniform under one scale (its largest magnitude onto the
    largest level), dequantized, then averaged over the clusters."""
    qmax = 2.0 ** (bits - 1) - 1.0
    xf = x.to(torch.float32)
    amax = xf.abs().reshape(xf.shape[0], -1).amax(dim=1)
    # divided as IEEE float32 divides (a division by a host scalar may
    # run as a multiply by its rounded reciprocal)
    amax = torch.clamp_min(amax, 1e-12)
    scale = (amax / torch.full_like(amax, qmax)).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return (q * scale).mean(dim=0)


def mean(x):
    return x.to(torch.float32).mean(dim=0)
