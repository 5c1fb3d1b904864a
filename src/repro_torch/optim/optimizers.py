"""Optimizers as plain functions on trees of tensors. Port of the JAX
package's ``optim/optimizers.py``.

A tree is nested dicts, tuples and lists of tensors, as the LM params are.
State layouts mirror the param tree (the AdamW state is ``{"m", "v",
"step"}`` with ``step`` an int32 scalar tensor, as the reference's).
``adamw_update`` consumes the params and state it is given (the
reference's train step donates them) and updates them in place; the other
functions return new tensors and leave their arguments as they are.
Reductions over leaves run in the reference's flatten order: sorted dict
keys, then tuple index.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_leaves(tree):
    """The tensors of ``tree`` in the reference's flatten order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each tree
    of ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") \
            else type(tree)(*out)
    return fn(tree, *rest)


def _global_norm(grads):
    gn = None
    for g in tree_leaves(grads):
        sq = g.to(torch.float32).square().sum()
        gn = sq if gn is None else gn + sq
    return torch.sqrt(gn)


def _clip_scale(gn, max_norm):
    return torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm):
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _schedule(cfg: AdamWConfig, step):
    # (step + 1) on the already incremented step, as the reference's: the
    # first update runs at 2 / warmup_steps of lr
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    return cfg.lr * warm


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step -> (params, state, global grad norm before clipping).

    ``params`` and ``state`` are consumed, as the reference's train step
    donates its state (``donate_argnums=0``): each leaf's moments and
    param are updated in place, leaf by leaf, and the same trees come
    back, so the step holds one leaf's float32 temporaries, never a second
    tree. The arithmetic is the functional update's, op for op. A caller
    that needs the old state clones it first."""
    # the clipped gradient g * scale is formed leaf by leaf, not as a
    # tree, so the step holds one copy of the gradients
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"].add_(1)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2

    stepf = step.to(torch.float32)
    c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd(p, g, m, v):
        g32 = (g * scale).to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32.square())
        mhat = m / c1
        vhat = v / c2
        p.copy_(p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p))

    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state["m"]), tree_leaves(state["v"])):
        upd(*leaves)
    return params, state, gnorm


def sgd_init(params, momentum=0.0):
    if momentum:
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
    return {}


def sgd_update(params, grads, state, lr, momentum=0.0):
    if momentum and "mu" in state:
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
        newp = tree_map(lambda p, m: (p - lr * m).to(p.dtype), params, mu)
        return newp, {"mu": mu}
    newp = tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)
    return newp, state
