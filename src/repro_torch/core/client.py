"""On-board local training (ClientUpdate in Algorithms 1-4).

Port of the JAX package's ``core/client.py``. ``local_sgd_clients`` is the
round engine's hot path: a stacked cohort of W clients trains as one
batched computation (``torch.func.vmap`` over ``torch.func.grad``), one
vmapped SGD step per minibatch for the whole cohort. Epoch counts are per
client and dynamic: as under the reference's vmapped ``fori_loop``, a
client whose budget is spent keeps its parameters frozen (selected
unchanged) while the others run on. The cohort width and batch shapes are
the only shapes, so nothing is re-specialised per round.

Minibatch order is an input: ``perms`` holds each client's per-epoch
permutation, drawn through the random seam (``repro_torch.rng``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.models.small import MODELS, xent_loss


def _loss_fn(apply_fn, mu: float):
    def loss(p, xb, yb, gp):
        l = xent_loss(apply_fn, p, xb, yb)
        if gp is not None:                      # FedProx proximal term
            prox = sum(((p[k] - gp[k]) ** 2).sum() for k in p)
            l = l + 0.5 * mu * prox
        return l
    return loss


def local_sgd_clients(model, stacked_params, xs, ys, perms, epochs,
                      batch_size, lr, mu=0.0, global_params=None):
    """Train a stacked cohort of clients (W, ...).

    ``xs`` (W, n, ...), ``ys`` (W, n); ``perms`` (W, E, n) int64 with
    E >= max(epochs): row e is the client's minibatch order in epoch e.
    ``epochs`` is a scalar or per-client (W,) count (host values). With
    ``mu > 0`` the FedProx term ``mu/2 * ||w - global_params||^2`` joins
    the loss. Returns the trained stacked dict."""
    apply_fn = MODELS[model][1]
    W, n = xs.shape[0], xs.shape[1]
    ep = np.broadcast_to(np.asarray(epochs, np.int64), (W,)).copy()
    n_batches = max(n // batch_size, 1)
    gp = global_params if mu > 0.0 else None
    step = vmap(grad(_loss_fn(apply_fn, mu)), in_dims=(0, 0, 0, None))
    ep_dev = torch.as_tensor(ep, device=xs.device)
    rows = torch.arange(W, device=xs.device)[:, None]
    params = dict(stacked_params)
    for e in range(int(ep.max(initial=0))):
        active = ep_dev > e                                   # (W,)
        perm = perms[:, e].to(xs.device)
        xe, ye = xs[rows, perm], ys[rows, perm]
        for b in range(n_batches):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            g = step(params, xe[:, sl], ye[:, sl], gp)
            params = {k: torch.where(
                active.reshape((-1,) + (1,) * (p.dim() - 1)),
                p - lr * g[k], p) for k, p in params.items()}
    return params


def local_sgd(model, params, x, y, perms, epochs, batch_size, lr, mu=0.0,
              global_params=None):
    """Train one client: the W = 1 case of :func:`local_sgd_clients`.
    ``perms`` (E, n), ``epochs`` an int."""
    stacked = {k: v[None] for k, v in params.items()}
    out = local_sgd_clients(model, stacked, x[None], y[None], perms[None],
                            epochs, batch_size, lr, mu, global_params)
    return {k: v[0] for k, v in out.items()}
