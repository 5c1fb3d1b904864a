"""Train / prefill / decode steps shared by the trainer and the tests.
Port of the JAX package's ``train/steps.py``.

``train_step`` is the full production step: loss -> grads -> AdamW update.
The loss masks padding (label < 0), adds the MoE load-balance aux loss, and
computes cross-entropy in float32 off compute-dtype matmuls. Gradients come
from autograd on detached views of the params; the AdamW update then writes
the params and moments in place: a step consumes the state it is given, as
the reference's ``donate_argnums=0`` does.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.models import model as M
from repro_torch.optim.optimizers import (AdamWConfig, adamw_init,
                                          adamw_update, tree_leaves,
                                          tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: Any


def cross_entropy(logits, labels):
    """logits (B,S,V) f32; labels (B,S) integer, <0 = masked."""
    mask = (labels >= 0).to(torch.float32)
    labels_safe = torch.clamp_min(labels, 0).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    # the gold logit stays (B,S,1) until the subtraction: with the vocab
    # sharded, DTensor's gather leaves a masked partial sum that it can
    # reduce only in the shape the gather gave
    gold = torch.gather(logits, -1, labels_safe[..., None])
    nll = (logz - gold)[..., 0] * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(params, cfg, batch):
    logits, aux = M.apply_train(params, cfg, batch)
    ce = cross_entropy(logits, batch["labels"])
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


def value_and_grad(params, cfg, batch):
    """((loss, parts), grads): ``loss_fn`` and its gradient with respect to
    every leaf of ``params`` (zeros for a leaf the loss does not reach, as
    ``jax.value_and_grad`` gives)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = tree_leaves(leaves)
    with torch.enable_grad():
        loss, parts = loss_fn(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    by_leaf = {id(p): g for p, g in zip(flat, grads)}
    parts = {k: v.detach() for k, v in parts.items()}
    return (loss.detach(), parts), tree_map(lambda p: by_leaf[id(p)], leaves)


def init_train_state(cfg, generator, device="cuda") -> TrainState:
    params = M.init_params(cfg, generator, device)
    return TrainState(params=params, opt=adamw_init(params))


def make_train_step(cfg, opt_cfg: AdamWConfig = AdamWConfig()):
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        """One step -> (state, metrics). ``state`` is consumed, as the
        reference's train step donates it (``donate_argnums=0``): its params
        and AdamW moments are updated in place and come back as the new
        state. A caller that needs the old state clones it first."""
        (loss, parts), grads = value_and_grad(state.params, cfg, batch)
        with torch.no_grad():
            newp, newopt, gnorm = adamw_update(opt_cfg, state.params, grads,
                                               state.opt)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": gnorm}
        return TrainState(params=newp, opt=newopt), metrics
    return train_step


def make_prefill_step(cfg):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg):
    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos):
        """``M.decode_step``: the cache is consumed (written in place)."""
        return M.decode_step(params, cfg, cache, tokens, pos)
    return decode_step
