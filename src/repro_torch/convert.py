"""Carry the JAX package's parameters and datasets into the port.

All take numpy arrays (``np.asarray`` of the reference's ``jax.Array``s),
so a test can feed the same values to both packages. Layouts are kept as
the reference has them: NHWC images, HWIO conv weights, dense weight
``(7*7*32, 128)`` for the FEMNIST CNN; the LM stack's ``(D, H, hd)``
attention weights and ``(n_super, ...)`` stacked layers. Labels become
int64 (torch's index type); their values are unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.synthetic import FedDataset
from repro_torch.train.steps import TrainState


def params_from_numpy(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """A flat dict of arrays (the reference's parameter pytree) -> dict of
    float32 tensors on ``device`` (default the card), same keys."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def lm_params_from_numpy(tree, device="cuda"):
    """The reference's nested LM param tree (dicts, plus the ``layers``
    tuple) -> the same tree of tensors on ``device`` (default the card),
    same keys and dtypes."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(lm_params_from_numpy(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def train_state_from_numpy(params, opt, device="cuda") -> TrainState:
    """The reference's ``TrainState`` (its ``params`` tree and its AdamW
    ``opt`` dict ``{"m", "v", "step"}``, as numpy arrays) -> the port's
    ``TrainState`` on ``device`` (default the card), same keys, shapes and
    dtypes (``opt/step`` int32). A hierarchical state, whose leaves carry
    the leading clusters axis, carries across the same way."""
    return TrainState(params=lm_params_from_numpy(params, device),
                      opt=lm_params_from_numpy(opt, device))


def dataset_from_numpy(x, y, x_test, y_test, n_classes: int, name: str,
                       device="cuda") -> FedDataset:
    """The reference's ``FedDataset`` fields -> the port's ``FedDataset``
    on ``device`` (default the card)."""
    device = resolve_device(device)
    as_t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt,
                                     device=device)
    return FedDataset(name=name, x=as_t(x, torch.float32),
                      y=as_t(y, torch.int64),
                      x_test=as_t(x_test, torch.float32),
                      y_test=as_t(y_test, torch.int64),
                      n_classes=int(n_classes))
