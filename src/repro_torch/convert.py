"""Carry the JAX package's parameters and datasets into the port.

Both take numpy arrays (``np.asarray`` of the reference's ``jax.Array``s),
so a test can feed the same values to both packages. Layouts are kept as
the reference has them: NHWC images, HWIO conv weights, dense weight
``(7*7*32, 128)`` for the FEMNIST CNN. Labels become int64 (torch's index
type); their values are unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.data.synthetic import FedDataset


def params_from_numpy(tree, device="cpu") -> Dict[str, torch.Tensor]:
    """A flat dict of arrays (the reference's parameter pytree) -> dict of
    float32 tensors on ``device``, same keys."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def dataset_from_numpy(x, y, x_test, y_test, n_classes: int, name: str,
                       device="cpu") -> FedDataset:
    """The reference's ``FedDataset`` fields -> the port's ``FedDataset``."""
    as_t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt,
                                     device=device)
    return FedDataset(name=name, x=as_t(x, torch.float32),
                      y=as_t(y, torch.int64),
                      x_test=as_t(x_test, torch.float32),
                      y_test=as_t(y_test, torch.int64),
                      n_classes=int(n_classes))
