"""Synthetic stand-ins for the paper's datasets (offline: no downloads).
Class-conditional Gaussian images with per-class structured means; shapes
and class counts mirror FEMNIST / CIFAR-10 / EuroSAT.

Port of the JAX package's ``data/synthetic.py``. The arithmetic is the
reference's; the draws come from the random seam (``repro_torch.rng``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.data.partition import dirichlet_labels
from repro_torch.rng import TorchRandom

DATASETS = {
    # name: (H, W, C, n_classes)  — mirrors FEMNIST / CIFAR-10 / EuroSAT
    "femnist": (28, 28, 1, 62),
    "cifar10": (32, 32, 3, 10),
    "eurosat": (64, 64, 3, 10),
}

# per-dataset noise scale: cifar/eurosat are harder than femnist so that
# synthetic accuracy curves leave headroom (no trivial 100% plateaus)
NOISE = {"femnist": 1.0, "cifar10": 3.0, "eurosat": 2.0}


@dataclasses.dataclass(frozen=True)
class FedDataset:
    name: str
    x: torch.Tensor          # (K, N, H, W, C) per-client images, float32
    y: torch.Tensor          # (K, N) int64 labels
    x_test: torch.Tensor     # (M, H, W, C)
    y_test: torch.Tensor     # (M,) int64
    n_classes: int

    @property
    def n_clients(self):
        return self.x.shape[0]

    @property
    def n_per_client(self):
        return self.x.shape[1]


def _linspace(stop: float, num: int, device):
    """``jnp.linspace(0, stop, num)`` in float32 as XLA evaluates it:
    ``(stop / (num - 1)) * i``, with the last point exactly ``stop``."""
    stop = torch.tensor(stop, dtype=torch.float32, device=device)
    delta = stop / torch.tensor(float(num - 1), device=device)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    return torch.cat([delta * i, stop[None]])


def class_means(freqs, phases01, shape, scale=2.0):
    """Low-frequency structured class prototypes (n_classes, H, W, C) from
    the seam's raw draws: ``freqs`` ~ N(0, 1) and ``phases01`` ~ U[0, 1),
    each (n_classes, 4, C)."""
    h, w, _ = shape
    freqs = freqs * scale
    phases = phases01 * 2 * math.pi
    dev = freqs.device
    yy = _linspace(2 * math.pi, h, dev)[:, None, None]
    xx = _linspace(2 * math.pi, w, dev)[None, :, None]
    f = freqs[:, :, None, None, :]                   # (n, 4, 1, 1, C)
    p = phases[:, :, None, None, :]
    return (f[:, 0] * torch.sin(yy + p[:, 0])
            + f[:, 1] * torch.cos(xx + p[:, 1])
            + f[:, 2] * torch.sin(2 * yy + xx + p[:, 2])
            + f[:, 3] * torch.cos(yy - 2 * xx + p[:, 3]))


def make_federated_dataset(name: str, n_clients: int, n_per_client: int = 128,
                           n_test: int = 512, alpha: float = 0.5,
                           seed: int = 0, device="cuda",
                           random_source=TorchRandom) -> FedDataset:
    """Dirichlet(alpha) non-IID label distribution across clients; every
    tensor lives on ``device``. ``random_source(seed)`` supplies the draws."""
    dev = resolve_device(device)
    src = random_source(seed)
    h, w, c, ncls = DATASETS[name]
    freqs, phases = src.class_prototypes(ncls, c)
    means = class_means(freqs.to(dev), phases.to(dev), (h, w, c))
    noise = NOISE.get(name, 1.0)
    y = dirichlet_labels(src, n_clients, n_per_client, ncls,
                         alpha).to(dev, torch.int64)
    x = means[y] + noise * src.train_noise(
        (n_clients, n_per_client, h, w, c)).to(dev)
    y_test = src.test_labels(n_test, ncls).to(dev, torch.int64)
    x_test = means[y_test] + noise * src.test_noise((n_test, h, w, c)).to(dev)
    return FedDataset(name=name, x=x, y=y, x_test=x_test, y_test=y_test,
                      n_classes=ncls)
