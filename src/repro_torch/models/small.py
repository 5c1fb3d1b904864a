"""Small on-board models for the FLySTacK simulator: the LeNet5-class CNN
and the MLP of the JAX package's ``models/small.py``, as plain functions
on dicts of tensors (same keys as the reference's parameter pytrees).

Layouts are the reference's: images NHWC, conv weights HWIO, and the
dense layer reads the NHWC flattening of the last conv block, so weights
carried over from the JAX package compute the same function. Inside,
the convolutions run NCHW with the weight permuted to OIHW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device


def init_cnn(source, input_shape, n_classes, width=16, device="cuda"):
    """Parameters of the CNN on ``device`` (default the card);
    ``source.init_normals`` (the random seam, ``repro_torch.rng``) supplies
    the draws."""
    device = resolve_device(device)
    h, w, c = input_shape
    f1, f2 = width, width * 2
    # two stride-2 conv blocks then dense
    h2, w2 = h // 4, w // 4
    d = h2 * w2 * f2
    n1, n2, n3, n4 = (t.to(device) for t in source.init_normals(
        [(3, 3, c, f1), (3, 3, f1, f2), (d, 128), (128, n_classes)]))
    z = lambda n: torch.zeros((n,), device=device)
    return {
        "conv1": n1 * (9 * c) ** -0.5, "b1": z(f1),
        "conv2": n2 * (9 * f1) ** -0.5, "b2": z(f2),
        "dense": n3 * d ** -0.5, "bd": z(128),
        "out": n4 * 128 ** -0.5, "bo": z(n_classes),
    }


def _same_pad(size: int, k: int, stride: int):
    """XLA's "SAME" padding (before, after) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x, w_hwio, stride: int):
    """x (B, C, H, W); HWIO weight; XLA "SAME" padding. For stride 2 on an
    even size that is one row/column of zeros on the bottom/right only,
    which ``padding="same"`` cannot express (it rejects stride > 1)."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    ph = _same_pad(x.shape[-2], kh, stride)
    pw = _same_pad(x.shape[-1], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


def apply_cnn(params, x):
    """x (B, H, W, C) -> logits (B, n_classes)."""
    h = x.permute(0, 3, 1, 2)                               # NHWC -> NCHW
    h = F.relu(_conv_same(h, params["conv1"], 2)
               + params["b1"][:, None, None])
    h = F.relu(_conv_same(h, params["conv2"], 2)
               + params["b2"][:, None, None])
    # flatten in the reference's NHWC order so the dense weight lines up
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["dense"] + params["bd"])
    return h @ params["out"] + params["bo"]


def init_mlp(source, input_shape, n_classes, hidden=128, device="cuda"):
    """Parameters of the MLP on ``device`` (default the card)."""
    device = resolve_device(device)
    h, w, c = input_shape
    d = h * w * c
    n1, n2 = (t.to(device) for t in source.init_normals(
        [(d, hidden), (hidden, n_classes)]))
    return {
        "w1": n1 * d ** -0.5, "b1": torch.zeros((hidden,), device=device),
        "w2": n2 * hidden ** -0.5,
        "b2": torch.zeros((n_classes,), device=device),
    }


def apply_mlp(params, x):
    h = x.reshape(x.shape[0], -1)
    h = F.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


MODELS = {"cnn": (init_cnn, apply_cnn), "mlp": (init_mlp, apply_mlp)}


def model_bytes(params, bits=32):
    n = sum(p.numel() for p in params.values())
    return n * bits / 8


def xent_loss(apply_fn, params, x, y):
    logits = apply_fn(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    return (logz - gold).mean()


@torch.no_grad()
def accuracy(apply_fn, params, x, y, batch=256):
    """Fraction of ``x`` classified as ``y``, evaluated ``batch`` samples
    at a time with one host sync at the end."""
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], batch):
        pred = apply_fn(params, x[i:i + batch]).argmax(-1)
        correct += (pred == y[i:i + batch]).sum()
    return int(correct) / x.shape[0]
