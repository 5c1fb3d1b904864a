"""Pieces the plain references share: float32 math with TF32 off, and the
lower-precision matmul the correctness control computes in.

The references import ``torch`` alone: nothing of the program, and
nothing the program made. They take the benchmark's own weights (a dict
of dotted path -> tensor, see ``portbench.weights``) and inputs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0        # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for matmuls and cuDNN (on
    the card a float32 matmul may otherwise run in TF32)."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def fp8_round(x):
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude onto the format's largest value), back in x's type;
    in a gradient, the rounding passes the gradient straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-12).to(torch.float32)
    s = FP8_MAX / amax
    q = (x.detach().to(torch.float32) * s).to(torch.float8_e4m3fn) \
        .to(torch.float32) / s
    return x + (q.to(x.dtype) - x).detach()


class Precision:
    """The precision of the references' weight products: "float32" (the
    reference) or "fp8" (the control: both operands of every product with
    a weight rounded to float8 e4m3, the step below the configuration's
    bfloat16; the sums stay float32)."""

    def __init__(self, name="float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a, w):
        if self.name == "fp8":
            a, w = fp8_round(a), fp8_round(w)
        return a @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def silu(x):
    return F.silu(x)
