"""K2: fused coordinate-wise sort + rank-weighted combine, hand-written for
Hopper.

``trimmed_agg_stacked(x, rw) = sum_r rw[r] * sort_asc(x[:, i])[r]`` — the
rank-based robust aggregation (coordinate-wise trimmed mean and median) of
a whole stacked cohort, one launch per parameter leaf. It replaces the TPU
kernel ``src/repro/kernels/trimmed_agg.py::trimmed_agg_stacked`` (Pallas).
The CUDA source is ``csrc/trimmed_agg.cu``: one thread per coordinate,
the cohort sorted in registers for K <= 32 and walked rank by rank for
any larger K.

Pad and invalid rows arrive as +inf and sort last; a rank whose weight is
exactly 0 contributes exactly 0 (a select, never ``0 * inf``). NaN sorts
after +inf, as in ``torch.sort`` and the reference oracle's ``jnp.sort``.

The device decides the route, with no fallback: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes ``trimmed_agg_stacked_plain``, the
plain version that mirrors the reference oracle
``src/repro/kernels/ref.py::trimmed_agg_stacked_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`trimmed_agg_stacked` in this process
launches = 0

_SIGNATURES = {
    "trimmed_agg_stacked": ([ctypes.c_void_p] * 3
                            + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
                            ctypes.c_int),
    "trimmed_agg_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def trimmed_agg_stacked_plain(x, rank_weights):
    """Plain PyTorch version: sum_r rw[r] * sort(x, 0)[r] (x (K,) + shape
    float32, rank_weights (K,) float32); zero-weight ranks select 0."""
    k = x.shape[0]
    srt = torch.sort(x.reshape(k, -1).to(torch.float32), dim=0).values
    rw = rank_weights.to(torch.float32)[:, None]
    terms = torch.where(rw != 0.0, rw * srt, 0.0)
    return terms.sum(0).reshape(x.shape[1:])


def _check(x, rank_weights):
    if x.dtype != torch.float32 or rank_weights.dtype != torch.float32:
        raise TypeError(f"trimmed_agg_stacked takes x and rank_weights "
                        f"float32; got {x.dtype}, {rank_weights.dtype}")
    if x.dim() < 1 or x.shape[0] < 1 \
            or rank_weights.shape != (x.shape[0],):
        raise ValueError(f"shapes: x {tuple(x.shape)}, rank_weights "
                         f"{tuple(rank_weights.shape)}; expected x (K,) + "
                         "shape with K >= 1 and rank_weights (K,)")
    if x.device != rank_weights.device:
        raise ValueError("x and rank_weights must be on one device")
    if not (x.is_contiguous() and rank_weights.is_contiguous()):
        raise ValueError("x and rank_weights must be contiguous")


def trimmed_agg_stacked(x, rank_weights):
    """sum_r rank_weights[r] * sort_asc(x, axis=0)[r], added in rank order
    from 0.0. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    _check(x, rank_weights)
    if x.device.type == "cpu":
        return trimmed_agg_stacked_plain(x, rank_weights)
    if x.device.type != "cuda":
        raise ValueError(f"trimmed_agg_stacked: no route for device "
                         f"{x.device}")
    return _launch(x, rank_weights)


def _launch(x, rank_weights):
    global launches
    lib = _build.library("trimmed_agg", _SIGNATURES)
    out = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trimmed_agg_stacked(x.data_ptr(), rank_weights.data_ptr(),
                                      out.data_ptr(), out.numel(), x.shape[0],
                                      stream)
    if err != 0:
        raise RuntimeError("trimmed_agg_stacked launch failed: "
                           + lib.trimmed_agg_error_string(err).decode())
    launches += 1
    return out
