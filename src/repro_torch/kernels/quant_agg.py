"""K1 and K3: fused QuAFL dequantize + accumulate, hand-written for Hopper.

K1, ``quant_agg_stacked(acc, q, sw) = acc + sum_k sw[k] * float(q[k])``:
the server-side aggregation of a whole quantized cohort, one launch per
parameter leaf. It replaces the TPU kernel
``src/repro/kernels/quant_agg.py::quant_agg_stacked`` (Pallas).

K3, ``quant_agg(acc, q, scale, weight) = acc + (weight * scale) *
float(q)``: one model's step of the streamed in-place aggregation (paper
Fig. 7). It replaces ``src/repro/kernels/quant_agg.py::quant_agg``
(Pallas). ``weight * scale`` is formed once in float32, on the device.

Both live in ``csrc/quant_agg.cu``: a single vectorised pass bound by HBM
bytes, with no dequantised copy of any model. The device decides the
route, with no fallback: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes the plain version (``quant_agg_stacked_plain``,
``quant_agg_plain``), which mirrors the reference oracle
(``src/repro/kernels/ref.py::quant_agg_stacked_ref``, ``quant_agg_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`quant_agg_stacked` (K1) in this process
launches = 0
#: kernel launches made by :func:`quant_agg` (K3) in this process
single_launches = 0

_SIGNATURES = {
    "quant_agg_stacked": ([ctypes.c_void_p] * 4
                          + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
                          ctypes.c_int),
    "quant_agg": ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p],
                  ctypes.c_int),
    "quant_agg_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def quant_agg_stacked_plain(acc, q, sw):
    """Plain PyTorch version: acc + sum_k sw[k] * q[k] (acc any shape,
    q (K,) + acc.shape int32, sw (K,) float32)."""
    k = q.shape[0]
    deq = sw.to(torch.float32).reshape(k, 1) \
        * q.reshape(k, -1).to(torch.float32)
    return acc + deq.sum(0).reshape(acc.shape)


def _check(acc, q, sw):
    if acc.dtype != torch.float32 or q.dtype != torch.int32 \
            or sw.dtype != torch.float32:
        raise TypeError(f"quant_agg_stacked takes acc float32, q int32, sw "
                        f"float32; got {acc.dtype}, {q.dtype}, {sw.dtype}")
    if q.dim() != acc.dim() + 1 or q.shape[1:] != acc.shape \
            or sw.shape != (q.shape[0],):
        raise ValueError(f"shapes: acc {tuple(acc.shape)}, q "
                         f"{tuple(q.shape)}, sw {tuple(sw.shape)}; expected "
                         "q (K,) + acc.shape and sw (K,)")
    if not (acc.device == q.device == sw.device):
        raise ValueError("acc, q and sw must be on one device")
    if not (acc.is_contiguous() and q.is_contiguous()
            and sw.is_contiguous()):
        raise ValueError("acc, q and sw must be contiguous")


def quant_agg_stacked(acc, q, sw):
    """acc + sum_k sw[k] * float(q[k]), summed over k in order from acc.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    _check(acc, q, sw)
    if acc.device.type == "cpu":
        return quant_agg_stacked_plain(acc, q, sw)
    if acc.device.type != "cuda":
        raise ValueError(f"quant_agg_stacked: no route for device "
                         f"{acc.device}")
    return _launch(acc, q, sw)


def _launch(acc, q, sw):
    global launches
    lib = _build.library("quant_agg", _SIGNATURES)
    out = torch.empty_like(acc)
    if acc.numel() == 0:
        return out
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.quant_agg_stacked(acc.data_ptr(), q.data_ptr(),
                                    sw.data_ptr(), out.data_ptr(),
                                    acc.numel(), q.shape[0], stream)
    if err != 0:
        raise RuntimeError("quant_agg_stacked launch failed: "
                           + lib.quant_agg_error_string(err).decode())
    launches += 1
    return out


# -- K3: one model -------------------------------------------------------


def _pair(acc, weight, scale):
    """[weight, scale] as a (2,) float32 tensor on ``acc``'s device. A
    Python number becomes a device fill (no copy from the host), a tensor
    is moved as it is, so a device-scalar scale costs no host sync."""
    def one(v):
        if isinstance(v, torch.Tensor):
            if v.numel() != 1:
                raise ValueError(f"quant_agg: scale and weight must be "
                                 f"scalars, got shape {tuple(v.shape)}")
            return v.to(device=acc.device, dtype=torch.float32).reshape(1)
        return torch.full((1,), float(v), dtype=torch.float32,
                          device=acc.device)
    return torch.cat([one(weight), one(scale)])


def quant_agg_plain(acc, q, ws):
    """Plain PyTorch version: acc + (ws[0] * ws[1]) * float(q), with
    ws = [weight, scale] (2,) float32."""
    return acc + (ws[0] * ws[1]) * q.to(torch.float32)


def quant_agg(acc, q, scale, weight):
    """acc + (weight * scale) * float(q) for one model: acc float32 and q
    int32 of one shape (any), scale and weight Python numbers or 0-d
    tensors. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if acc.dtype != torch.float32 or q.dtype != torch.int32:
        raise TypeError(f"quant_agg takes acc float32 and q int32; got "
                        f"{acc.dtype}, {q.dtype}")
    if q.shape != acc.shape:
        raise ValueError(f"shapes: acc {tuple(acc.shape)}, q "
                         f"{tuple(q.shape)}; expected equal")
    if acc.device != q.device:
        raise ValueError("acc and q must be on one device")
    if not (acc.is_contiguous() and q.is_contiguous()):
        raise ValueError("acc and q must be contiguous")
    ws = _pair(acc, weight, scale)
    if acc.device.type == "cpu":
        return quant_agg_plain(acc, q, ws)
    if acc.device.type != "cuda":
        raise ValueError(f"quant_agg: no route for device {acc.device}")
    return _launch_single(acc, q, ws)


def _launch_single(acc, q, ws):
    global single_launches
    lib = _build.library("quant_agg", _SIGNATURES)
    out = torch.empty_like(acc)
    if acc.numel() == 0:
        return out
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.quant_agg(acc.data_ptr(), q.data_ptr(), ws.data_ptr(),
                            out.data_ptr(), acc.numel(), stream)
    if err != 0:
        raise RuntimeError("quant_agg launch failed: "
                           + lib.quant_agg_error_string(err).decode())
    single_launches += 1
    return out
