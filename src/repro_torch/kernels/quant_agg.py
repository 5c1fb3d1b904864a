"""K1 and K3: fused QuAFL dequantize + accumulate, hand-written for Hopper.

K1, ``quant_agg_stacked(acc, q, sw) = acc + sum_k sw[k] * float(q[k])``:
the server-side aggregation of a whole quantized cohort. It replaces the
TPU kernel ``src/repro/kernels/quant_agg.py::quant_agg_stacked`` (Pallas).
Its kernel takes a table of leaves: :func:`quant_agg_stacked_inplace`
updates every leaf of one cohort in place with one launch (up to
``TABLE_CAPACITY`` leaves a launch), and :func:`quant_agg_stacked` is the
same launch with a table of one, writing a new tensor.

K3, ``quant_agg(acc, q, scale, weight) = acc + (weight * scale) *
float(q)``: one model's step of the streamed in-place aggregation (paper
Fig. 7). It replaces ``src/repro/kernels/quant_agg.py::quant_agg``
(Pallas). ``weight * scale`` is formed in float32, on the device. Its
kernel takes a table of leaves too: :func:`quant_agg_inplace` updates
every leaf of one model in place with one launch, and :func:`quant_agg`
is a table of one, writing a new tensor.

Both live in ``csrc/quant_agg.cu``: a single vectorised pass bound by HBM
bytes, with no dequantised copy of any model. A table computes bitwise
what one launch per leaf computes. The device decides the route, with no
fallback: a CUDA tensor launches the kernel (or raises), a CPU tensor
takes the plain version (``quant_agg_stacked_plain``,
``quant_agg_plain``), which mirrors the reference oracle
(``src/repro/kernels/ref.py::quant_agg_stacked_ref``, ``quant_agg_ref``).
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`quant_agg_stacked` and
#: :func:`quant_agg_stacked_inplace` (K1) in this process
launches = 0
#: kernel launches made by :func:`quant_agg` and :func:`quant_agg_inplace`
#: (K3) in this process
single_launches = 0
#: leaves in one K1 or K3 launch (``kMaxLeaves`` in ``csrc/quant_agg.cu``)
TABLE_CAPACITY = 32

_SIGNATURES = {
    "quant_agg_stacked": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p], ctypes.c_int),
    "quant_agg_leaves": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p], ctypes.c_int),
    "quant_agg_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def quant_agg_stacked_plain(acc, q, sw):
    """Plain PyTorch version: acc + sum_k sw[k] * q[k] (acc any shape,
    q (K,) + acc.shape int32, sw (K,) float32)."""
    k = q.shape[0]
    deq = sw.to(torch.float32).reshape(k, 1) \
        * q.reshape(k, -1).to(torch.float32)
    return acc + deq.sum(0).reshape(acc.shape)


# -- K1: one cohort, a table of leaves -----------------------------------

#: one leaf of K1's launch table, laid out as ``StackedLeaf`` in
#: ``csrc/quant_agg.cu``: the acc, q, sw and out pointers, n, the 16-byte
#: flag and a pad word
_STACKED_LEAF = struct.Struct("=4Qqii")


def _stacked_leaves(accs, qs, sws, outs=None, pack=False):
    """Check one cohort's leaves (``outs`` None: each acc is written in
    place): acc and out float32 of one shape, q int32 (K,) + that shape
    with one K for all leaves, sw float32 (K,), all contiguous and on one
    device. With ``pack``, return K1's launch tables, ``(bytes, count)``
    per launch of at most ``TABLE_CAPACITY`` ``_STACKED_LEAF`` records, in
    order, empty leaves left out, the 16-byte flag set on the leaves of the
    vector path. One pass, since this is the host work of every launch."""
    if len(qs) != len(accs) or len(sws) != len(accs) \
            or (outs is not None and len(outs) != len(accs)):
        raise ValueError(f"quant_agg_stacked: {len(accs)} accumulators, "
                         f"{len(qs)} codes, {len(sws)} weight rows")
    f32, i32 = torch.float32, torch.int32
    dev = accs[0].get_device() if accs else -1
    k = qs[0].shape[0] if qs and qs[0].dim() else -1
    records = []
    for acc, q, sw, out in zip(accs, qs, sws, accs if outs is None else outs):
        if acc.dtype != f32 or q.dtype != i32 or sw.dtype != f32 \
                or out.dtype != f32:
            raise TypeError(f"quant_agg_stacked takes acc float32, q int32, "
                            f"sw float32; got {acc.dtype}, {q.dtype}, "
                            f"{sw.dtype}")
        if q.dim() != acc.dim() + 1 or q.shape[1:] != acc.shape \
                or q.shape[0] != k or sw.shape != (k,) \
                or out.shape != acc.shape:
            raise ValueError(f"shapes: acc {tuple(acc.shape)}, q "
                             f"{tuple(q.shape)}, sw {tuple(sw.shape)}; "
                             f"expected q ({k},) + acc.shape and sw ({k},)")
        if acc.get_device() != dev or q.get_device() != dev \
                or sw.get_device() != dev or out.get_device() != dev:
            raise ValueError("acc, q and sw must be on one device")
        if not (acc.is_contiguous() and q.is_contiguous()
                and sw.is_contiguous() and out.is_contiguous()):
            raise ValueError("acc, q and sw must be contiguous")
        n = acc.numel()
        if pack and n:
            pa, pq, po = acc.data_ptr(), q.data_ptr(), out.data_ptr()
            records.append(_STACKED_LEAF.pack(
                pa, pq, sw.data_ptr(), po, n,
                int(n % 4 == 0 and not (pa | pq | po) & 15), 0))
    return [(b"".join(records[i:i + TABLE_CAPACITY]),
             len(records[i:i + TABLE_CAPACITY]))
            for i in range(0, len(records), TABLE_CAPACITY)]


def quant_agg_stacked(acc, q, sw):
    """acc + sum_k sw[k] * float(q[k]), summed over k in order from acc, as
    a new tensor. CUDA tensors launch the kernel (a table of one); CPU
    tensors take the plain version."""
    if acc.device.type == "cpu":
        _stacked_leaves([acc], [q], [sw])
        return quant_agg_stacked_plain(acc, q, sw)
    if acc.device.type != "cuda":
        raise ValueError(f"quant_agg_stacked: no route for device "
                         f"{acc.device}")
    out = torch.empty_like(acc)
    _launch_stacked(_stacked_leaves([acc], [q], [sw], [out], pack=True),
                    q.shape[0], acc.device)
    return out


def quant_agg_stacked_inplace(accs, qs, sws):
    """``accs[i] += sum_k sws[i][k] * float(qs[i][k])`` for every leaf of
    one cohort, in place: accs float32, qs int32 (K,) + accs[i].shape with
    one K, sws float32 (K,), contiguous, all on one device. CUDA tensors
    take one K1 launch per ``TABLE_CAPACITY`` leaves; CPU tensors take the
    plain version."""
    dev = accs[0].device if accs else torch.device("cpu")
    if dev.type == "cuda":
        _launch_stacked(_stacked_leaves(accs, qs, sws, pack=True),
                        qs[0].shape[0], dev)
        return
    _stacked_leaves(accs, qs, sws)
    if dev.type != "cpu":
        raise ValueError(f"quant_agg_stacked: no route for device {dev}")
    for acc, q, sw in zip(accs, qs, sws):
        acc.copy_(quant_agg_stacked_plain(acc, q, sw))


def _launch_stacked(tables, k, device):
    global launches
    lib = _build.library("quant_agg", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for buf, count in tables:
            err = lib.quant_agg_stacked(buf, count, k, stream)
            if err != 0:
                raise RuntimeError("quant_agg_stacked launch failed: "
                                   + lib.quant_agg_error_string(err).decode())
            launches += 1


# -- K3: one model, a table of leaves ------------------------------------

#: one leaf of K3's launch table, laid out as ``Leaf`` in
#: ``csrc/quant_agg.cu``: the acc, q, out and scale pointers (scale 0: use
#: the host scale), the host scale (float32), the 16-byte flag and n
_LEAF = struct.Struct("=4Qfiq")


def _leaves(accs, qs, scales, outs=None, pack=False):
    """Check one model's leaves (``outs`` None: each acc is written in
    place): acc and out float32, q int32, of one shape, contiguous, all on
    one device; each scale a number or a one-element tensor (float32 when
    it lies on the card beside the leaves). With ``pack``, return K3's
    launch tables, ``(bytes, count)`` per launch of at most
    ``TABLE_CAPACITY`` ``_LEAF`` records, in order, empty leaves left out:
    a scale that is a tensor on the leaves' device goes by address, any
    other as a host float32, and the 16-byte flag marks the leaves of the
    vector path. One pass, since this is the host work of every launch."""
    if len(qs) != len(accs) or len(scales) != len(accs) \
            or (outs is not None and len(outs) != len(accs)):
        raise ValueError(f"quant_agg: {len(accs)} accumulators, {len(qs)} "
                         f"codes, {len(scales)} scales")
    f32, i32, tensor = torch.float32, torch.int32, torch.Tensor
    dev = accs[0].get_device() if accs else -1
    records = []
    for acc, q, out, scale in zip(accs, qs, accs if outs is None else outs,
                                  scales):
        if acc.dtype != f32 or q.dtype != i32 or out.dtype != f32:
            raise TypeError(f"quant_agg takes acc float32 and q int32; got "
                            f"{acc.dtype}, {q.dtype}")
        if q.shape != acc.shape or out.shape != acc.shape:
            raise ValueError(f"shapes: acc {tuple(acc.shape)}, q "
                             f"{tuple(q.shape)}; expected equal")
        if acc.get_device() != dev or q.get_device() != dev \
                or out.get_device() != dev:
            raise ValueError("quant_agg: acc and q of every leaf must be on "
                             "one device")
        if not (acc.is_contiguous() and q.is_contiguous()
                and out.is_contiguous()):
            raise ValueError("acc and q must be contiguous")
        sp = 0
        if isinstance(scale, tensor):
            if scale.numel() != 1:
                raise ValueError(f"quant_agg: scale and weight must be "
                                 f"scalars, got shape {tuple(scale.shape)}")
            if scale.get_device() == dev:
                if dev >= 0 and scale.dtype != f32:
                    raise TypeError(f"quant_agg: a device scale must be "
                                    f"float32, got {scale.dtype}")
                sp = scale.data_ptr()
        n = acc.numel()
        if pack and n:
            pa, pq, po = acc.data_ptr(), q.data_ptr(), out.data_ptr()
            records.append(_LEAF.pack(
                pa, pq, po, sp, 0.0 if sp else float(scale),
                int(n % 4 == 0 and not (pa | pq | po) & 15), n))
    return [(b"".join(records[i:i + TABLE_CAPACITY]),
             len(records[i:i + TABLE_CAPACITY]))
            for i in range(0, len(records), TABLE_CAPACITY)]


def _host_weight(weight):
    """The weight as a host float: a number or a CPU tensor. A weight on
    the card is refused: reading it back would wait for the stream."""
    if isinstance(weight, torch.Tensor) and weight.device.type != "cpu":
        raise TypeError(f"quant_agg on the card takes weight as a number, "
                        f"not a tensor on {weight.device}")
    return float(weight)


def quant_agg_plain(acc, q, scale, weight):
    """Plain PyTorch version of one leaf: acc + (weight * scale) *
    float(q), with weight * scale one float32 product."""
    ws = torch.as_tensor(weight, dtype=torch.float32) \
        * torch.as_tensor(scale, dtype=torch.float32)
    return acc + ws.to(acc.device) * q.to(torch.float32)


def quant_agg_inplace(accs, qs, scales, weight):
    """``accs[i] += (weight * scales[i]) * float(qs[i])`` for every leaf of
    one model, in place: accs float32 and qs int32 of matching shapes,
    contiguous, all on one device; scales Python numbers or 0-d tensors
    (float32 on the card), weight a Python number. CUDA tensors take one
    K3 launch per ``TABLE_CAPACITY`` leaves; CPU tensors take the plain
    version."""
    dev = accs[0].device if accs else torch.device("cpu")
    if dev.type == "cuda":
        _launch_tables(_leaves(accs, qs, scales, pack=True),
                       _host_weight(weight), dev)
        return
    _leaves(accs, qs, scales)
    if dev.type != "cpu":
        raise ValueError(f"quant_agg: no route for device {dev}")
    for acc, q, scale in zip(accs, qs, scales):
        acc.copy_(quant_agg_plain(acc, q, scale, weight))


def quant_agg(acc, q, scale, weight):
    """acc + (weight * scale) * float(q) for one tensor, as a new tensor:
    acc float32 and q int32 of one shape (any), scale a Python number or a
    0-d tensor, weight a Python number (on the CPU route also a 0-d
    tensor). CUDA tensors launch the kernel (a table of one); CPU tensors
    take the plain version."""
    if acc.device.type == "cpu":
        _leaves([acc], [q], [scale])
        return quant_agg_plain(acc, q, scale, weight)
    if acc.device.type != "cuda":
        raise ValueError(f"quant_agg: no route for device {acc.device}")
    out = torch.empty_like(acc)
    _launch_tables(_leaves([acc], [q], [scale], [out], pack=True),
                   _host_weight(weight), acc.device)
    return out


def _launch_tables(tables, weight, device):
    global single_launches
    lib = _build.library("quant_agg", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for buf, count in tables:
            err = lib.quant_agg_leaves(buf, count, weight, stream)
            if err != 0:
                raise RuntimeError("quant_agg launch failed: "
                                   + lib.quant_agg_error_string(err).decode())
            single_launches += 1
