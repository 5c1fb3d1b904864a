"""K2: fused coordinate-wise sort + rank-weighted combine, hand-written for
Hopper.

``trimmed_agg_stacked(x, rw) = sum_r rw[r] * sort_asc(x[:, i])[r]`` — the
rank-based robust aggregation (coordinate-wise trimmed mean and median) of
a stacked cohort. It replaces the TPU kernel
``src/repro/kernels/trimmed_agg.py::trimmed_agg_stacked`` (Pallas). Its
kernel takes a table of leaves and a validity mask:
:func:`trimmed_agg_stacked_leaves` combines every leaf of one cohort with
one launch (up to ``TABLE_CAPACITY`` leaves a launch), the rows that the
mask marks invalid sorting as +inf without being read, and
:func:`trimmed_agg_stacked` is the same launch with a table of one and
every row valid. For K <= ``RANK_CAPACITY`` the rank weights and the mask
travel in the launch's parameter, so an aggregation copies nothing to the
card. The CUDA source is ``csrc/trimmed_agg.cu``: each value becomes an
order-preserving integer key, sorted in registers by Batcher's odd-even
merge network for K <= 32 and walked rank by rank for any larger K.

Invalid rows sort last as +inf; a rank whose weight is exactly 0
contributes exactly 0 (a select, never ``0 * inf``). NaN sorts after +inf,
as in ``torch.sort`` and the reference oracle's ``jnp.sort``.

The device decides the route, with no fallback: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes ``trimmed_agg_stacked_plain`` (per
leaf, on ``where(valid, x, inf)``), the plain version that mirrors the
reference oracle ``src/repro/kernels/ref.py::trimmed_agg_stacked_ref``.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`trimmed_agg_stacked` and
#: :func:`trimmed_agg_stacked_leaves` in this process (one a table)
launches = 0
#: leaves in one K2 launch (``kMaxLeaves`` in ``csrc/trimmed_agg.cu``)
TABLE_CAPACITY = 32
#: K up to which the rank weights and the validity mask travel by value
#: in the launch's parameter (``kMaxRanks``); above it both are read from
#: device memory
RANK_CAPACITY = 32

_SIGNATURES = {
    "trimmed_agg_leaves": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                            ctypes.c_void_p], ctypes.c_int),
    "trimmed_agg_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

#: one leaf of K2's launch table, laid out as ``RankLeaf`` in
#: ``csrc/trimmed_agg.cu``: the x and out pointers, n, the 16-byte flag
#: and a pad word
_LEAF = struct.Struct("=2Qqii")
#: what the leaves of a launch share, laid out as ``RankParams``: the rank
#: weights by value, the device addresses of the rank weights and of the
#: validity mask (0: by value), the mask's bits, the masked flag, K and a
#: pad word
_PARAMS = struct.Struct(f"={RANK_CAPACITY}f2QIiii")


def trimmed_agg_stacked_plain(x, rank_weights):
    """Plain PyTorch version: sum_r rw[r] * sort(x, 0)[r] (x (K,) + shape
    float32, rank_weights (K,) float32); zero-weight ranks select 0."""
    k = x.shape[0]
    srt = torch.sort(x.reshape(k, -1).to(torch.float32), dim=0).values
    rw = rank_weights.to(torch.float32)[:, None]
    terms = torch.where(rw != 0.0, rw * srt, 0.0)
    return terms.sum(0).reshape(x.shape[1:])


def _leaves(xs, outs=None):
    """Check one cohort's leaves: float32 (K,) + shape with one K >= 1 for
    every leaf, contiguous, all on one device. Return ``(K, tables)``:
    with ``outs`` (one (n,) float32 output per leaf), K2's launch tables,
    ``(bytes, count)`` per launch of at most ``TABLE_CAPACITY`` ``_LEAF``
    records, in order, empty leaves left out, the 16-byte flag set on the
    leaves of the vector path; without, no table. One pass, since this is
    the host work of every launch."""
    f32 = torch.float32
    dev = xs[0].device if xs else None
    k = xs[0].shape[0] if xs and xs[0].dim() else 0
    records = []
    for i, x in enumerate(xs):
        if x.dtype != f32:
            raise TypeError(f"trimmed_agg_stacked takes x float32; got "
                            f"{x.dtype}")
        if x.dim() < 1 or x.shape[0] != k or k < 1:
            raise ValueError(f"shapes: leaf {i} {tuple(x.shape)}; expected "
                             f"(K,) + shape with one K >= 1 for every leaf "
                             f"(K = {k})")
        if x.device != dev:
            raise ValueError("trimmed_agg_stacked: every leaf must be on "
                             "one device")
        if not x.is_contiguous():
            raise ValueError("trimmed_agg_stacked: every leaf must be "
                             "contiguous")
        n = x.numel() // k
        if outs is not None and n:
            px, po = x.data_ptr(), outs[i].data_ptr()
            records.append(_LEAF.pack(
                px, po, n, int(n % 4 == 0 and not (px | po) & 15), 0))
    return k, [(b"".join(records[i:i + TABLE_CAPACITY]),
                len(records[i:i + TABLE_CAPACITY]))
               for i in range(0, len(records), TABLE_CAPACITY)]


def _host_mask(valid, k):
    """The validity mask as a host bool array of K entries (None: every
    row valid). A mask on the card is refused: reading it back would wait
    for the stream."""
    if valid is None:
        return None
    if isinstance(valid, torch.Tensor) and valid.device.type != "cpu":
        raise TypeError(f"trimmed_agg_stacked takes the validity mask on "
                        f"the host, not on {valid.device}")
    mask = np.asarray(valid, dtype=bool)
    if mask.shape != (k,):
        raise ValueError(f"validity mask of shape {mask.shape}; expected "
                         f"({k},)")
    return mask


def _checked_weights(rank_weights, k, device):
    """The rank weights, checked: a tensor on the card must be float32
    (K,), contiguous, on the leaves' device, and is returned as it is; any
    other (a host array of K numbers; a tensor must be float32) comes back
    as a float32 numpy array."""
    if isinstance(rank_weights, torch.Tensor):
        if rank_weights.dtype != torch.float32:
            raise TypeError(f"trimmed_agg_stacked takes rank_weights "
                            f"float32; got {rank_weights.dtype}")
        if rank_weights.device.type != "cpu":
            if rank_weights.device != device:
                raise ValueError("x and rank_weights must be on one "
                                 "device")
            if rank_weights.shape != (k,) \
                    or not rank_weights.is_contiguous():
                raise ValueError(f"rank_weights "
                                 f"{tuple(rank_weights.shape)}; expected "
                                 f"({k},), contiguous")
            return rank_weights
    host = np.asarray(rank_weights, dtype=np.float32)
    if host.shape != (k,):
        raise ValueError(f"rank_weights {host.shape}; expected ({k},)")
    return host


def _rank_params(rank_weights, mask, k, device):
    """K2's shared launch parameter ``(bytes, keep)`` from checked rank
    weights and mask. Rank weights on the card go by address, host ones
    by value for K <= ``RANK_CAPACITY``, else copied to the card; the mask
    goes as bits for K <= ``RANK_CAPACITY``, else as a uint8 copy on the
    card. ``keep`` holds the copies until the launch is queued."""
    keep, by_value, rw_ptr = [], [0.0] * RANK_CAPACITY, 0
    bits, mask_ptr = 0, 0
    if isinstance(rank_weights, torch.Tensor):
        rw_ptr = rank_weights.data_ptr()
    elif k <= RANK_CAPACITY:
        by_value[:k] = rank_weights.tolist()
    else:
        keep.append(torch.as_tensor(rank_weights, device=device))
        rw_ptr = keep[-1].data_ptr()
    if mask is not None and k <= RANK_CAPACITY:
        bits = sum(1 << j for j in np.flatnonzero(mask).tolist())
    elif mask is not None:
        keep.append(torch.as_tensor(mask.astype(np.uint8), device=device))
        mask_ptr = keep[-1].data_ptr()
    return _PARAMS.pack(*by_value, rw_ptr, mask_ptr, bits,
                        int(mask is not None), k, 0), keep


def trimmed_agg_stacked(x, rank_weights):
    """sum_r rank_weights[r] * sort_asc(x, axis=0)[r], added in rank order
    from 0.0: :func:`trimmed_agg_stacked_leaves` of one leaf with every row
    valid (on the card a table of one)."""
    return trimmed_agg_stacked_leaves([x], rank_weights)[0]


def trimmed_agg_stacked_leaves(xs, rank_weights, valid=None):
    """``[sum_r rank_weights[r] * sort_asc(where(valid, x, inf),
    axis=0)[r] for x in xs]`` for every leaf of one cohort: xs float32 (K,)
    + shape with one K, contiguous, all on one device; rank_weights (K,),
    on the host or float32 on the leaves' device; valid None (every row
    valid) or K booleans on the host. CUDA tensors take one K2 launch per
    ``TABLE_CAPACITY`` leaves, an invalid row never read; CPU tensors take
    the plain version."""
    xs = list(xs)
    if not xs:
        return []
    dev = xs[0].device
    if dev.type == "cuda":
        outs = [torch.empty(x.shape[1:], dtype=torch.float32, device=dev)
                for x in xs]
        k, tables = _leaves(xs, outs)
        params, _keep = _rank_params(_checked_weights(rank_weights, k, dev),
                                     _host_mask(valid, k), k, dev)
        _launch(tables, params, dev)
        return outs
    k, _ = _leaves(xs)
    rw = _checked_weights(rank_weights, k, dev)
    mask = _host_mask(valid, k)
    if dev.type != "cpu":
        raise ValueError(f"trimmed_agg_stacked: no route for device {dev}")
    rw = torch.from_numpy(rw) if isinstance(rw, np.ndarray) else rw
    vt = None if mask is None else torch.from_numpy(mask)
    outs = []
    for x in xs:
        if vt is not None:
            x = torch.where(vt.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                            torch.inf)
        outs.append(trimmed_agg_stacked_plain(x, rw))
    return outs


def _launch(tables, params, device):
    global launches
    lib = _build.library("trimmed_agg", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for buf, count in tables:
            err = lib.trimmed_agg_leaves(buf, count, params, stream)
            if err != 0:
                raise RuntimeError("trimmed_agg_stacked launch failed: "
                                   + lib.trimmed_agg_error_string(err)
                                   .decode())
            launches += 1
