"""K5: sliding-window causal flash attention (forward), hand-written for
Hopper.

``swa_attention(q, k, v, window, causal)`` is softmax attention over the
keys j that row i may see (``j <= i`` when causal, ``j > i - window`` when
``window`` > 0), with scores scaled by ``hd ** -0.5``. It replaces the TPU
kernel ``src/repro/kernels/swa_attention.py::swa_attention`` (Pallas) and
the head repeat and transposes around it in the reference's
``kernels/ops.py::swa_flash_attention``: it takes the model's layout, q
(B, L, H, hd) and k, v (B, L, KH, hd) with KH dividing H, and reads kv head
h // (H / KH) in place. It has two device instances, both an online softmax
over the key tiles of the band only, with the output in q's type:

- ``csrc/swa_attention_tc.cu``: bfloat16 on the tensor cores (``wgmma``,
  K and V tiles brought in by TMA), for bfloat16 inputs whose hd is a
  multiple of 16 up to 128;
- ``csrc/swa_attention.cu``: float32 math on the CUDA cores, for float32
  inputs and every other bfloat16 shape.

:func:`route` states the rule.

The device decides the route, with no fallback: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes ``swa_attention_plain``, the plain
version that mirrors the reference oracle
``src/repro/kernels/ref.py::swa_attention_ref``. The route is the custom op
``torch.ops.repro_torch.swa_attention`` (``kernels/_custom.py``): its fake
implementation gives meta and fake tensors q's shape, so the dry run
traces this route; its DTensor rule passes batch shards through and head
shards where the kv heads split as the q heads do (or there is one kv
head). :func:`visited_blocks` counts the (q block, k block) pairs that the
reference's Pallas grid computes, which the dry run bills.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _custom

#: kernel launches made by :func:`swa_attention` in this process, both
#: instances
launches = 0
#: of those, launches of the tensor-core instance
tc_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "swa_attention": ([ctypes.c_void_p] * 6
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "swa_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_TC_SIGNATURES = {
    "swa_attention_tc": ([ctypes.c_void_p] * 6
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.c_void_p], ctypes.c_int),
    "swa_attention_tc_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def route(dtype, hd):
    """The device instance that takes inputs of ``dtype`` and head width
    ``hd``: "tensor_core" for bfloat16 with hd a multiple of 16 in [16,
    128], else "cuda_core" (float32 keeps its 2e-5 bar only without
    bfloat16 products)."""
    if dtype == torch.bfloat16 and hd % 16 == 0 and 16 <= hd <= 128:
        return "tensor_core"
    return "cuda_core"


def tma_ready(t):
    """True when TMA can read ``t`` (B, L, heads, hd) in place: a
    contiguous last axis, a 16-byte-aligned base and byte strides that are
    multiples of 16 on the other axes."""
    size = t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and all(t.stride(a) * size % 16 == 0 for a in range(3))


def band_mask(l, window, causal, device):
    """(l, l) bool, True where query row i may see key j."""
    qpos = torch.arange(l, device=device)[:, None]
    kpos = torch.arange(l, device=device)[None, :]
    m = torch.ones((l, l), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window:
        m = m & (kpos > qpos - window)
    return m


def swa_attention_plain(q, k, v, window=0, causal=True):
    """Plain PyTorch version: q (B, L, H, hd), k, v (B, L, KH, hd) ->
    (B, L, H, hd) in q's type, computed in float32 with masked scores at
    -1e30."""
    h, hd = q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) \
        * hd ** -0.5
    m = band_mask(q.shape[1], window, causal, q.device)
    s = torch.where(m, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)


def _check(q, k, v, window):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"swa_attention takes q, k, v of one type, float32 "
                        f"or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected q (B,L,H,hd) and "
                         "k = v (B,L,KH,hd) with KH dividing H")
    if int(window) < 0:
        raise ValueError(f"swa_attention: window {window} < 0")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def swa_attention(q, k, v, window=0, causal=True):
    """Sliding-window (``window`` > 0) or full attention, causal or not;
    see the module docstring. CUDA tensors launch the kernel; CPU tensors
    take the plain version; meta and fake tensors get q's shape."""
    _check(q, k, v, window)
    return torch.ops.repro_torch.swa_attention(q, k, v, int(window),
                                               bool(causal))


@torch.library.custom_op("repro_torch::swa_attention", mutates_args=())
def _swa_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int, causal: bool) -> torch.Tensor:
    raise ValueError(f"swa_attention: no route for device {q.device}")


@_swa_attention_op.register_kernel("cpu")
def _(q, k, v, window, causal):
    return swa_attention_plain(q, k, v, window, causal)


@_swa_attention_op.register_kernel("cuda")
def _(q, k, v, window, causal):
    return _launch(q, k, v, window, causal)


@_swa_attention_op.register_fake
def _(q, k, v, window, causal):
    return q.new_empty(q.shape)


_custom.plain_backward(_swa_attention_op, swa_attention_plain, 3)


def _sharding(q, k, v, window, causal):
    """One mesh dim's placements, out then (q, k, v, window, causal):
    replicated; batch shards; head shards, k and v split by kv head (the
    GQA groups then divide) or, with one kv head, replicated. DTensor
    drops the head strategy on a mesh dim that does not divide the kv
    heads; where it divides the query heads, the dry run repeats each
    rank's kv groups out to its heads and runs K5 there with a group of
    one (``launch.dryrun._k5_head_shards``), and where it divides
    neither (qwen3-14b's 40 heads of 8 on 16 ranks) DTensor gathers the
    heads and each rank runs K5 on all of them. The sequence is never
    split."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    kv = Shard(2) if k.shape[2] > 1 else R
    return [([R], [R, R, R, None, None]),
            ([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None]),
            ([Shard(2)], [Shard(2), kv, kv, None, None])]


def register_sharding():
    """K5's DTensor sharding rule (:func:`_sharding`), registered once."""
    _custom.register_sharding(torch.ops.repro_torch.swa_attention.default,
                              _sharding)


#: the reference kernel's q and k block (``bq``, ``bk`` of
#: ``src/repro/kernels/swa_attention.py::swa_attention``)
REF_BLOCK = 128


@functools.lru_cache(maxsize=None)
def visited_blocks(l, window, causal, block=REF_BLOCK):
    """(q block, k block) pairs of an ``l``-row sequence whose product the
    reference's Pallas grid computes (its ``pl.when(needed)``): blocks of
    ``min(block, l)`` rows, a pair skipped when no key of the k block is
    visible from the q block."""
    bq = bk = min(block, l)
    n_q, n_kv = -(-l // bq), -(-l // bk)
    total = 0
    for qi in range(n_q):
        hi = n_kv - 1
        if causal:
            hi = min(hi, (qi * bq + bq - 1) // bk)
        lo = 0
        if window:
            # k_start + bk - 1 > q_start - window
            lo = max(0, (qi * bq - window - bk + 1) // bk + 1)
        total += max(0, hi - lo + 1)
    return total


def band_flops(q, k, window, causal):
    """The matmul FLOPs of the reference kernel's grid on q (B, L, H, hd):
    q·kᵀ and p·v, 2·bq·bk·hd each, over every visited block pair of every
    (batch, head)."""
    b, l, h, hd = q.shape
    bq = min(REF_BLOCK, l)
    return 4.0 * b * h * visited_blocks(l, int(window), bool(causal)) \
        * bq * bq * hd


def _launch(q, k, v, window, causal):
    global launches, tc_launches
    tc = route(q.dtype, q.shape[3]) == "tensor_core"
    # the kernels read the first three axes through their strides; a
    # tensor they cannot read in place is copied (a contiguous tensor off
    # the 16-byte grid too, which .contiguous() would hand back as it is)
    ready = tma_ready if tc else (lambda t: t.stride(3) == 1)
    q, k, v = (t if ready(t)
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    b, l, h, hd = q.shape
    out = torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    dims = (ctypes.c_int64 * 5)(b, l, h, k.shape[2], hd)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            lib = _build.library("swa_attention_tc", _TC_SIGNATURES)
            err = lib.swa_attention_tc(*ptrs, dims, strides, window,
                                       int(causal), hd ** -0.5, stream)
            what = lib.swa_attention_tc_error_string
        else:
            lib = _build.library("swa_attention", _SIGNATURES)
            err = lib.swa_attention(*ptrs, dims, strides, window,
                                    int(causal), _DTYPES[q.dtype],
                                    hd ** -0.5, stream)
            what = lib.swa_attention_error_string
    if err != 0:
        raise RuntimeError("swa_attention launch failed: "
                           + what(err).decode())
    launches += 1
    tc_launches += tc
    return out
