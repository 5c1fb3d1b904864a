"""K4: the Mamba-2 SSD intra-chunk kernel, hand-written for Hopper.

``ssd_chunk(x, dt, A, B, C) -> (y_diag, states)`` computes, per (batch,
chunk, head), the quadratic-in-chunk part of the SSD algorithm
(arXiv:2405.21060 §6): ``cs = cumsum(dt * A)``; ``y_diag = (C B^T ∘ L ∘
dt) x`` with the causal decay ``L[i, j] = exp(cs[i] - cs[j])`` for j <= i;
``states = x^T (B * dt * exp(cs[-1] - cs))``. It replaces the TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_chunk_pallas`` (Pallas). It has two
device instances, one launch a call, both float32 in and out:

- ``csrc/ssd_scan_tc.cu``: the tensor cores (``mma.sync`` TF32 with each
  product split in three, big·big + big·small + small·big, which keeps
  float32 accuracy), one block per (batch, chunk, head) slice walking the
  lower triangle of 64 x 64 tiles, for p, n <= 128 where its tiles fit
  one block's shared memory (c <= 832 at p = n = 128);
- ``csrc/ssd_scan.cu``: the CUDA cores, for every other shape.

:func:`route` states the rule.

B and C may come at group width, (b, nc, c, g, n) with g dividing h, or
head-repeated (g = h, the reference's form); head h reads group
h // (h / g). The inter-chunk recurrence stays framework code
(``kernels/ops.py::ssd_chunked_kernel``), as in the reference.

The device decides the route, with no fallback: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes ``ssd_chunk_plain``, the plain
version that mirrors the reference oracle
``src/repro/kernels/ref.py::ssd_chunk_ref``. The route is the custom op
``torch.ops.repro_torch.ssd_chunk`` (``kernels/_custom.py``): its fake
implementation gives meta and fake tensors the two outputs' shapes, so
the dry run traces this route; its DTensor rule passes batch, chunk and
head shards through, with B and C replicated over a head shard when
there is one group and sharded like the heads when the groups divide.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _custom

#: kernel launches made by :func:`ssd_chunk` in this process, both
#: instances
launches = 0
#: of those, launches of the tensor-core instance
tc_launches = 0

#: the tensor-core instance's limits (``kMaxPN``, ``kSmemMax`` in
#: ``csrc/ssd_scan_tc.cu``)
TC_MAX_PN, TC_SMEM_MAX = 128, 232448

_SIGNATURES = {
    "ssd_chunk": ([ctypes.c_void_p] * 10, ctypes.c_int),
    "ssd_chunk_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_TC_SIGNATURES = {
    "ssd_chunk_tc": ([ctypes.c_void_p] * 10, ctypes.c_int),
    "ssd_chunk_tc_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def tc_smem_bytes(c, p, n):
    """Shared memory of one tensor-core block (``smem_floats`` in
    ``csrc/ssd_scan_tc.cu``): cs, dt and decay over c rounded to 64; two
    C, two B and two x tiles of 64 rows at padded widths; the 64 x 68 W
    stage."""
    def up(v, m):
        return -(-v // m) * m
    return 4 * (3 * up(c, 64) + 4 * 64 * (up(n, 8) + 4)
                + 2 * 64 * (up(p, 16) + 8) + 64 * 68)


def route(c, p, n):
    """The device instance that takes a chunk of ``c`` rows, head width
    ``p`` and state width ``n``: "tensor_core" for p, n <= 128 where its
    tiles fit one block's shared memory, else "cuda_core"."""
    if p <= TC_MAX_PN and n <= TC_MAX_PN \
            and tc_smem_bytes(c, p, n) <= TC_SMEM_MAX:
        return "tensor_core"
    return "cuda_core"


def _heads(t, h):
    """B or C at group width (b, nc, c, g, n) -> head width (b, nc, c, h, n)."""
    rep = h // t.shape[3]
    return t if rep == 1 else t.repeat_interleave(rep, dim=3)


def ssd_chunk_plain(x, dt, A, B, C):
    """Plain PyTorch version (all float32): x (b, nc, c, h, p); dt (b, nc,
    c, h); A (h,); B, C (b, nc, c, g, n) with g dividing h. Returns
    (y_diag (b, nc, c, h, p), states (b, nc, h, p, n))."""
    B, C = _heads(B, x.shape[3]), _heads(C, x.shape[3])
    dA = dt * A
    cs = torch.cumsum(dA, dim=2)
    seg = cs[..., :, None, :] - cs[..., None, :, :]      # (b,nc,c,c,h)
    c = dt.shape[2]
    cmask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                  device=x.device))
    L = torch.where(cmask[None, None, :, :, None], torch.exp(seg), 0.0)
    CB = torch.einsum("bzihn,bzjhn->bzijh", C, B)
    W = CB * L * dt[:, :, None, :, :]
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", W, x)
    decay = torch.exp(cs[:, :, -1:, :] - cs)             # (b,nc,c,h)
    states = torch.einsum("bzchn,bzch,bzchp->bzhpn", B, dt * decay, x)
    return y_diag, states


def _check(x, dt, A, B, C):
    ts = (x, dt, A, B, C)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_chunk takes float32 x, dt, A, B, C; got "
                        + ", ".join(str(t.dtype) for t in ts))
    if x.dim() != 5 or dt.dim() != 4 or A.dim() != 1 or B.dim() != 5 \
            or C.shape != B.shape:
        raise ValueError(f"shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}; expected x (b,nc,c,h,p), dt "
                         "(b,nc,c,h), A (h,), B = C (b,nc,c,g,n)")
    b, nc, c, h, _ = x.shape
    g = B.shape[3]
    if dt.shape != (b, nc, c, h) or A.shape != (h,) \
            or B.shape[:3] != (b, nc, c) or g < 1 or h % g:
        raise ValueError(f"shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, B {tuple(B.shape)}; dt must "
                         "be x's (b,nc,c,h), A (h,), B (b,nc,c,g,n) with g "
                         "dividing h")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, dt, A, B and C must be on one device")


def ssd_chunk(x, dt, A, B, C):
    """(y_diag, states) of the SSD intra-chunk stage; see the module
    docstring. CUDA tensors launch the kernel; CPU tensors take the plain
    version; meta and fake tensors get the outputs' shapes."""
    _check(x, dt, A, B, C)
    return torch.ops.repro_torch.ssd_chunk(x, dt, A, B, C)


@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=())
def _ssd_chunk_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    raise ValueError(f"ssd_chunk: no route for device {x.device}")


@_ssd_chunk_op.register_kernel("cpu")
def _(x, dt, A, B, C):
    return ssd_chunk_plain(x, dt, A, B, C)


@_ssd_chunk_op.register_kernel("cuda")
def _(x, dt, A, B, C):
    return _launch(x, dt, A, B, C)


@_ssd_chunk_op.register_fake
def _(x, dt, A, B, C):
    b, nc, c, h, p = x.shape
    return (x.new_empty((b, nc, c, h, p)),
            x.new_empty((b, nc, h, p, B.shape[4])))


_custom.plain_backward(_ssd_chunk_op, ssd_chunk_plain, 5)


def _sharding(x, dt, A, B, C):
    """One mesh dim's placements, (y_diag, states) then (x, dt, A, B, C):
    replicated; batch or chunk shards, which every operand shares; head
    shards, with A's heads and B, C replicated (one group, which every
    head reads) or sharded by group (the groups split as the heads do)."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    rules = [([R, R], [R, R, R, R, R])]
    for d in (0, 1):
        rules.append(([Shard(d), Shard(d)], [Shard(d), Shard(d), R,
                                             Shard(d), Shard(d)]))
    g = Shard(3) if B.shape[3] > 1 else R
    rules.append(([Shard(3), Shard(2)], [Shard(3), Shard(3), Shard(0), g,
                                         g]))
    return rules


def chunk_flops(x, B):
    """The matmul FLOPs of the reference kernel's grid on x (b, nc, c, h,
    p) and B (b, nc, c, g, n): per (batch, chunk, head), C·Bᵀ (c x n x
    c), (C·Bᵀ ∘ L ∘ dt)·x (c x c x p) and the chunk state (p x c x n), 2
    FLOPs a multiply-add each, as the products of ``ssd_chunk_plain``."""
    b, nc, c, h, p = x.shape
    n = B.shape[4]
    return 2.0 * b * nc * h * c * (c * n + c * p + p * n)


def register_sharding():
    """K4's DTensor sharding rule (:func:`_sharding`), registered once."""
    _custom.register_sharding(torch.ops.repro_torch.ssd_chunk.default,
                              _sharding)


def _launch(x, dt, A, B, C, instance=None):
    """Launch the instance ``route`` names (``instance``: the one named,
    "tensor_core" or "cuda_core", as a benchmark compares them)."""
    global launches, tc_launches
    # the kernel reads the other axes through their strides; a last axis
    # that is not contiguous is copied
    x, B, C = (t if t.stride(4) == 1 else t.contiguous() for t in (x, B, C))
    A = A.contiguous()
    b, nc, c, h, p = x.shape
    g, n = B.shape[3], B.shape[4]
    tc = (instance or route(c, p, n)) == "tensor_core"
    name = "ssd_scan_tc" if tc else "ssd_scan"
    fn = "ssd_chunk_tc" if tc else "ssd_chunk"
    lib = _build.library(name, _TC_SIGNATURES if tc else _SIGNATURES)
    y = torch.empty((b, nc, c, h, p), dtype=torch.float32, device=x.device)
    st = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or st.numel() == 0:
        return y.zero_(), st.zero_()
    dims = (ctypes.c_int64 * 7)(b, nc, c, h, p, g, n)
    strides = (ctypes.c_int64 * 16)(*x.stride()[:4], *dt.stride(),
                                    *B.stride()[:4], *C.stride()[:4])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                               B.data_ptr(), C.data_ptr(), y.data_ptr(),
                               st.data_ptr(), dims, strides, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + getattr(lib, f"{fn}_error_string")(err).decode())
    launches += 1
    tc_launches += tc
    return y, st
