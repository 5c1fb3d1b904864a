"""Op-trace analyzer for one step (the dry run's "profiler"). Counterpart
of the JAX package's ``launch/hlo_analysis.py``, which parses the
compiled HLO text of an SPMD-partitioned module; PyTorch has no HLO, and
its per-device program is what each rank dispatches. ``OpAnalyzer`` is a
``TorchDispatchMode`` that sees every aten op of a step, on meta or real
tensors, under DTensor (it steps aside for the DTensor-level op, so it
sees the rank's local ops and the collectives DTensor issues) or plain.
Only ops on the rank's device count: DTensor infers each op's output
shapes by running it once more on fake tensors, and computes shard
offsets with CPU tensors; neither is the rank's program. It bills:

  * matmul FLOPs, 2 * M * N * K, for ``mm``, ``addmm``, ``bmm``,
    ``baddbmm`` and ``convolution`` (2 * output elements * the
    contraction);
  * the kernel ops ``repro_torch::ssd_chunk`` (K4) and
    ``repro_torch::swa_attention`` (K5) as matmul FLOPs too, by the
    products that the reference's Pallas grid computes, the same formula
    on meta tensors and on the card: K4 2·b·nc·h·c·(c·n + c·p + p·n)
    (C·Bᵀ, (C·Bᵀ ∘ L ∘ dt)·x and the chunk state; equal to what this
    analyzer bills for ``ssd_chunk_plain``'s products), K5 4·B·H·bq·bk·hd
    over the (q block, k block) pairs of 128 rows that the kernel's
    ``pl.when`` computes (q·kᵀ and p·v; not the whole l x l square);
  * elementwise FLOPs, one per output element of a pointwise op, as the
    reference bills one per output element of an XLA fusion;
  * bytes: the output buffers of materialising ops (views free; an
    in-place op bills the tensor it writes);
  * the functional collectives (``_c10d_functional``, and DTensor's
    all-to-all ``_dtensor::shard_dim_alltoall``): kind, output bytes,
    group size, the reference's ring-model link bytes, and which mesh dims
    each one's group spans;
  * peak live bytes: every storage an op returns (and every tensor given
    to :meth:`OpAnalyzer.track`) counts once, from its first output until
    the storage is freed (a weakref on the storage, which PyTorch keeps
    alive as long as any view of it lives).

The reference rolls ``while`` bodies up by their trip counts; here there
is nothing to roll up: the port's layer loops are Python, so the trace is
unrolled. All quantities are per rank.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ssd_scan as K4
from repro_torch.kernels import swa_attention as K5

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# collective op name -> the reference's collective kind
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    # DTensor's shard-to-shard redistribution (``_dtensor`` namespace)
    "shard_dim_alltoall": "all-to-all",
}

_aten = torch.ops.aten
_MATMUL = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
           _aten.baddbmm.default, _aten.convolution.default}
# the kernel ops: matmul FLOPs from the op's arguments
_KERNEL = {
    torch.ops.repro_torch.ssd_chunk.default:
        lambda x, dt, A, B, C: K4.chunk_flops(x, B),
    torch.ops.repro_torch.swa_attention.default:
        lambda q, k, v, window, causal: K5.band_flops(q, k, window, causal),
}
# ops that hand back their input (or nothing new) without a view schema
_FREE = {_aten.detach.default, _aten.alias.default,
         _aten.lift_fresh.default}


@dataclasses.dataclass
class CollectiveStat:
    kind: str
    bytes_out: int
    group_size: int
    mesh_dims: Tuple[str, ...] = ()

    @property
    def link_bytes(self) -> float:
        """Per-device bytes crossing links (ring model)."""
        n, b = self.group_size, self.bytes_out
        if n <= 1:
            return 0.0
        if self.kind == "all-gather":
            return b * (n - 1) / n            # out = gathered buffer
        if self.kind == "all-reduce":
            return 2.0 * b * (n - 1) / n
        if self.kind == "reduce-scatter":
            return b * (n - 1)                # out = shard
        if self.kind == "all-to-all":
            return b * (n - 1) / n
        return float(b)                        # collective-permute


@dataclasses.dataclass
class ModuleStats:
    flops: float
    matmul_flops: float
    bytes: float
    collective_bytes: Dict[str, float]
    collective_link_bytes: float
    n_collectives: int
    peak_bytes: int
    collectives_by_dim: Dict[str, int]
    n_ops: int
    #: matmul FLOPs billed to each kernel op (``repro_torch::ssd_chunk``,
    #: ``repro_torch::swa_attention``), and their calls
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _matmul_flops(func, args, out) -> float:
    """2 x output elements x the contraction."""
    if func is _aten.convolution.default:
        w = args[1]                    # (C_out, C_in / groups, *kernel)
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    lhs = args[1] if func in (_aten.addmm.default,
                              _aten.baddbmm.default) else args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


def _group_of(name_or_group):
    from torch.distributed import distributed_c10d as c10d
    if isinstance(name_or_group, str):
        return c10d._resolve_process_group(name_or_group)
    return name_or_group


class OpAnalyzer(TorchDispatchMode):
    """Counts one traced region; read :meth:`stats` after it. ``device``:
    the device type of the rank's tensors ("meta" in the dry run); ops
    whose outputs lie elsewhere (DTensor's own index arithmetic on the
    CPU) are not the rank's program and are not counted. ``mesh``
    (optional): the ``DeviceMesh`` whose dim names label the collectives'
    groups; the submeshes sliced from it share its groups."""

    def __init__(self, device, mesh=None):
        super().__init__()
        self.device = torch.device(device).type
        self._dims = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._dims[mesh.get_group(i).group_name] = (name,)
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.collectives: List[CollectiveStat] = []
        self.kernel_flops: Dict[str, float] = {}
        self.kernel_calls: Dict[str, int] = {}
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._cur = 0
        self.peak = 0
        # the autograd engine may free a storage on another thread
        self._lock = threading.Lock()

    # -- live storages -----------------------------------------------------
    def track(self, tensors):
        """Count ``tensors`` (DTensors count their local shard) as live
        from now on, as a step's state and inputs are."""
        from torch.distributed.tensor import DTensor
        for t in tensors:
            self._add(t.to_local() if isinstance(t, DTensor) else t)

    def _add(self, t, own=False):
        """Count ``t``'s storage as live; ``own``: only ``t``'s own bytes
        (a collective's output, which the meta kernel may leave a view of
        a larger buffer that the device's kernel never allocates: the fake
        all-to-all narrows the whole group's concatenation)."""
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            n = _nbytes(t) if own else st.nbytes()

            def freed(_, key=key, n=n):
                with self._lock:
                    if self._live.pop(key, None) is not None:
                        self._cur -= n
            self._live[key] = (weakref.ref(st, freed), n)
            self._cur += n
            self.peak = max(self.peak, self._cur)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor desugar into local ops
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if outs and all(t.device.type == self.device
                        and not isinstance(t, FakeTensor) for t in outs):
            self._account(func, args, outs)
        return out

    def _account(self, func, args, outs):
        self.n_ops += 1
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _FUNCOL.get(func._opname)
            if kind is not None:
                group = _group_of(args[-1])
                nb = sum(_nbytes(t) for t in outs)
                self.collectives.append(CollectiveStat(
                    kind, nb, group.size(),
                    self._dims.get(group.group_name, ())))
                self.bytes += nb
        elif func in _MATMUL or func in _KERNEL:
            f = (_KERNEL[func](*args) if func in _KERNEL
                 else _matmul_flops(func, args, outs[0]))
            if func in _KERNEL:
                name = func._schema.name
                self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + f
                self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
            self.flops += f
            self.matmul_flops += f
            self.bytes += sum(_nbytes(t) for t in outs)
        elif not func.is_view and func not in _FREE:
            nb = sum(_nbytes(t) for t in outs)
            self.bytes += nb
            if torch.Tag.pointwise in func.tags:
                self.flops += sum(t.numel() for t in outs)
        own = func.namespace in ("_c10d_functional", "_dtensor")
        for t in outs:
            self._add(t, own)

    def stats(self) -> ModuleStats:
        cb: Dict[str, float] = {}
        by_dim: Dict[str, int] = {}
        for c in self.collectives:
            cb[c.kind] = cb.get(c.kind, 0.0) + c.bytes_out
            for d in c.mesh_dims:
                by_dim[d] = by_dim.get(d, 0) + 1
        return ModuleStats(
            flops=self.flops, matmul_flops=self.matmul_flops,
            bytes=self.bytes, collective_bytes=cb,
            collective_link_bytes=sum(c.link_bytes for c in self.collectives),
            n_collectives=len(self.collectives), peak_bytes=self.peak,
            collectives_by_dim=by_dim, n_ops=self.n_ops,
            kernel_flops=dict(self.kernel_flops),
            kernel_calls=dict(self.kernel_calls))
