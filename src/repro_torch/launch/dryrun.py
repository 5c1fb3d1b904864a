"""Multi-pod dry run: prove the distribution config traces for every
(architecture x input shape x mesh) and extract roofline inputs. Port of
the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each step on 512 forced host devices
and parses the HLO. Here one process joins a *fake* process group of the
mesh's size (``torch.testing``'s ``FakeStore`` and the "fake" backend:
collectives return at once) and runs rank 0's program: the state and
inputs are DTensors whose local shards are ``meta`` tensors (shapes, no
storage), placed by ``repro_torch.sharding`` (the JAX package's rules,
spec for spec), and ``launch/op_analysis.py`` counts the aten ops and the
collectives DTensor issues. (Fake local shards, under ``FakeTensorMode``,
do not get through DTensor: the offsets of a strided shard, which an
einsum over a batch dim sharded on two mesh dims makes, are read with
``tolist()`` from an index tensor that the mode fakes.) The mesh's
device type is the traced device's: ``cuda`` by default (the card's
program, no card needed: the shards are meta) or ``cpu``
(``--device cpu``). Plain tensors the model makes on the fly (rope
tables, masks, positions) meet the DTensors as replicated
(``implicit_replication``). DTensor places each op by itself; three
modes make its per-rank program the one XLA's partitioner makes from the
whole step (and that torch 2.11's DTensor, the card machine's, and 2.13's
both trace, op for op the same): ``FsdpGather`` gathers a weight's
``data`` (FSDP storage)
shard before each product and lookup where ``data`` splits the batch (one
sequence leaves the weights on their shards and reduces the partial
products; a decode step's embedding table stays sharded and its rows
move; the lm head's chunks of a table are taken of each rank's rows),
``HeadRepeat`` keeps a group repeated out to the heads sharded over
``model``, and ``PartitionerPlacements`` keeps ``new_zeros`` sharded,
gathers a dim before a view splits it unevenly, merges dims into a
strided shard, reduces partial sums before a product, splits a product
that would be repeated on every ``model`` rank, runs K5 on each rank's
query heads where ``model`` does not divide the kv heads, writes the
decode cache on each rank's own rows, reduces a softmax over sharded keys
by its statistics, gathers a tensor once for all its slices, and places
``flip``, ``constant_pad_nd``, ``index_add``, a lookup's gradient, a
lookup in a row-sharded table, a gather from a sharded dim and a partial
plus a sharded sum itself (torch 2.11 has no rule, or a faulty one, for
each). Its redistributions run below autograd on specs that read a
strided shard as a shard (:func:`_moved`). ``tests/test_torch_dryrun.py`` holds the
per-rank matmul FLOPs, peak and link bytes against the one-rank trace of
the same step and against the JAX package's compiled program on a (4, 2)
mesh. The kernel routes (``attn_impl="flash"``, ``ssm_impl="pallas"``)
trace: K4 and K5 are custom ops (``kernels/_custom.py``) whose fake
implementations give meta shards their outputs' shapes, whose DTensor
rules keep batch and head shards, and which the analyzer bills by the
reference kernels' grids.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out build/dryrun

Writes one JSON per (arch, shape, mesh) with per-device FLOPs, bytes,
collective bytes, the peak of live bytes and model-FLOPs bookkeeping.
``--skip-existing`` makes the sweep resumable. Runs in a process of its
own: a process group is per process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core import hierarchy as H
from repro_torch.kernels import ssd_scan as K4
from repro_torch.kernels import swa_attention as K5
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.op_analysis import OpAnalyzer
from repro_torch.models import model as M
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sharding import partition as PT
from repro_torch.sharding.partition import map_with_path
from repro_torch.train import steps as ST


def should_skip(cfg, shape) -> str:
    """Return a reason string if this (arch, shape) is skipped by design."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return ("full-attention architecture: 524k-token decode requires "
                "sub-quadratic state (DESIGN.md §5)")
    return ""


def model_flops(cfg, shape) -> float:
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n_active * tokens)


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake process group of ``size`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def sharded(tree, placements, mesh):
    """DTensors over meta shards with the global shapes and dtypes of
    ``tree``'s leaves and the ``placements`` tree's placements on
    ``mesh``."""
    return tree_map(lambda t, pl: meta_dtensor(t.shape, t.dtype, mesh, pl),
                    tree, placements)


def meta_dtensor(shape, dtype, mesh, placements):
    """A DTensor of global ``shape`` over a ``meta`` local shard; on a
    one-rank mesh, where every placement replicates and DTensor adds
    nothing, the plain ``meta`` tensor. The one-rank trace is what
    ``chip_smoke.py`` phase 11 holds against the card; phase 12 traces the
    sharded meshes on the card machine's torch (2.11), the CPU tests on
    this one's."""
    if mesh.size() == 1:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return _dtensor_of(torch.empty, shape, dtype, mesh, placements, "meta")


def _dtensor_of(factory, shape, dtype, mesh, placements, device):
    """A DTensor of global ``shape`` whose local shard ``factory`` makes."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                      placements)
    return DTensor.from_local(
        factory(local, dtype=dtype, device=device), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=make_contiguous_strides_for(tuple(shape)))


def build_hfl_steps_and_args(cfg, shape, mesh, quant_bits=0):
    """The paper's hierarchical mode: per-pod local step + cluster sync.

    Returns ((local_fn, local_args), (sync_fn, sync_args)). Multi-pod only.
    The state has a leading clusters axis sharded over ``pod``. A rank
    runs the local step on its own pod's slice of the state and batch,
    as DTensors on the ``(data, model)`` submesh (the tier-1 step's loop
    over the clusters axis would gather it), so the local step emits no
    ``pod`` collective; the sync averages over the whole mesh's ``pod``
    dim."""
    from torch.distributed.tensor import Shard
    names = tuple(mesh.mesh_dim_names)
    n_pods = dict(zip(names, mesh.shape)).get("pod", 1)
    assert n_pods > 1, "HFL dry-run needs the multi-pod mesh"
    sub = mesh[names[1:]]
    state_abs = H.abstract_hfl_state(cfg, n_pods)
    state_pl = PT.named(mesh, H.hfl_state_specs(cfg, mesh))
    ins = S.input_specs(cfg, shape)
    hfl_batch = tree_map(
        lambda s: S.S((n_pods, s.shape[0] // n_pods) + tuple(s.shape[1:]),
                      s.dtype), ins["batch"])
    batch_pl = PT.named(mesh, H.hfl_batch_specs(cfg, mesh, hfl_batch))

    def pod_local(tree, pls):
        """A pod's slice (leading dim 1) of each leaf on the submesh,
        with the placements past ``pod``."""
        return tree_map(lambda t, pl: meta_dtensor(
            (1,) + tuple(t.shape[1:]), t.dtype, sub, pl[1:]), tree, pls)

    def pod_batch(tree, pls):
        """A pod's batch (the leading dim dropped) on the submesh."""
        return tree_map(lambda t, pl: meta_dtensor(
            tuple(t.shape[1:]), t.dtype, sub,
            [Shard(p.dim - 1) if p.is_shard() else p for p in pl[1:]]),
            tree, pls)

    local_step = H.make_hfl_local_step(cfg)

    def local(state, batch):
        return local_step(state, [batch])

    sync = H.make_cluster_sync(cfg, quant_bits=quant_bits)
    return ((local, (pod_local(state_abs, state_pl),
                     pod_batch(hfl_batch, batch_pl))),
            (sync, (sharded(state_abs, state_pl, mesh),)))


def _no_grad(step):
    """The body of an inference-mode step, run under ``no_grad``: DTensor
    cannot run in inference mode (it sets the version counters of the
    tensors it makes), and the ops are the same."""
    return torch.no_grad()(step.__wrapped__)


def build_step_and_args(cfg, shape, mesh, expert_parallel=False):
    """Returns (step fn, args as DTensors over meta shards)."""
    ins = S.input_specs(cfg, shape)
    if shape.kind == "train":
        state_abs = ST.init_train_state(cfg, torch.Generator(),
                                        device="meta")
        state_pl = PT.named(mesh, PT.train_state_specs(cfg, mesh,
                                                       expert_parallel))
        batch_pl = PT.named(mesh, PT.batch_specs(cfg, mesh, ins["batch"]))
        return ST.make_train_step(cfg), (
            sharded(state_abs, state_pl, mesh),
            sharded(ins["batch"], batch_pl, mesh))
    params_abs = M.abstract_params(cfg)
    ppl = PT.named(mesh, PT.param_specs(cfg, mesh, expert_parallel))
    params = sharded(params_abs, ppl, mesh)
    if shape.kind == "prefill":
        bpl = PT.named(mesh, PT.batch_specs(cfg, mesh, ins["batch"]))
        return _no_grad(ST.make_prefill_step(cfg)), (
            params, sharded(ins["batch"], bpl, mesh))
    dpl = PT.named(mesh, PT.decode_arg_specs(cfg, mesh, ins))
    return _no_grad(ST.make_decode_step(cfg)), (
        params, sharded(ins["cache"], dpl["cache"], mesh),
        sharded(ins["tokens"], dpl["tokens"], mesh),
        sharded(ins["pos"], dpl["pos"], mesh))


def _storage(t):
    from torch.distributed.tensor import DTensor
    return (t._local_tensor if isinstance(t, DTensor) else t).untyped_storage()


class FsdpGather(TorchFunctionMode):
    """The rules' ``data`` axis on a weight is FSDP storage: a step gathers
    a weight over ``data`` just before using it, layer by layer. DTensor
    has no such plan; it places op by op, by the bytes each choice
    moves, and often keeps a weight's ``data`` shard and moves the
    activations instead: at the embedding lookup it gathers the batch
    (every rank then computes the whole batch), at the unembedding it
    shards the contraction and then gathers the whole vocab of logits.
    Under this mode every operand of a product (``einsum``, ``matmul``,
    ``bmm``, ``linear``) or a lookup (``table[indices]``) that comes from
    ``weights`` (by storage, through casts, views and slices) is gathered
    over the ``fsdp`` mesh dims first. Autograd reduce-scatters its
    gradient back to the storage placements. Two exceptions, both as XLA
    places them:

    * a mesh dim that splits none of the activations' rows (one sequence,
      as at ``long_500k``, which ``data`` cannot split): the weight keeps
      its shard there, each rank contracts its slice of the activation,
      and the partial product is all-reduced at once (:meth:`_kept`);
    * the embedding ``tables`` when fewer values meet them than they hold
      (a decode step's tokens): a lookup reads each rank's own rows and
      moves them to the indices' shards (:func:`_local_lookup`), and the
      unembedding keeps the table's shards (DTensor moves the
      activations); gathering mamba2's table for 128 tokens held 1.2 GiB
      a rank at ``decode_32k``.

    The recomputation of a rematerialised layer runs under this mode too
    (:func:`remat_under`).

    The lm head over chunks of the vocab (``models.model.LOGITS_CHUNK``,
    a decode step's) slices a table whose vocab is sharded on ``model``:
    DTensor gathered the vocab for the slices, and each ``model`` rank
    then computed every chunk's product whole (qwen3-14b's ``decode_32k``:
    1.43x the matmul FLOPs of the one product). Here a chunk is taken of
    each rank's own rows (:func:`_local_chunk`), and the chunks' logits,
    concatenated in order, are the rank's own columns again
    (:meth:`_chunk_cat`): a rank casts one chunk of its shard at a time,
    as XLA fuses the casts into the dot."""

    _PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.bmm,
                 torch.Tensor.bmm, torch.mm, torch.Tensor.mm,
                 torch.nn.functional.linear}
    _CARRY = {torch.Tensor.to, torch.Tensor.float, torch.Tensor.bfloat16,
              torch.Tensor.half, torch.Tensor.contiguous, torch.Tensor.t,
              torch.Tensor.T.__get__, torch.Tensor.transpose,
              torch.Tensor.permute, torch.Tensor.reshape, torch.Tensor.view,
              torch.Tensor.unbind, torch.unbind, torch.Tensor.detach,
              torch.Tensor.requires_grad_, torch.Tensor.__getitem__}

    def __init__(self, weights, fsdp, tables=()):
        super().__init__()
        # id -> weakref of the chunks of a table taken by _local_chunk, and
        # of what casts and views make of them; and of the products they
        # enter
        self._chunks, self._chunk_products = {}, {}
        # (id of an activation, placements) -> (weakref, the activation
        # moved there for a chunk's product)
        self._moved_acts = {}
        # storage address -> (weakref, is a table): an address is dropped
        # when its storage is freed, before a new storage can take it
        self._w = {}
        self._fsdp = tuple(fsdp)
        tables = {_storage(t)._cdata for t in tables}
        for t in weights:
            self._mark(t, _storage(t)._cdata in tables)

    def _mark(self, t, table):
        st = _storage(t)
        key = st._cdata
        self._w[key] = (weakref.ref(st, lambda _, k=key: self._w.pop(k, None)),
                        table)

    def _is_weight(self, t):
        from torch.distributed.tensor import DTensor
        return isinstance(t, DTensor) and _storage(t)._cdata in self._w

    def _is_table(self, t):
        return self._is_weight(t) and self._w[_storage(t)._cdata][1]

    def _fewer_rows(self, table, idx):
        """A lookup of fewer values than the table holds (a decode step's
        tokens): the table stays sharded and the rows move instead."""
        from torch.distributed.tensor import DTensor
        return self._is_table(table) and isinstance(idx, DTensor) \
            and idx.numel() * table.shape[-1] < table.numel()

    def _gathered(self, ops, eq=None):
        """(A product's operands with the weights gathered, the mesh dims
        on which the weights keep their shards (:meth:`_kept`)). A table
        that fewer rows meet than it has, so that the product is smaller
        than the table (the unembedding of a decode step), is not gathered:
        DTensor moves the activations. A train step's lm head over 2 x 4096
        tokens of d_model 8192 gathers the table, as XLA does: kept sharded
        over ``data``, its logits came partial and were gathered whole over
        the vocab (1.0e10 B a rank for qwen2-72b on (2, 2, 16), 30% of the
        layer's peak). ``eq``: an einsum's equation."""
        ops = tuple(ops)
        w = [a for a in ops if self._is_weight(a)]
        rows = [a.numel() // max(a.shape[-1], 1) for a in ops
                if isinstance(a, torch.Tensor) and a.ndim
                and not self._is_weight(a)]
        if w and rows and all(self._is_table(a) for a in w) \
                and max(rows) < min(a.shape[0] for a in w):
            return ops, ()
        keep = self._kept(ops, eq)
        return tuple(self._gather(a, keep) for a in ops), keep

    def _kept(self, ops, eq=None):
        """The ``fsdp`` mesh dims on which a product's weights keep their
        shards: those on which no activation is sharded along a dim the
        product does not contract (its rows: a batch, a sequence). A batch
        that the dim cannot split (one sequence, ``long_500k``) leaves the
        dim to the weights, as XLA's partitioner does: each rank contracts
        its slice of the activation against the weight's shard (a local
        slice, no collective), and the product, partial there, is
        all-reduced at once (the reference's one-sequence decode
        all-reduces mamba2's ``in_proj`` output, f32[1, 552], and has no
        all-gather). Gathering the weight made each ``data`` rank repeat
        the whole product (qwen3's smoke decode of one sequence on (4, 2):
        2.0x a rank's share of the matmul FLOPs, 72x the reference's link
        bytes)."""
        from torch.distributed.tensor import DTensor
        acts = [(j, a) for j, a in enumerate(ops) if isinstance(a, DTensor)
                and not self._is_weight(a)]
        if not acts or len(acts) == len(ops) or eq is not None and "." in eq:
            return ()
        if eq is not None:
            ins = eq.replace(" ", "").split("->")[0].split(",")
            wsub = "".join(s for s, a in zip(ins, ops) if self._is_weight(a))
            out = eq.split("->")[1] if "->" in eq else ""
            rows = {j: {d for d, c in enumerate(ins[j])
                        if c not in wsub or c in out} for j, _ in acts}
        else:
            # matmul / linear: the activation's last dim is contracted as
            # the left operand, its second-to-last as the right one
            rows = {j: set(range(a.ndim)) - {a.ndim - 1 if j == 0
                                             else max(a.ndim - 2, 0)}
                    for j, a in acts}
        return tuple(i for i in self._fsdp if not any(
            p.is_shard() and p.dim % a.ndim in rows[j]
            for j, a in acts for p in (a.placements[i],)))

    def _gather(self, t, keep=()):
        from torch.distributed.tensor import Replicate
        if not self._is_weight(t):
            return t
        pl = [Replicate() if i in self._fsdp and i not in keep
              and p.is_shard() else p
              for i, p in enumerate(t.placements)]
        if pl == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, pl)

    @staticmethod
    def _note(book, ts):
        for t in ts if isinstance(ts, (list, tuple)) else (ts,):
            if isinstance(t, torch.Tensor):
                key = id(t)
                book[key] = weakref.ref(t, lambda _, k=key: book.pop(k, None))

    @staticmethod
    def _in(book, t):
        ref = book.get(id(t))
        return ref is not None and ref() is t

    def _chunk_cat(self, ts, dim=0):
        """``torch.cat(ts, dim)`` of the logits of a table's chunks
        (:func:`_local_chunk`) along the chunked dim: each rank's pieces
        in order are its own columns, so the cat is the local one. None
        where ``ts`` are not such logits sharded alike on ``dim``."""
        from torch._prims_common import make_contiguous_strides_for
        from torch.distributed.tensor import DTensor
        ts = list(ts)
        if not ts or not all(isinstance(t, DTensor)
                             and self._in(self._chunk_products, t)
                             for t in ts):
            return None
        dim %= ts[0].ndim
        pl = list(ts[0].placements)
        if any(list(t.placements) != pl for t in ts) \
                or not any(p.is_shard(dim) for p in pl):
            return None
        shape = list(ts[0].shape)
        shape[dim] = sum(t.shape[dim] for t in ts)
        return DTensor.from_local(
            torch.cat([t._local_tensor for t in ts], dim),
            ts[0].device_mesh, pl, run_check=False, shape=torch.Size(shape),
            stride=make_contiguous_strides_for(shape))

    def _chunk_activations(self, ops, eq):
        """The einsum ``eq``'s activations where one operand is a table's
        chunk, moved once for all the chunks: on a mesh dim that shards a
        dim the chunk contracts, the activation takes the shard on its dim
        of that letter, and its partial sums are reduced. DTensor moved
        the activation anew for each chunk's product (a smoke mamba2
        decode of a 4097 vocab in 33 chunks on (4, 2): 1.38x the link
        bytes of the one product)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        chunks = [a for a in ops if self._in(self._chunks, a)]
        if len(chunks) != 1 or "." in eq or "->" not in eq:
            return tuple(ops)
        ins, out = eq.replace(" ", "").split("->")
        ins = ins.split(",")
        ws = ins[[a is chunks[0] for a in ops].index(True)]
        moved = []
        for s, a in zip(ins, ops):
            if not isinstance(a, DTensor) or a is chunks[0]:
                moved.append(a)
                continue
            pl = [Replicate() if p.is_partial() else p for p in a.placements]
            for i, p in enumerate(chunks[0].placements):
                if p.is_shard() and ws[p.dim] not in out and ws[p.dim] in s:
                    pl[i] = Shard(s.index(ws[p.dim]))
            key = (id(a), tuple(pl))
            ref, to = self._moved_acts.get(key, (lambda: None, None))
            if ref() is not a:
                to = a if pl == list(a.placements) else \
                    a.redistribute(a.device_mesh, pl)
                self._moved_acts[key] = (weakref.ref(
                    a, lambda _, k=key: self._moved_acts.pop(k, None)), to)
            moved.append(to)
        return tuple(moved)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        keep = ()
        if func is torch.Tensor.__getitem__ and self._is_table(args[0]) \
                and not torch.is_grad_enabled() \
                and not isinstance(args[1], torch.Tensor):
            # a chunk of the lm head's table (a view of its storage)
            out = _local_chunk(*args[:2])
            if out is None:
                out = func(*args, **kwargs)
            self._note(self._chunks, out)
            return out
        if func is torch.cat:
            out = self._chunk_cat(*args, **kwargs)
            if out is not None:
                return out
        lookup = func is torch.Tensor.__getitem__ and \
            isinstance(args[1], torch.Tensor)
        if lookup and self._fewer_rows(*args[:2]):
            out = _local_lookup(*args[:2])
            if out is not None:
                return out
            return _rows_like(func(*args, **kwargs), args[1])
        if lookup:
            args = (self._gather(args[0]),) + tuple(args[1:])
        elif func is torch.einsum:
            ops = args[1] if len(args) == 2 and \
                isinstance(args[1], (list, tuple)) else args[1:]
            ops, keep = self._gathered(ops, args[0])
            args = (args[0],) + self._chunk_activations(ops, args[0])
        elif func in self._PRODUCTS:
            args, keep = self._gathered(args)
        out = _reduced(func(*args, **kwargs), keep)
        if func in self._CARRY and not lookup and self._is_weight(args[0]):
            table = self._is_table(args[0])
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, DTensor):
                    self._mark(t, table)
            if self._in(self._chunks, args[0]):
                self._note(self._chunks, out)
        if (func is torch.einsum or func in self._PRODUCTS) and any(
                self._in(self._chunks, a) for a in
                (args[1:] if func is torch.einsum else args)):
            self._note(self._chunk_products, out)
        return out


class HeadRepeat(TorchFunctionMode):
    """A group dim repeated out to the heads (``repeat_interleave(rep,
    dim)``, SSD's B and C of one group) keeps its heads sharded over
    ``model`` where the heads divide, as XLA's partitioner shards the
    repeated dim (its C·Bᵀ of mamba2's ``prefill_32k`` is f32[32, 128, 4,
    256, 256]: 4 of the 64 heads a device). DTensor would repeat a
    replicated group to every head on every rank and compute each head's
    product 16 times. Here a rank repeats only the groups of its own heads;
    the gradient of the group sums over ``model``."""

    _REPEAT = {torch.repeat_interleave, torch.Tensor.repeat_interleave}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = dict(kwargs or {})
        if func in self._REPEAT and args and isinstance(args[0], DTensor):
            x, rep = args[0], (args[1] if len(args) > 1
                               else kwargs.get("repeats"))
            dim = args[2] if len(args) > 2 else kwargs.get("dim")
            if isinstance(rep, int) and isinstance(dim, int):
                out = _local_repeat(x, rep, dim % x.ndim)
                if out is not None:
                    return out
        return func(*args, **kwargs)


def _local_repeat(x, rep, dim):
    """``x.repeat_interleave(rep, dim)`` sharded over ``model`` on ``dim``
    (rank 0's heads, from the groups they read), or None where ``x`` is
    sharded there already or the heads do not divide."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names or any(p.is_shard(dim) for p in x.placements):
        return None
    i = names.index("model")
    m, h = mesh.size(i), x.shape[dim] * rep
    if m == 1 or not x.placements[i].is_replicate() or h % m:
        return None
    mine = h // m
    local = x.to_local(grad_placements=[
        Partial() if j == i else p for j, p in enumerate(x.placements)])
    local = local.narrow(dim, 0, -(-mine // rep)).repeat_interleave(
        rep, dim).narrow(dim, 0, mine)
    shape = list(x.shape)
    shape[dim] = h
    from torch._prims_common import make_contiguous_strides_for
    return DTensor.from_local(
        local, mesh, [Shard(dim) if j == i else p
                      for j, p in enumerate(x.placements)],
        run_check=False, shape=torch.Size(shape),
        stride=make_contiguous_strides_for(tuple(shape)))


def _local_chunk(table, key):
    """``table[key]`` where ``key`` slices one dim that plain shards split
    over mesh dims of ``m`` ranks, at bounds that ``m`` divides: each rank
    takes rows ``[lo / m, hi / m)`` of its own shard, and the chunk keeps
    the table's placements (its rows are every rank's piece of the
    chunk's share, not the table's rows ``[lo, hi)``; the chunks in order
    hold each rank's own rows again). None for any other key or
    placement."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor
    key = key if isinstance(key, tuple) else (key,)
    if len(key) > table.ndim or not all(isinstance(k, slice) for k in key):
        return None
    cut = [(d, k) for d, k in enumerate(key)
           if k != slice(None)]
    if len(cut) != 1 or cut[0][1].step not in (None, 1):
        return None
    dim, k = cut[0]
    size = table.shape[dim]
    lo, hi, _ = k.indices(size)
    over = [i for i, p in enumerate(table.placements) if p.is_shard(dim)]
    if not over or hi <= lo or any(
            not (p.is_shard() or p.is_replicate())
            or _strided(p, getattr(p, "dim", -1)) for p in table.placements):
        return None
    m = math.prod(table.device_mesh.size(i) for i in over)
    if size % m or lo % m or hi % m:
        return None
    local = table._local_tensor.narrow(dim, lo // m, (hi - lo) // m)
    shape = list(table.shape)
    shape[dim] = hi - lo
    return DTensor.from_local(local, table.device_mesh, table.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=make_contiguous_strides_for(shape))


def _spec_of(mesh, placements, shape, stride, dtype):
    """A ``DTensorSpec`` whose strided shards are plain strided shards of
    their dim, as torch 2.13's view rule makes them. A torch whose spec
    has ``use_strided_shard_as_shard_order`` reads a strided shard made
    any other way as an order of mesh dims, and torch 2.11's planner then
    refuses one whose split factor is no product of mesh sizes; so the
    field is set where the spec has it (a test of the field, which older
    torches lack)."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    flag = {"use_strided_shard_as_shard_order": False} \
        if "use_strided_shard_as_shard_order" in getattr(
            DTensorSpec, "__dataclass_fields__", {}) else {}
    return DTensorSpec(mesh, tuple(placements), tensor_meta=TensorMeta(
        torch.Size(shape), tuple(stride), dtype), **flag)


def _plain_strided(t):
    """``t`` with :func:`_spec_of`'s spec where DTensor gave a strided
    shard a spec that reads it as an order of mesh dims (torch 2.11 does
    so for an op's output whatever its inputs' specs said, and its
    planner then refused the strided shard); ``t`` itself otherwise."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or not getattr(
            t._spec, "use_strided_shard_as_shard_order", False):
        return t
    return _wrap(t._local_tensor, t.device_mesh, t.placements, t.shape,
                 t.stride())


def _wrap(local, mesh, placements, shape, stride=None):
    """``local`` as rank 0's shard of a DTensor of global ``shape`` (its
    ``stride``; by default the strides of ``shape`` laid out in the order
    of ``local``'s, so that a local op that kept an input's layout keeps
    it globally too), made below autograd (in ``PartitionerPlacements``)
    with :func:`_spec_of`'s spec."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    if stride is None:
        order = sorted(range(len(shape)), key=lambda d: (
            -local.stride()[d], d) if local.ndim == len(shape) else d)
        stride, n = [0] * len(shape), 1
        for d in reversed(order):
            stride[d] = n
            n *= max(shape[d], 1)
    stride = tuple(stride)
    return DTensor(local, _spec_of(mesh, placements, shape, stride,
                                   local.dtype), requires_grad=False)


def _moved(t, placements):
    """``t`` redistributed to ``placements`` below autograd (in
    ``PartitionerPlacements``, whose ops autograd has already recorded):
    the local redistribution between :func:`_spec_of`'s specs, no autograd
    function (under ``no_grad`` one ends in autograd's ``detach_`` of its
    output where ``t`` requires a gradient, an op for which torch 2.11's
    DTensor has no sharding strategy)."""
    from torch.distributed.tensor._redistribute import (
        redistribute_local_tensor)
    if tuple(placements) == tuple(t.placements):
        return t
    src = _spec_of(t.device_mesh, t.placements, t.shape, t.stride(),
                   t.dtype)
    dst = _spec_of(t.device_mesh, placements, t.shape, t.stride(), t.dtype)
    return _wrap(redistribute_local_tensor(t._local_tensor, src, dst),
                 t.device_mesh, placements, t.shape, t.stride())


def _reduced(t, dims):
    """``t`` with its partial sums over the mesh ``dims`` reduced
    (``Partial`` -> ``Replicate``)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not dims or not isinstance(t, DTensor):
        return t
    pl = [Replicate() if i in dims and p.is_partial() else p
          for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(
        t.device_mesh, pl)


def _rows_like(rows, idx):
    """Looked-up ``rows`` moved to the indices' batch shards, whole rows on
    each rank."""
    from torch.distributed.tensor import Replicate
    pl = [p if p.is_shard() and p.dim < idx.ndim else Replicate()
          for p in idx.placements]
    return rows.redistribute(rows.device_mesh, pl)


def _local_lookup(table, idx):
    """``table[idx]`` on each rank's shard of a 2-D table, as XLA's
    partitioner looks up a table sharded by rows: a rank looks up the
    indices that fall in its rows (the others read row 0, masked to 0), so
    the rows come out partial over a mesh dim that shards the vocab, and
    sharded by columns over one that shards them; the indices are gathered
    over both first (small), and the rows then moved to the indices' batch
    shards (:func:`_rows_like`). DTensor has no rule for an index into a
    row-sharded table: it moved the whole table's shard to a column shard
    with an all-to-all first (65,536 B a rank for a smoke qwen3 on (4, 2),
    the whole program's largest collective at one sequence). None where
    the table is partial or not 2-D."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    if table.ndim != 2 or any(not (p.is_replicate() or p.is_shard())
                              for p in table.placements):
        return None
    mesh = table.device_mesh
    ipl, opl = [], []
    for p, q in zip(table.placements, idx.placements):
        if p.is_shard(0):
            ipl.append(Replicate())
            opl.append(Partial())
        elif p.is_shard(1):
            ipl.append(Replicate())
            opl.append(Shard(idx.ndim))
        else:
            ipl.append(q)
            opl.append(q)
    ids = idx.redistribute(mesh, ipl).to_local()
    local = table.to_local()
    _, (lo, _) = compute_local_shape_and_global_offset(
        tuple(table.shape), mesh, table.placements)
    ids = ids - lo
    inside = (ids >= 0) & (ids < local.shape[0])
    rows = local[torch.where(inside, ids, 0)] * inside[..., None]
    shape = tuple(idx.shape) + (table.shape[1],)
    out = DTensor.from_local(rows, mesh, opl, run_check=False,
                             shape=torch.Size(shape),
                             stride=make_contiguous_strides_for(shape))
    return _rows_like(out, idx)


def _split_groups(src, dst):
    """Pair the dims of a view from shape ``src`` to shape ``dst``:
    ``[(source dims, target dims)]``, each group the fewest dims on both
    sides with equal products (size-1 dims join the group before them)."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj, a, b = [], [], 1, 1
        while True:
            if a <= b and i < len(src) and (a < b or not gi):
                a *= src[i]
                gi.append(i)
                i += 1
            elif j < len(dst) and (b < a or not gj):
                b *= dst[j]
                gj.append(j)
                j += 1
            else:
                break
        while i < len(src) and src[i] == 1:
            gi.append(i)
            i += 1
        while j < len(dst) and dst[j] == 1:
            gj.append(j)
            j += 1
        groups.append((gi, gj))
    return groups


def _split_gathers(x, dim, lead, strided=False):
    """The mesh dims of ``x``'s shards of ``dim`` to gather before a view
    splits ``dim`` into factors whose first is ``lead``: the shards
    (major to minor) past the longest run of plain ones whose sizes divide
    ``lead``; with ``strided``, a strided shard too (a batch merged with a
    sequence sharded over ``model`` and split again keeps its ``pod`` and
    ``data`` shards and gathers ``model`` alone)."""
    over = [i for i, p in enumerate(x.placements)
            if p.is_shard(dim) or strided and _strided(p, dim)]
    n = 1
    for k, i in enumerate(over):
        n *= x.device_mesh.size(i)
        if _strided(x.placements[i], dim) or lead % n:
            return over[k:]
    return []


def _strided_split(func, x, size, groups):
    """A view that splits a dim carrying a strided shard back into the
    dims a view merged ((b·h) -> (b, h), the heads sharded under a
    batch): the strided shard is a plain shard of the dim it names, and
    the view is the local one, each rank keeping its heads. None where the
    view is not that split. DTensor's view rule replicated the minor dim
    instead: attention's scores over heads sharded on ``model``, computed
    on each rank's heads, were gathered whole after the product (4.3e9 B
    a rank in one full-width phi-3 layer's train step on (2, 2, 16))."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor, Shard
    if not any(_strided(p, getattr(p, "dim", -1)) for p in x.placements):
        return None
    mesh, pl = x.device_mesh, list(x.placements)
    local = [1] * len(size)
    for src, dst in groups:
        src = [d for d in src if x.shape[d] > 1]
        dst = [d for d in dst if size[d] > 1]
        over = [i for i, p in enumerate(x.placements)
                if any(p.is_shard(d) or _strided(p, d) for d in src)]
        if not over:
            for d in dst:
                local[d] = size[d]
        elif len(src) == len(dst) == 1:
            local[dst[0]] = x._local_tensor.shape[src[0]]
            for i in over:
                p = x.placements[i]
                pl[i] = type(p)(dst[0], split_factor=p.split_factor) \
                    if _strided(p, src[0]) else Shard(dst[0])
        elif len(src) == 1 and len(dst) > 1 and not any(
                _strided(x.placements[i], src[0]) for i in over):
            # plain shards of a dim split into factors: the leading one
            # takes them (torch 2.13 splits so itself, 2.11 gathers)
            n = math.prod(mesh.size(i) for i in over)
            if size[dst[0]] % n or any(not x.placements[i].is_shard(src[0])
                                       for i in over):
                return None
            for d in dst:
                local[d] = size[d]
            local[dst[0]] //= n
            for i in over:
                pl[i] = Shard(dst[0])
        elif len(src) == 1 and len(dst) > 1:
            plain, p = over[:-1], x.placements[over[-1]]
            if not _strided(p, src[0]):
                return None
            n = math.prod(mesh.size(i) for i in plain)
            # the strided shard's dim: the one whose major dims hold
            # split_factor rows a rank
            lead = [math.prod(size[d] for d in dst[:j]) for j in
                    range(len(dst))]
            minor = [d for d, f in zip(dst, lead)
                     if f == p.split_factor * n]
            if not minor or size[dst[0]] % n \
                    or any(not x.placements[i].is_shard(src[0])
                           for i in plain) \
                    or size[minor[0]] % mesh.size(over[-1]):
                return None
            for d in dst:
                local[d] = size[d]
            local[dst[0]] //= n
            local[minor[0]] //= mesh.size(over[-1])
            for i in plain:
                pl[i] = Shard(dst[0])
            pl[over[-1]] = Shard(minor[0])
        else:
            return None
    return _wrap(func(x._local_tensor, local), mesh, pl, size)


def _moved_shards(x, over, groups, size):
    """``x``'s placements for a view to ``size`` that splits a dim sharded
    over the mesh dims ``over`` unevenly: each of them moved to the
    largest dim the view keeps whole, past the batch and before the last,
    that no other mesh dim shards and its size divides (a projection's
    sequence), else replicated. The view then keeps the rank's share:
    attention's queries, their heads gathered for a view into (kv heads,
    group) that 16 does not divide, were computed whole on each ``model``
    rank, their scores contracted over hd and partial, the whole
    sequence's scores held on each rank before the reduction (one
    full-width qwen2-72b layer's train step on (2, 2, 16): 2.1e10 B a
    rank, 2.4x the reference's peak). Sharded by query, the scores need
    no reduction, as XLA shards them."""
    from torch.distributed.tensor import Replicate, Shard
    kept = [src[0] for src, dst in groups if len(src) == len(dst) == 1
            and x.shape[src[0]] == size[dst[0]]]
    pl = list(x.placements)
    for i in sorted(over):
        free = [d for d in kept if 0 < d < x.ndim - 1
                and x.shape[d] % x.device_mesh.size(i) == 0
                and not any(q.is_shard(d) or _strided(q, d) for q in pl)]
        pl[i] = Shard(max(free, key=lambda d: x.shape[d])) if free \
            else Replicate()
    return pl


def _strided(p, dim):
    """``p`` is a strided shard of ``dim`` (a torch without the class
    makes none)."""
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    return cls is not None and isinstance(p, cls) and p.dim == dim


def _product_operands(func, args):
    """A product's operands placed as XLA's partitioner places them:

    * partial sums reduced (``Partial`` -> ``Replicate``), and a strided
      shard of a contracted dim gathered (a view merged a sharded minor dim
      into a major one, attention's hd into heads x hd: DTensor has no
      product rule for such a shard and gathers the other operand, a whole
      weight, instead);
    * a product whose operands are both replicated over ``model``, which
      every ``model`` rank would compute whole, split there: a batched
      product (attention's, or an einsum's lm head) along its contraction
      where ``model`` divides it (hd, or d_model: the result partial, as
      XLA contracts mamba2's lm head over 128 of 2048), else along its
      columns (N: heads x hd, or a vocab that ``model`` need not divide: a
      rank then computes ceil(N / m) columns, as XLA pads N), else along
      its contraction. A batched product of fewer rows than ``model`` has
      ranks (a decode step's scores: one query of each group, (b·k, g,
      hd) with the cache's (b·k, hd, s)) is split along its columns
      first: split along hd, its partial scores were reduced whole over
      ``model`` (60% of jamba's ``long_500k`` link bytes), where split by
      key they need only softmax's statistics and the small ``w·v``
      partials."""
    from torch.distributed.tensor import DTensor, Replicate
    lhs, rhs = (1, 2) if func in (torch.ops.aten.addmm.default,
                                  torch.ops.aten.baddbmm.default) else (0, 1)
    args = list(args)
    for j, t in enumerate(args):
        if not isinstance(t, DTensor):
            continue
        k = {lhs: t.ndim - 1, rhs: t.ndim - 2}.get(j, -1)
        pl = [Replicate() if p.is_partial() or _strided(p, k) else p
              for p in t.placements]
        if pl != list(t.placements):
            args[j] = _moved(t, pl)
    a, b = args[lhs], args[rhs]
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return tuple(args)
    args[lhs], args[rhs] = a, b = _gather_small_operand(a, b)
    names = tuple(b.device_mesh.mesh_dim_names or ())
    if "model" not in names:
        return tuple(args)
    i = names.index("model")
    m = b.device_mesh.size(i)
    if m == 1 or not (a.placements[i].is_replicate()
                      and b.placements[i].is_replicate()):
        return tuple(args)
    rows, k, n = a._local_tensor.shape[-2:] + b._local_tensor.shape[-1:]
    if a.ndim == 3 and k % m == 0 and not (rows < m <= n):
        a, b = _shard_on(a, i, a.ndim - 1), _shard_on(b, i, b.ndim - 2)
    elif n % m == 0 or n >= m:
        b = _shard_on(b, i, b.ndim - 1)
    elif k % m == 0:
        a, b = _shard_on(a, i, a.ndim - 1), _shard_on(b, i, b.ndim - 2)
    args[lhs], args[rhs] = a, b
    return tuple(args)


def _strided_product(func, a, b):
    """``mm`` / ``bmm`` of ``a`` and ``b`` on each rank's shards where an
    operand has a strided shard (a view merged a sharded minor dim into a
    major one), or None where neither has one or a mesh dim pairs
    placements that have no local product. DTensor has no product rule
    for a strided shard and gathered it: the gradient of attention's
    scores (b·k, g·q, s), its queries over ``model`` merged under the
    group, was gathered whole for the products of q's and k's gradients
    (3 x 8.59e9 B a rank, 88% of the peak of one full-width qwen2-72b
    layer on (2, 2, 16)). Here, mesh dim by mesh dim:

    * a strided shard of the batch stays, the other operand moved to it
      (a local slice of a replicated one), and the product keeps it
      (heads sharded under a merged batch: attention's (b·h) in phi-3,
      SSD's (b·chunks·heads));
    * a strided shard of the rows (``a``'s M) or the columns (``b``'s N)
      stays, the other operand replicated there, and the product's rows
      or columns keep it, unless the other operand is sharded there and
      the strided one is the smaller: that one is gathered instead (an
      lm head's table, its vocab on ``model``, met by rows of a sequence
      on ``model``: 4.98e9 B a rank of qwen2-72b gathered otherwise);
    * a strided shard of the contraction is matched on the other operand
      (a local slice of a replicated one) and the product is partial;
    * plain shards of the batch, rows, columns and contraction pair as
      they do under DTensor's rule, a replicated partner sliced locally.

    Partial operands are reduced first, as :func:`_product_operands`
    reduces them."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or not any(
            _strided(p, getattr(p, "dim", -1))
            for p in (*a.placements, *b.placements)):
        return None
    mesh, nd = a.device_mesh, a.ndim
    m, k, n = nd - 2, nd - 1, nd - 1              # a (.., M, K), b (.., K, N)
    rep = Replicate()
    a_smaller = a._local_tensor.numel() <= b._local_tensor.numel()
    a_pl, b_pl, o_pl = [], [], []
    for pa, pb in zip(a.placements, b.placements):
        pa = rep if pa.is_partial() else pa
        pb = rep if pb.is_partial() else pb
        if nd == 3 and _strided(pa, 0):
            pair = (pa, pa, pa)
        elif nd == 3 and _strided(pb, 0):
            pair = (pb, pb, pb)
        elif _strided(pa, m) and (pb.is_replicate() or not a_smaller):
            pair = (pa, rep, pa)
        elif _strided(pb, n) and (pa.is_replicate() or a_smaller):
            pair = (rep, pb, type(pb)(nd - 1, split_factor=pb.split_factor))
        elif _strided(pa, m) or _strided(pb, n):
            # the smaller operand gathered, the other's shard kept
            pa, pb = (rep, pb) if _strided(pa, m) else (pa, rep)
            pair = _plain_pair(pa, pb, nd)
        elif _strided(pa, k) and (pb.is_replicate() or pb == type(pa)(
                k - 1, split_factor=pa.split_factor)):
            pair = (pa, type(pa)(k - 1, split_factor=pa.split_factor),
                    Partial())
        elif _strided(pb, k - 1) and pa.is_replicate():
            pair = (type(pb)(k, split_factor=pb.split_factor), pb,
                    Partial())
        elif any(_strided(p, getattr(p, "dim", -1)) for p in (pa, pb)):
            return None
        else:
            pair = _plain_pair(pa, pb, nd)
        if pair is None:
            return None
        a_pl.append(pair[0])
        b_pl.append(pair[1])
        o_pl.append(pair[2])
    if a_pl != list(a.placements):
        a = _moved(a, a_pl)
    if b_pl != list(b.placements):
        b = _moved(b, b_pl)
    shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    return _wrap(func(a._local_tensor, b._local_tensor), mesh, o_pl, shape)


def _plain_pair(pa, pb, nd):
    """(``a``'s, ``b``'s, the product's placement) on one mesh dim for
    ``a @ b`` of ``nd`` dims with plain shards or replicas, the replicated
    operand sliced to the other's shard; None where the shards conflict."""
    from torch.distributed.tensor import Partial, Shard
    m, k = nd - 2, nd - 1
    if nd == 3 and (pa.is_shard(0) or pb.is_shard(0)) \
            and (pa.is_shard(0) or pa.is_replicate()) \
            and (pb.is_shard(0) or pb.is_replicate()):
        return Shard(0), Shard(0), Shard(0)
    if pa.is_shard(k) and (pb.is_shard(k - 1) or pb.is_replicate()) \
            or pb.is_shard(k - 1) and pa.is_replicate():
        return Shard(k), Shard(k - 1), Partial()
    if pa.is_shard(m) and pb.is_replicate():
        return pa, pb, Shard(m)
    if pb.is_shard(k) and pa.is_replicate():
        return pa, pb, Shard(k)
    if pa.is_replicate() and pb.is_replicate():
        return pa, pb, pa
    return None


def _gather_small_operand(a, b):
    """``a @ b`` where a mesh dim shards ``a``'s rows (M) and ``b``'s
    contraction or columns, or ``b``'s columns (N) and ``a``'s
    contraction or rows: the latter operand is gathered there when the
    whole of it is no larger than the rank's output, and the product keeps
    the row or column shard with no reduction. DTensor moved both operands
    to another shard instead: to the contraction's, reducing a partial
    product (attention's scores of queries sharded by sequence and keys
    by key or by hd, whisper's 12 heads over 16 ranks: 99% of
    ``prefill_32k``'s link bytes on the multi-pod mesh, 5.03x the
    reference's), or to the batch's, merged (sequences, heads), which the
    view back to the heads then gathered whole (phi-3's scores in a
    multi-pod train step: 1.7e10 B a rank, 0.21 -> 0.83x the reference's
    peak)."""
    from torch.distributed.tensor import Replicate
    m_dim, k_a, k_b, n_dim = a.ndim - 2, a.ndim - 1, b.ndim - 2, b.ndim - 1
    # the rank's output with all columns, or with all rows
    by_rows = math.prod(a._local_tensor.shape[:-1]) * b.shape[-1]
    by_cols = math.prod(a._local_tensor.shape[:-2]) * a.shape[-2] \
        * b._local_tensor.shape[-1]
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        size = a.device_mesh.size(i)
        if pa.is_shard(m_dim) and (pb.is_shard(k_b) or pb.is_shard(n_dim)) \
                and b._local_tensor.numel() * size <= by_rows:
            b = _moved(b, [
                Replicate() if j == i else p
                for j, p in enumerate(b.placements)])
        elif pb.is_shard(n_dim) and (pa.is_shard(k_a) or pa.is_shard(m_dim)) \
                and a._local_tensor.numel() * size <= by_cols:
            a = _moved(a, [
                Replicate() if j == i else p
                for j, p in enumerate(a.placements)])
    return a, b


def _shard_on(t, i, dim):
    """``t`` sharded on ``dim`` over mesh dim ``i`` (replicated there: a
    local slice, no collective)."""
    from torch.distributed.tensor import Shard
    pl = list(t.placements)
    pl[i] = Shard(dim)
    return _moved(t, pl)


def _softmax_grad_like(grad, out):
    """The softmax gradient ``grad`` placed as the softmax output ``out``
    where ``out`` is sharded off the softmax dim: the backward then runs on
    the forward's shards. DTensor gathered both whole where they differ
    (attention's probabilities sharded by query over ``model``, their
    gradient by key), holding every query's scores on each rank. (A
    softmax dim sharded on the mesh is :func:`_sharded_softmax_backward`'s.)"""
    if any(p.is_partial() for p in out.placements) \
            or list(grad.placements) == list(out.placements):
        return grad
    return _moved(grad, out.placements)


def _stats_over(local, x, dim, dims, op):
    """A rank's ``(..., 1)`` statistic ``local`` of its shard of ``x``
    along ``dim``, reduced (``op``: "max" or "sum") over the mesh ``dims``
    that shard ``dim``, as a plain tensor."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor, Partial, Replicate
    shape = list(x.shape)
    shape[dim] = 1
    t = _wrap(local, x.device_mesh, [Partial(op) if i in dims else p
                                     for i, p in enumerate(x.placements)],
              shape)
    return _moved(t, [
        Replicate() if i in dims else p
        for i, p in enumerate(x.placements)]).to_local()


def _key_sharded(x, dim):
    """The mesh dims that shard ``x``'s ``dim`` (plain or strided
    shards), or None where ``x`` is partial."""
    if any(p.is_partial() for p in x.placements):
        return None
    return [i for i, p in enumerate(x.placements)
            if p.is_shard(dim) or _strided(p, dim)]


def _sharded_softmax(x, dim, half_to_float):
    """``softmax(x, dim)`` over a ``dim`` sharded on the mesh, each rank on
    its own shard: the max and the sum are ``(..., 1)`` statistics reduced
    over the shards (an all-reduce of ``max``, then of ``sum``), and the
    output keeps ``x``'s placements, as XLA's partitioner reduces the
    softmax of a long context's scores, whose keys (the cache's sequence)
    lie on ``data``. DTensor gathered the scores whole over the dim. None
    where ``dim`` is not sharded."""
    from torch.distributed.tensor import DTensor
    dim %= x.ndim
    dims = _key_sharded(x, dim)
    if not dims or half_to_float:
        return None
    local = x._local_tensor
    m = _stats_over(local.amax(dim, keepdim=True), x, dim, dims, "max")
    e = (local - m).exp_()
    e.div_(_stats_over(e.sum(dim, keepdim=True), x, dim, dims, "sum"))
    return _wrap(e, x.device_mesh, x.placements, x.shape, x.stride())


def _sharded_logsumexp(x, dim, keepdim=False):
    """``logsumexp(x, dim)`` over one dim sharded on the mesh, each rank on
    its own shard: ``M + log Σ exp(x − M)`` with the max ``M`` and the
    sum reduced over the shards as ``(..., 1)`` statistics. DTensor
    gathered the whole dim: a train step's cross-entropy over a vocab
    sharded on ``model`` held every rank's logits whole (3 x 4.98e9 B a
    rank, one full-width qwen2-72b layer on (2, 2, 16)). None where the
    dim is not sharded."""
    from torch._prims_common import make_contiguous_strides_for
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if len(dim) != 1:
        return None
    d = dim[0] % x.ndim
    dims = _key_sharded(x, d)
    if not dims:
        return None
    local = x._local_tensor
    m = _stats_over(local.amax(d, keepdim=True), x, d, dims, "max")
    e = (local - m).exp_()
    out = m + _stats_over(e.sum(d, keepdim=True), x, d, dims, "sum").log_()
    del e
    pl = [Replicate() if i in dims else p
          for i, p in enumerate(x.placements)]
    shape = list(x.shape)
    shape[d] = 1
    if not keepdim:
        out = out.squeeze(d)
        del shape[d]
        pl = [Shard(p.dim - 1) if p.is_shard() and p.dim > d else p
              for p in pl]
    return _wrap(out, x.device_mesh, pl, shape)


def _sharded_softmax_backward(grad, out, dim):
    """Softmax's backward ``out · (grad − Σ grad·out)`` over a ``dim`` on
    which ``out`` is sharded, on ``out``'s shards (``grad`` moved there
    first): the sum is a ``(..., 1)`` statistic reduced over the shards.
    None where ``out``'s ``dim`` is not sharded."""
    from torch.distributed.tensor import DTensor
    dim %= out.ndim
    dims = _key_sharded(out, dim)
    if not dims:
        return None
    if list(grad.placements) != list(out.placements):
        grad = _moved(grad, out.placements)
    g, o = grad._local_tensor, out._local_tensor
    t = _stats_over((g * o).sum(dim, keepdim=True), out, dim, dims,
                    "sum")
    return _wrap((g - t).mul_(o), out.device_mesh, out.placements,
                 out.shape, out.stride())


def _local_scatter_add(x, dim, index, src):
    """``x.scatter_add(dim, index, src)`` with ``x`` sharded on ``dim``
    (a logits gradient's vocab): each rank adds the entries whose index
    falls in its columns (the others masked to 0), ``index`` and ``src``
    replicated there first and placed as ``x`` on the other mesh dims. None
    where ``x`` is not sharded on ``dim`` or is partial."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    dim %= x.ndim
    over = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    if not over or not isinstance(index, DTensor) \
            or not isinstance(src, DTensor) \
            or any(p.is_partial() or _strided(p, getattr(p, "dim", -1))
                   for p in x.placements):
        return None
    mesh = x.device_mesh
    pl = [Replicate() if i in over else p
          for i, p in enumerate(x.placements)]
    index = _moved(index, pl).to_local()
    src = _moved(src, pl).to_local()
    local = x._local_tensor
    _, offset = compute_local_shape_and_global_offset(tuple(x.shape), mesh,
                                                      x.placements)
    index = index - offset[dim]
    inside = (index >= 0) & (index < local.shape[dim])
    out = local.scatter_add(dim, torch.where(inside, index, 0),
                            src * inside)
    return _wrap(out, mesh, x.placements, x.shape, x.stride())


def _pointwise_operands(func, a, b):
    """``a`` and ``b`` of a binary pointwise op (``add``, ``sub``, ``mul``,
    ``div``) placed as torch 2.13's DTensor places them, mesh dim by mesh
    dim, where torch 2.11's choice differs:

    * one sharded, the other replicated: the replicated one sliced to the
      shard (its dim under broadcasting; no collective), where 2.11
      gathered the shard (an SSM's per-channel factor on ``model`` times
      its activations);
    * both sharded on other dims: the smaller moved to the other's shard
      (or gathered where its dim there is broadcast), on a tie the second
      (a residual sum whose branch a MoE left on other dims; a
      norm's scale, sharded by sequence, times its activations sharded by
      channel);
    * one partial, the other sharded: the partial one reduce-scattered
      to the other's shard (where 2.11 would move the shard to a partial
      sum, which it does not support, or gathered it; torch 2.13 gathers
      a product's small factor and keeps the product partial, to be
      reduced whole later, and so in a MoE's combine, partial over
      ``data``, lost the batch's shard);
    * one partial, the other replicated (or a scalar): a sum takes the
      replicated one as the partial sum on rank 0 (a scalar: the partial
      one reduce-scattered, :func:`_reduce_scattered`), a product (a
      quotient's numerator) stays partial, where 2.11 reduced the partial
      one.

    Others unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    aten = torch.ops.aten
    sums = func in (aten.add.Tensor, aten.sub.Tensor)
    if not isinstance(a, DTensor):
        return a, b
    if not isinstance(b, DTensor):
        return (_reduce_scattered(a) if sums else a), b
    if any(_strided(p, getattr(p, "dim", -1))
           for p in (*a.placements, *b.placements)):
        return a, b
    pl = [list(a.placements), list(b.placements)]
    ts, relabel = (a, b), [{}, {}]
    for i in range(a.device_mesh.ndim):
        for j in (0, 1):
            me, them = ts[j], ts[1 - j]
            mp, tp = pl[j][i], pl[1 - j][i]
            d = tp.dim + me.ndim - them.ndim if tp.is_shard() else -1
            aligned = 0 <= d and me.shape[d] == them.shape[tp.dim] > 1
            linear = not sums and (func is aten.mul.Tensor or j == 0)
            if mp.is_replicate() and tp.is_shard():
                if aligned:
                    pl[j][i] = Shard(d)
            elif mp.is_shard() and tp.is_shard() \
                    and mp.dim + them.ndim - me.ndim != tp.dim \
                    and (me.numel(), 1 - j) <= (them.numel(), j):
                # the smaller moved (on a tie the second: a residual
                # stream keeps its shards and the branch added moves)
                pl[j][i] = Shard(d) if aligned else Replicate()
            elif mp.is_partial() and tp.is_shard():
                if linear and them.numel() < me.numel():
                    pl[1 - j][i] = Replicate()
                else:
                    pl[j][i] = Shard(d) if aligned else Replicate()
            elif mp.is_partial() and tp.is_replicate():
                if sums:
                    relabel[1 - j][i] = mp
                elif not linear:
                    pl[j][i] = Replicate()
            else:
                continue
            break
    out = []
    for t, p, lab in zip(ts, pl, relabel):
        t = _moved(t, p)
        if lab:
            # rank 0 holds a replicated value as its part of a partial sum
            t = _wrap(t._local_tensor, t.device_mesh, [
                lab.get(i, q) for i, q in enumerate(t.placements)], t.shape,
                t.stride())
        out.append(t)
    return tuple(out)


def _local_pointwise(func, a, b, rest, kwargs):
    """``func(a, b, *rest)`` of a binary pointwise op on each rank's
    shards where :func:`_pointwise_operands` has left them compatible on
    every mesh dim (the same shard, a shard against a broadcast replica,
    partial sums a sum or a product keeps): the local op, the result
    sharded, partial or replicated as they are. DTensor's own choice
    there differs between torches (2.11 reduced a partial factor 2.13
    keeps). None where they are not compatible."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    aten = torch.ops.aten
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or any(
            _strided(p, getattr(p, "dim", -1))
            for p in (*a.placements, *b.placements)):
        return None
    nd = max(a.ndim, b.ndim)
    sums = func in (aten.add.Tensor, aten.sub.Tensor)
    out = []
    for p, q in zip(a.placements, b.placements):
        pd = p.dim + nd - a.ndim if p.is_shard() else None
        qd = q.dim + nd - b.ndim if q.is_shard() else None
        if p.is_shard() or q.is_shard():
            d = pd if pd is not None else qd
            for t, r, rd in ((a, q, qd), (b, p, pd)):
                e = d - (nd - t.ndim)
                if rd is None and not (r.is_replicate() and (
                        e < 0 or t.shape[e] == 1)):
                    return None
            if pd is not None and qd is not None and pd != qd:
                return None
            out.append(Shard(d))
        elif p.is_partial() and q.is_partial():
            if not sums or p != q:
                return None
            out.append(p)
        elif p.is_partial() or q.is_partial():
            if sums or func is aten.div.Tensor and q.is_partial():
                return None
            out.append(p if p.is_partial() else q)
        else:
            out.append(Replicate())
    return _wrap(func(a._local_tensor, b._local_tensor, *rest, **kwargs),
                 a.device_mesh, out, torch.broadcast_shapes(a.shape,
                                                            b.shape))


def _local_permute(func, x, args):
    """``t``, ``transpose`` or ``permute`` of ``x`` with a strided shard:
    the local op, each shard (strided too) following its dim. Torch 2.11
    moved a plain shard's dim and left the strided shard's where it was
    (``t`` of (S(0), _S(0, 16)) gave (S(1), _S(0, 16)))."""
    aten = torch.ops.aten
    n = x.ndim
    if func is aten.t.default:
        perm = list(range(n))[::-1]
    elif func is aten.transpose.int:
        perm = list(range(n))
        d0, d1 = args[0] % n, args[1] % n
        perm[d0], perm[d1] = perm[d1], perm[d0]
    else:
        perm = [d % n for d in args[0]]
    pl = []
    for p in x.placements:
        if _strided(p, getattr(p, "dim", -1)):
            pl.append(type(p)(perm.index(p.dim), split_factor=p.split_factor))
        elif p.is_shard():
            pl.append(type(p)(perm.index(p.dim)))
        else:
            pl.append(p)
    return _wrap(func(x._local_tensor, *args), x.device_mesh, pl,
                 [x.shape[d] for d in perm], [x.stride()[d] for d in perm])


def _reduce_scattered(x):
    """``x`` with its partial sums reduce-scattered, each to the first dim
    whose local size the mesh dim divides (no later mesh dim sharding it),
    else all-reduced: where torch 2.13's DTensor reduces a partial input
    of ``clone``, a non-linear pointwise op (``pow``, ``silu``, ``exp``,
    ``where``, ``silu_backward``) or a sum with a scalar, which torch 2.11
    reduced whole or
    kept partial (attention's queries, partial over ``model``,
    were then all-reduced whole before the scores: one full-width qwen3
    layer's ``prefill_32k`` held 1.03e12 B a rank against 5.58e10)."""
    from torch.distributed.tensor import Replicate, Shard
    if not any(p.is_partial() for p in x.placements):
        return x
    mesh, pl = x.device_mesh, list(x.placements)
    have = list(x._local_tensor.shape)
    for i, p in enumerate(pl):
        if not p.is_partial():
            continue
        m = mesh.size(i)
        ok = [d for d in range(x.ndim) if have[d] % m == 0 and have[d] >= m
              and not any(q.is_shard(d) or _strided(q, d)
                          for q in pl[i + 1:])]
        pl[i] = Shard(ok[0]) if ok else Replicate()
        if ok:
            have[ok[0]] //= m
    return _moved(x, pl)


def _k5_head_shards(func, q, k, v, window, causal):
    """K5 (``repro_torch::swa_attention``) where ``model`` divides the
    query heads and not the kv heads (48 heads of 8 on 16 ranks): each
    rank repeats the kv groups of its own heads out to them and runs K5 on
    its heads with a group of one, q, k and v then sharing the heads'
    shard, as ``HeadRepeat`` does for the plain route. K5's DTensor rule
    (``kernels/swa_attention.py::_sharding``) splits heads only where the
    mesh dim divides the kv heads; DTensor gathered the heads instead, and
    each ``model`` rank ran K5 on all of them. None for any other case."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        return None
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names:
        return None
    i = names.index("model")
    m, h, kh = mesh.size(i), q.shape[2], k.shape[2]
    if m == 1 or h % m or kh % m == 0 or any(
            _strided(p, getattr(p, "dim", -1))
            for t in (q, k, v) for p in t.placements):
        return None
    # partial sums are reduced to the heads' placements
    q_pl = [Shard(2) if j == i else Replicate() if p.is_partial() else p
            for j, p in enumerate(q.placements)]
    if any(p.is_shard(2) for j, p in enumerate(q_pl) if j != i):
        return None
    kv_pl = [Replicate() if j == i else p for j, p in enumerate(q_pl)]
    q, k, v = _moved(q, q_pl), _moved(k, kv_pl), _moved(v, kv_pl)
    group, mine = h // kh, h // m

    def repeated(t):
        return t._local_tensor.narrow(2, 0, -(-mine // group)) \
            .repeat_interleave(group, 2).narrow(2, 0, mine)
    return _wrap(func(q._local_tensor, repeated(k), repeated(v), window,
                      causal), mesh, q_pl, q.shape)


def _local_gather(x, dim, index, sparse_grad=False):
    """``gather(x, dim, index)`` along a ``dim`` that plain shards split
    (a train step's gold logits, the vocab on ``model``): each rank
    gathers the indices that fall in its columns (the others masked to
    0), so the result is partial over those mesh dims, as XLA's
    partitioner gathers from a sharded operand; a partial sum of ``x``
    stays partial (also along a dim no mesh dim splits). DTensor's own
    rule makes a ``_MaskPartial``, which torch 2.11's cannot reduce over
    meta shards (``aten::equal``), and which torch 2.13's could not reduce
    without its mask over a partial ``x``. None where ``x`` is neither
    sharded along ``dim`` nor partial, the indices are partial or a
    placement is strided."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    dim %= x.ndim
    over = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    if not (over or any(p.is_partial() for p in x.placements)) \
            or not isinstance(index, DTensor) or any(
            p.is_partial() for p in index.placements) or any(
            _strided(p, getattr(p, "dim", -1))
            for p in (*x.placements, *index.placements)):
        return None
    mesh, shape = x.device_mesh, tuple(index.shape)
    idx = _moved(index, [Replicate() if i in over or p.is_partial() else p
                         for i, p in enumerate(x.placements)])._local_tensor
    local = x._local_tensor
    _, offset = compute_local_shape_and_global_offset(tuple(x.shape), mesh,
                                                      x.placements)
    idx = idx - offset[dim]
    inside = (idx >= 0) & (idx < local.shape[dim])
    out = local.gather(dim, torch.where(inside, idx, 0)) * inside
    return _wrap(out, mesh, [Partial() if i in over else p
                             for i, p in enumerate(x.placements)], shape)


def _local_row_write(func, x, indices, values, accumulate=False):
    """``index_put(x, (rows, slot), values)`` (or ``index_put_``, which
    writes ``x`` in place and returns it) on each rank's shard, or None
    where the write is not that pattern: ``rows`` is ``arange(x.shape[0])``
    (the caller checks; row b goes to row b), ``slot`` and
    ``values`` DTensors with one entry per row, and ``x`` not partial.
    ``slot`` and ``values`` are redistributed to ``x``'s batch shards (and
    ``values`` to its shards past the slot dim), and the write is the
    local op; along a sharded slot dim (a long context's cache, its
    sequence over ``data``) each rank writes the slots it holds."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    slot = indices[1]
    b = x.shape[0]
    if not (isinstance(slot, DTensor) and isinstance(values, DTensor)) \
            or slot.shape != (b,) or values.ndim != x.ndim - 1 \
            or values.shape[0] != b:
        return None
    slot_pl, val_pl = [], []
    for p in x.placements:
        # along a sharded slot dim the rank holding a slot writes it (XLA's
        # masked update of each shard)
        if p.is_replicate() or p.is_shard(1):
            slot_pl.append(Replicate())
            val_pl.append(Replicate())
        elif p.is_shard(0):
            slot_pl.append(Shard(0))
            val_pl.append(Shard(0))
        elif p.is_shard():
            slot_pl.append(Replicate())
            val_pl.append(Shard(p.dim - 1))
        else:
            return None
    mesh = x.device_mesh
    slot = _moved(slot, slot_pl).to_local()
    values = _moved(values, val_pl).to_local()
    local = x._local_tensor
    rows = torch.arange(local.shape[0], device=local.device)
    out = func(local, [rows, slot], values, accumulate)
    if func._schema.is_mutable:
        return x
    return _wrap(out, mesh, x.placements, x.shape, x.stride())


def _merged_view(func, x, size, groups):
    """A view of ``x`` to ``size`` that merges dims of which a non-leading
    one is sharded (a (batch, heads) pair merged to (batch·heads), the
    heads on ``model``): the local view, the merged dim keeping the
    leading dim's shards and taking a strided shard for the other one
    (split factor: the local sizes of the merged dims before it), as torch
    2.13's DTensor places it; torch 2.11's has no rule for it ("Attempted
    to flatten multiple dimensions"). None where no merge has such a
    shard, where a merge has two, where a mesh dim of the leading dim
    follows the strided one, or where the view splits a sharded dim."""
    from torch.distributed.tensor import Shard, placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    pl = list(x.placements)
    if cls is None or any(_strided(p, getattr(p, "dim", -1)) for p in pl):
        return None
    have = x._local_tensor.shape
    local, out, found = list(size), list(pl), False
    for src, dst in groups:
        src_n = [d for d in src if x.shape[d] > 1]
        dst_n = [d for d in dst if size[d] > 1]
        over = {i: p.dim for i, p in enumerate(pl)
                if p.is_shard() and p.dim in src}
        if not over:
            continue
        if len(dst_n) != 1:
            return None
        to = dst_n[0]
        for d in dst:
            local[d] = 1 if d != to else math.prod(have[d] for d in src_n)
        late = [i for i, d in over.items() if d != src_n[0]]
        if len(late) > 1 or late and any(
                i > late[0] for i, d in over.items() if d == src_n[0]):
            return None
        for i, d in over.items():
            if d == src_n[0]:
                out[i] = Shard(to)
            else:
                out[i] = cls(to, split_factor=math.prod(
                    have[e] for e in src_n if e < d))
                found = True
    if not found:
        return None
    return _wrap(func(x._local_tensor, local), x.device_mesh,
                               out, size)


def _gathered_dims(x, dims):
    """``x`` with the dims ``dims`` gathered (plain or strided shards)."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and p.dim in dims
          or _strided(p, getattr(p, "dim", -1)) and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else _moved(x, pl)


def _local_flip(x, dims):
    """``flip(x, dims)`` on each rank's shard, the flipped dims gathered
    first where they are sharded (SSD's reversed cumulative sums). Torch
    2.11's DTensor has no rule for ``flip``."""
    dims = [d % x.ndim for d in dims]
    x = _gathered_dims(x, dims)
    return _wrap(x._local_tensor.flip(dims), x.device_mesh,
                               x.placements, x.shape)


def _local_pad(x, pad, value=0.0):
    """``constant_pad_nd(x, pad, value)`` on each rank's shard, the padded
    dims gathered first where they are sharded (the SSM conv's causal
    pad of the sequence). Torch 2.11's rule returns a placement for a
    one-dim mesh on a larger one."""
    from torch.distributed.tensor import Replicate
    padded = [x.ndim - 1 - k // 2 for k in range(len(pad)) if pad[k]]
    x = _gathered_dims(x, padded)
    if value and any(p.is_partial() for p in x.placements):
        x = _moved(x, [Replicate() if p.is_partial() else p
                       for p in x.placements])
    shape = list(x.shape)
    for k in range(0, len(pad), 2):
        shape[x.ndim - 1 - k // 2] += pad[k] + pad[k + 1]
    return _wrap(
        torch.constant_pad_nd(x._local_tensor, pad, value), x.device_mesh,
        x.placements, shape)


def _local_part(x, mesh, placements):
    """Rank 0's part of a plain or replicated ``x`` under ``placements``
    (its shards sliced; a partial dim keeps all of ``x``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    full = x._local_tensor if isinstance(x, DTensor) else x
    shape, offset = compute_local_shape_and_global_offset(
        tuple(full.shape), mesh, placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _local_index_add(x, dim, index, src, alpha=1, zeros=False):
    """``index_add(x, dim, index, src)`` into a replicated ``x`` (MoE's
    counts, dispatch buffer and combine), each rank adding into its part of
    ``x``, ``src``'s shards of its other dims kept. Where ``src`` is
    sharded along ``dim``, ``x`` is zeros and ``src`` floating point, and
    the later reduction of a partial result (twice a rank's part of ``x``
    over the mesh dim's size) moves fewer bytes than gathering ``src``'s
    rows (the rank's rows times the mesh dim's size), each rank adds its
    own rows (its shard of the indices) and the result is partial there,
    as XLA scatters (gathering every token's rows onto each rank held
    mixtral-8x22b's multi-pod ``train_4k`` at 1.72x the reference's
    peak); otherwise (MoE's integer counts, a smoke mixtral's dispatch
    buffer over ``model``) the rows and indices are gathered there, as
    torch 2.13 places them. Torch 2.11's
    DTensor has no rule, and its decomposition checks a shard's indices
    against a whole dim. None where ``x`` is sharded or partial."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = next(t.device_mesh for t in (src, index, x)
                if isinstance(t, DTensor))
    if isinstance(x, DTensor) and any(not p.is_replicate()
                                      for p in x.placements):
        return None
    dim %= src.ndim
    split = zeros and src.dtype.is_floating_point
    s_pl, i_pl, out_pl = [], [], []
    if isinstance(src, DTensor):
        # the bytes a rank would receive to gather src's rows there,
        # against twice its part of x that a partial sum reduces later
        keep = math.prod(mesh.size(i) for i, p in enumerate(src.placements)
                         if p.is_shard() and p.dim != dim)
        gather_cost = src._local_tensor.numel()
        partial_cost = 2 * x.numel() / keep
    for i, p in enumerate(src.placements if isinstance(src, DTensor)
                          else [Replicate()] * mesh.ndim):
        if p.is_shard(dim) and split and partial_cost / mesh.size(i) \
                < gather_cost:
            s_pl.append(p)
            i_pl.append(Shard(0))
            out_pl.append(Partial())
            continue
        if p.is_shard(dim) or _strided(p, getattr(p, "dim", -1)) \
                or p.is_partial() and not zeros:
            p = Replicate()
        s_pl.append(p)
        i_pl.append(Replicate())
        out_pl.append(p)
    idx = _moved(index, i_pl)._local_tensor if isinstance(index, DTensor) \
        else _local_part(index, mesh, i_pl)
    val = _moved(src, s_pl)._local_tensor if isinstance(src, DTensor) \
        else src
    local = _local_part(x, mesh, [Replicate() if p.is_partial() else p
                                  for p in out_pl])
    return _wrap(local.index_add(dim, idx, val, alpha=alpha), mesh, out_pl,
                 x.shape)


def _partial_index_put(x, idx, values):
    """``index_put(x, [idx], values, accumulate=True)`` into zeros ``x``
    of a table's shape (the gradient of a lookup), as XLA's partitioner
    scatters: each rank adds its own rows into a table-sized partial sum
    (over the mesh dims that split the rows), a table's column shard where
    ``values`` is sharded on its last dims. Torch 2.11's rule makes an
    unnormalized ``Shard(-1)``. None where a placement is strided."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = values.device_mesh
    n = idx.ndim
    ipl = list(idx.placements) if isinstance(idx, DTensor) \
        else [Replicate()] * mesh.ndim
    if any(_strided(p, getattr(p, "dim", -1)) for p in
           (*ipl, *values.placements)) or any(p.is_partial() for p in ipl):
        return None
    i_to, v_to, out = [], [], []
    for pi, pv in zip(ipl, values.placements):
        if pv.is_partial():
            i_to.append(Replicate())
            v_to.append(pv)
            out.append(Partial())
        elif pv.is_shard() and pv.dim >= n:
            i_to.append(Replicate())
            v_to.append(pv)
            out.append(Shard(pv.dim - n + 1))
        elif pv.is_shard():
            i_to.append(Shard(pv.dim))
            v_to.append(pv)
            out.append(Partial())
        elif pi.is_shard():
            i_to.append(pi)
            v_to.append(Shard(pi.dim))
            out.append(Partial())
        else:
            i_to.append(Replicate())
            v_to.append(Replicate())
            out.append(Replicate())
    if isinstance(idx, DTensor):
        idx = _moved(idx, i_to)._local_tensor
    values = _moved(values, v_to)._local_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, _ = compute_local_shape_and_global_offset(tuple(x.shape), mesh,
                                                      out)
    local = torch.zeros(shape, dtype=x.dtype, device=values.device)
    return _wrap(
        local.index_put([idx], values, accumulate=True), mesh, out, x.shape)


def _column_lookup(table, idx):
    """``table[idx]`` (or ``index_select(table, 0, idx)``) of a 1-D or 2-D
    ``table`` (an embedding lookup, MoE's expert ids and dispatch buffer,
    an ``index_add``'s backward): on a mesh dim that shards the table's
    rows and not the
    indices, a 2-D table's row shard moved to its columns (an all-to-all)
    if no other mesh dim shards them, else gathered; then each rank looks
    up its indices in its part, the rows keeping the indices' shards, as
    torch 2.13's DTensor places it. Torch 2.11's has no rule for a row
    shard of the table under some index placements, nor for indices
    sharded over two mesh dims (the batch over ``pod`` and ``data``), and
    gives a ``_MaskPartial`` for others that its arithmetic cannot reduce
    over meta shards (``aten::equal``). A strided shard of the table is
    gathered. None where the indices are strided or partial."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, n = table.device_mesh, idx.ndim
    if any(_strided(p, getattr(p, "dim", -1)) for p in idx.placements) \
            or any(p.is_partial() for p in idx.placements):
        return None
    cols = any(p.is_shard(1) for p in table.placements)
    t_to, out = [None] * mesh.ndim, [None] * mesh.ndim
    # minor mesh dims first: the first row shard met moves to the columns
    for i in reversed(range(mesh.ndim)):
        pt, pi = table.placements[i], idx.placements[i]
        if _strided(pt, getattr(pt, "dim", -1)):
            # a strided shard of the table is gathered (MoE's dispatch
            # buffer, its rows merged from heads' shards)
            t_to[i], out[i] = Replicate(), pi
        elif pt.is_shard() and pi.is_replicate() and (
                pt.is_shard(1) or not cols and table.ndim == 2):
            t_to[i], out[i] = Shard(1), Shard(n)
            cols = True
        elif pt.is_partial() and pi.is_replicate():
            t_to[i], out[i] = pt, pt
        else:
            t_to[i], out[i] = Replicate(), pi
    i_to = list(idx.placements)
    t = _moved(table, t_to)._local_tensor
    i = _moved(idx, i_to)._local_tensor
    return _wrap(t[i], mesh, out,
                               tuple(idx.shape) + tuple(table.shape[1:]))


class PartitionerPlacements(TorchDispatchMode):
    """Where DTensor's op-by-op placement departs from what a partitioner
    of the whole step (XLA's) does, put right for the dry run:

    * ``new_zeros`` on a DTensor gives a replicated tensor of the whole
      size, whatever the DTensor's sharding: gather's backward
      (``grad.new_zeros(logits shape)``, then ``scatter_add``) would make
      every rank hold the whole batch's logit gradient (196 GiB for
      mamba2-1.3b's ``train_4k``). Here the zeros keep the DTensor's shards
      on the dims whose size they share with it, and take a gathered
      tensor's shards of the same shape on the others (the logits'
      vocab over ``model``, recorded at ``gather``): the ``scatter_add``
      then writes each rank's own columns (:func:`_local_scatter_add`).
      Replicated over the vocab, the logits' gradient was held whole on
      each ``model`` rank (2 x 4.98e9 B a rank, one full-width qwen2-72b
      layer on (2, 2, 16)).
    * A view that splits a sharded dim into factors whose first one the
      mesh dim does not divide (a projection's heads x hd output, sharded
      over 16 ranks, back into 40, 12 or 8 heads), or one sharded by a
      strided shard, has no DTensor rule. XLA pads such a dim; here the
      view's input is gathered over those mesh dims first
      (:func:`_split_gathers`), so the heads after it are replicated
      there.
    * The decode cache write ``cache.index_put_((arange(B), slot), new)``:
      DTensor has no rule that keeps a batch-sharded cache sharded under
      an index, so it gathers the whole cache (phi-3's ``decode_32k``
      moved 474x the reference's link bytes). Row b of the batch
      ``arange`` writes row b, so each rank writes its own rows
      (:func:`_local_row_write`), as XLA's partitioner does.
    * A product with a partial-sum operand: DTensor computes the whole
      product on each rank's partial sums (mamba2's ``in_proj`` after the
      first layer, whose input came partial from ``out_proj``: 3.47x the
      reference's FLOPs at ``prefill_32k``); the sums are reduced first,
      as XLA all-reduces a row-parallel output, and a product that every
      ``model`` rank would compute whole is split there: an lm head whose
      vocab 16 does not divide, attention over heads gathered for an
      uneven view (:func:`_product_operands`).
    * Softmax's backward with its gradient sharded otherwise than its
      output (attention's probabilities by query, their gradient by key,
      over ``model``): DTensor gathered both, every query's scores whole on
      each rank (4.4 copies: 3.837e10 B a rank for one full-width qwen2-72b
      layer on (2, 2, 16), against the reference's 8.79e9). The gradient
      is moved to the output's shards first (:func:`_softmax_grad_like`).
    * Softmax over a dim sharded on the mesh (a one-sequence cache's keys,
      on ``data``): DTensor gathered the scores whole over the dim. Each
      rank keeps its keys, and the max and the sum are ``(..., 1)``
      statistics all-reduced over the shards (:func:`_sharded_softmax`),
      as XLA reduces them; the backward of such a softmax likewise
      (:func:`_sharded_softmax_backward`). The ``w·v`` product after it
      contracts the sharded keys and comes out partial.
    * Slices along a sharded dim (mamba2's one-token ``in_proj`` output
      cut into z, xbc and dt): DTensor gathered the whole tensor once a
      slice; here its slices share one gather
      (:meth:`_gathered_for_slice`)."""

    _PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                 torch.ops.aten.addmm.default,
                 torch.ops.aten.baddbmm.default)
    _INDEX_PUT = (torch.ops.aten.index_put.default,
                  torch.ops.aten.index_put_.default)
    _ARANGE = (torch.ops.aten.arange.default, torch.ops.aten.arange.start,
               torch.ops.aten.arange.start_step)
    _PLAIN_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
    _GATHER = torch.ops.aten.gather.default
    _SCATTER_ADD = torch.ops.aten.scatter_add.default
    _SOFTMAX = torch.ops.aten._softmax.default
    _LOGSUMEXP = torch.ops.aten.logsumexp.default
    _SLICES = (torch.ops.aten.slice.Tensor, torch.ops.aten.select.int)
    _SOFTMAX_BACKWARD = torch.ops.aten._softmax_backward_data.default
    _PERMUTES = (torch.ops.aten.t.default, torch.ops.aten.transpose.int,
                 torch.ops.aten.permute.default)
    _POINTWISE = (torch.ops.aten.add.Tensor, torch.ops.aten.sub.Tensor,
                  torch.ops.aten.mul.Tensor, torch.ops.aten.div.Tensor)
    # a partial input of any pointwise op (``clone`` among them) but these
    # linear ones is reduce-scattered first, as torch 2.13 reduces it
    # (2.11 all-reduced it)
    _LINEAR = (torch.ops.aten.neg.default, torch.ops.aten.mul.Scalar,
               torch.ops.aten.div.Scalar, torch.ops.aten.mul.Tensor,
               torch.ops.aten.div.Tensor)
    _ZEROS = (torch.ops.aten.zeros.default, torch.ops.aten.zeros_like.default)
    _OWN = (torch.ops.aten.flip.default, torch.ops.aten.constant_pad_nd.default,
            torch.ops.aten.index_add.default, torch.ops.aten.index_put.default,
            torch.ops.aten.index.Tensor, torch.ops.aten.index_select.default)

    def __init__(self):
        super().__init__()
        # id of a meta tensor made by arange -> (weakref, (start, end,
        # step)): the values a meta tensor does not hold
        self._aranges = {}
        # id of a DTensor sliced along a sharded dim -> (weakref, version,
        # the DTensor gathered there): its slices share one gather
        self._whole = {}
        # (global shape, dtype) of a tensor ``gather`` read -> its
        # placements, for the zeros of its gradient
        self._gathered_from = {}
        # id of a tensor made by a zeros factory -> weakref
        self._zeros = {}

    def _gathered_for_slice(self, x, dim):
        """``x`` gathered over the mesh dims that shard ``dim`` (plain or
        strided shards), once for all of its slices and selections along
        it while ``x`` is unchanged: DTensor gathered ``x`` whole for each
        (mamba2's one-token ``in_proj`` output, sharded over ``model``,
        three times for z, xbc and dt; the SSD states of a sequence
        sharded over ``model``, their chunks on it, once a chunk of the
        inter-chunk loop: 128 x 1 GiB a layer of jamba's ``prefill_32k``),
        where a partitioner moves each piece once."""
        from torch.distributed.tensor import Replicate
        over = [i for i, p in enumerate(x.placements)
                if p.is_shard(dim) or _strided(p, dim)]
        if not over:
            return x
        key = id(x)
        ref, version, whole = self._whole.get(key, (lambda: None, -1, None))
        if ref() is x and version == x._version:
            return whole
        with torch.no_grad():
            whole = _moved(x, [
                Replicate() if i in over else p
                for i, p in enumerate(x.placements)])
        self._whole[key] = (
            weakref.ref(x, lambda _: self._whole.pop(key, None)),
            x._version, whole)
        return whole

    def _zeroed(self, out):
        key = id(out)
        self._zeros[key] = weakref.ref(out,
                                       lambda _: self._zeros.pop(key, None))
        return out

    def _is_zeros(self, t):
        ref = self._zeros.get(id(t))
        return ref is not None and ref() is t

    def _own_placement(self, func, args, kwargs):
        """The ops this mode places itself on every torch, whatever
        DTensor offers for them (the helpers say why): ``flip``,
        ``constant_pad_nd``, ``index_add`` into a replicated tensor, an
        accumulating ``index_put`` into zeros, and a lookup (``index``,
        ``index_select``) in a tensor
        sharded by rows. None for any other op or pattern."""
        from torch.distributed.tensor import DTensor
        aten = torch.ops.aten
        x = args[0]
        if func is aten.index_add.default:
            return _local_index_add(*args, **kwargs,
                                    zeros=self._is_zeros(x))
        if not isinstance(x, DTensor):
            return None
        if func is aten.flip.default:
            return _local_flip(x, args[1])
        if func is aten.constant_pad_nd.default:
            return _local_pad(*args, **kwargs)
        if func is aten.index_put.default and len(args) > 3 and args[3] \
                and len(args[1]) == 1 and self._is_zeros(x) \
                and isinstance(args[2], DTensor) \
                and all(p.is_replicate() for p in x.placements):
            return _partial_index_put(x, args[1][0], args[2])
        if func is aten.index.Tensor and len(args[1]) == 1 \
                and isinstance(args[1][0], DTensor) and x.ndim <= 2:
            return _column_lookup(x, args[1][0])
        if func is aten.index_select.default and args[1] % x.ndim == 0 \
                and isinstance(args[2], DTensor) and x.ndim <= 2:
            return _column_lookup(x, args[2])
        return None

    def _is_arange(self, t, n):
        """``t`` is a meta tensor that ``arange(n)`` made."""
        ref, ends = self._aranges.get(id(t), (lambda: None, None))
        return ref() is t and ends == (0, n, 1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = self._placed(func, args, kwargs or {})
        ins = {id(a) for a in pytree.tree_leaves((args, kwargs))}
        return pytree.tree_map_only(
            torch.Tensor, lambda t: t if id(t) in ins else _plain_strided(t),
            out)

    def _placed(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate
        x = args[0] if args else None
        if func in self._ARANGE:
            out = func(*args, **kwargs)
            if out.is_meta:
                a, key = tuple(args), id(out)
                self._aranges[key] = (
                    weakref.ref(out, lambda _: self._aranges.pop(key, None)),
                    {1: (0, *a, 1), 2: (*a, 1)}.get(len(a), a[:3]))
            return out
        if func in self._ZEROS:
            return self._zeroed(func(*args, **kwargs))
        if func in self._OWN and any(isinstance(a, DTensor) for a in
                                     pytree.tree_leaves((args, kwargs))):
            with torch.no_grad():
                out = self._own_placement(func, args, kwargs)
            if out is not None:
                return out
        if not isinstance(x, DTensor):
            return func(*args, **kwargs)
        if func in self._PRODUCTS:
            with torch.no_grad():
                out = _strided_product(func, *args) \
                    if func in self._PLAIN_PRODUCTS else None
                if out is not None:
                    return out
                args = _product_operands(func, args)
            return func(*args, **kwargs)
        if func in self._SLICES:
            dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) \
                % x.ndim
            return func(self._gathered_for_slice(x, dim), *args[1:],
                        **kwargs)
        if func in self._INDEX_PUT and len(args[1]) == 2 \
                and args[1][0] is not None \
                and self._is_arange(args[1][0], x.shape[0]):
            out = _local_row_write(func, x, *args[1:], **kwargs)
            if out is not None:
                return out
        if func is self._SOFTMAX:
            with torch.no_grad():
                out = _sharded_softmax(*args)
            if out is not None:
                return out
        if func is self._LOGSUMEXP:
            with torch.no_grad():
                out = _sharded_logsumexp(*args, **kwargs)
            if out is not None:
                return out
        if func is self._SOFTMAX_BACKWARD and isinstance(args[1], DTensor):
            with torch.no_grad():
                out = _sharded_softmax_backward(*args[:3])
                if out is not None:
                    return out
                args = (_softmax_grad_like(*args[:2]),) + tuple(args[1:])
            return func(*args, **kwargs)
        if func is torch.ops.repro_torch.swa_attention.default:
            with torch.no_grad():
                out = _k5_head_shards(func, *args, **kwargs)
            if out is not None:
                return out
        if func in self._POINTWISE and len(args) > 1:
            with torch.no_grad():
                args = _pointwise_operands(func, *args[:2]) + tuple(args[2:])
                out = _local_pointwise(func, args[0], args[1], args[2:],
                                       kwargs)
            return out if out is not None else func(*args, **kwargs)
        if func in self._PERMUTES and any(
                _strided(p, getattr(p, "dim", -1)) for p in x.placements):
            return _local_permute(func, x, args[1:])
        if torch.Tag.pointwise in func.tags and func not in self._LINEAR:
            with torch.no_grad():
                args, kwargs = pytree.tree_map_only(
                    DTensor, _reduce_scattered, (args, kwargs))
            return func(*args, **kwargs)

        if func is self._GATHER:
            self._gathered_from[(tuple(x.shape), x.dtype)] = [
                p if p.is_shard() else Replicate() for p in x.placements]
            with torch.no_grad():
                out = _local_gather(*args, **kwargs)
            if out is not None:
                return out
        if func is self._SCATTER_ADD:
            with torch.no_grad():
                out = _local_scatter_add(*args)
            if out is not None:
                return out
        if func is torch.ops.aten.new_zeros.default and \
                len(args[1]) == x.ndim:
            size = tuple(args[1])
            dtype = kwargs.get("dtype") or x.dtype
            like = self._gathered_from.get((size, dtype), [Replicate()]
                                           * len(x.placements))
            pl = [p if p.is_shard() and size[p.dim] == x.shape[p.dim]
                  else q if p.is_replicate() and q.is_shard()
                  and size[q.dim] != x.shape[q.dim] else Replicate()
                  for p, q in zip(x.placements, like)]
            return self._zeroed(_dtensor_of(
                torch.zeros, size, dtype, x.device_mesh, pl,
                x._local_tensor.device))
        if func is torch.ops.aten.new_zeros.default:
            return self._zeroed(func(*args, **kwargs))
        if func in (torch.ops.aten.view.default,
                    torch.ops.aten._unsafe_view.default):
            size = list(args[1])
            if -1 in size:
                k = size.index(-1)
                size[k] = x.numel() // -math.prod(size)
            groups = _split_groups(tuple(x.shape), size)
            out = _strided_split(func, x, size, groups)
            if out is not None:
                return out
            for strided in (False, True):
                gather = set()
                for src, dst in groups:
                    src = [d for d in src if x.shape[d] > 1]
                    dst = [d for d in dst if size[d] > 1]
                    if len(src) == 1 and len(dst) > 1:
                        gather.update(_split_gathers(
                            x, src[0], size[dst[0]], strided))
                y = x
                if gather:
                    pl = _moved_shards(x, gather, groups, size)
                    with torch.no_grad():
                        y = _moved(x, pl)
                out = _merged_view(func, y, size, groups)
                if out is not None:
                    return out
                try:
                    return func(y, *args[1:], **kwargs)
                except RuntimeError:
                    # DTensor splits some strided shards itself; the others
                    # have no rule, and are gathered
                    if strided:
                        raise
        return func(*args, **kwargs)


@contextlib.contextmanager
def card_alltoall(mesh):
    """DTensor's shard-to-shard redistribution as the card's program issues
    it: one all-to-all (``_dtensor::shard_dim_alltoall``), also on a
    sharded ``cpu`` mesh, where DTensor falls back to an all-gather of the
    whole group's shards and a chunk of it (gloo has no all-to-all). That
    fallback is not the traced device's program: it held the whole group's
    shards on each rank and billed an all-gather (mixtral's train step on
    a (4, 2) mesh, whose in-place AdamW moves each expert gradient to its
    moments' shards, read 1.66x the reference's peak with it and 0.88x
    without). A ``cuda`` mesh, and one rank, need nothing."""
    if mesh is None or mesh.device_type != "cpu" or mesh.size() == 1:
        yield
        return
    from torch.distributed._functional_collectives import (
        _group_or_group_name, _resolve_group)
    from torch.distributed.tensor import placement_types

    def alltoall(local, gather_dim, shard_dim, mesh, mesh_dim):
        group = _group_or_group_name(_resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(local, gather_dim,
                                                     shard_dim, group)
    fallback = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = fallback


@contextlib.contextmanager
def remat_under(modes):
    """Rematerialisation's recomputation under ``modes`` as well. A
    ``remat`` layer (``torch.utils.checkpoint``) runs its forward again in
    the backward pass, and the autograd engine runs it without the
    caller's torch-function modes: there ``FsdpGather`` did not gather the
    weights, and DTensor contracted the recomputed products over their
    ``data`` shards instead. The partial sums over ``data`` were then
    reduced whole: on the (2, 16, 16) mesh the attention output's gradient
    kept its batch sharded over ``pod`` alone (128 of 256 sequences a
    rank), and the probabilities' gradient was gathered whole (qwen2-72b's
    ``train_4k``: 1,579 GiB a rank against the reference's 222). Here each
    checkpoint's recomputation context also enters ``modes``, those not
    active already."""
    import torch.utils.checkpoint as C
    from torch.overrides import _get_current_function_mode_stack
    plain = C.checkpoint

    @contextlib.contextmanager
    def entered(ctx):
        with contextlib.ExitStack() as stack:
            stack.enter_context(ctx)
            active = _get_current_function_mode_stack()
            for m in modes:
                if not any(a is m for a in active):
                    stack.enter_context(m)
            yield

    def checkpoint(fn, *args, context_fn=C.noop_context_fn, **kwargs):
        def contexts():
            forward, recompute = context_fn()
            return forward, entered(recompute)
        return plain(fn, *args, context_fn=contexts, **kwargs)
    C.checkpoint = checkpoint
    try:
        yield
    finally:
        C.checkpoint = plain


def trace(fn, args, mesh=None, weights=(), fsdp=(), tables=()):
    """Run ``fn(*args)`` once under the analyzer, its arguments counted
    live throughout (the caller holds them, as a trainer holds its state
    through a step), ``weights`` gathered over the ``fsdp`` mesh dims as
    they are used (the embedding ``tables`` among them as
    ``FsdpGather`` says). Returns the ``ModuleStats``."""
    from torch.distributed.tensor.experimental import implicit_replication
    K4.register_sharding()
    K5.register_sharding()
    an = OpAnalyzer("meta", mesh)
    an.track(tree_leaves(args))
    placed = (FsdpGather(weights, fsdp, tables), HeadRepeat())
    # PartitionerPlacements inside the analyzer: a mode that gives DTensor
    # ops back (the analyzer) hides them from the modes outside it
    with implicit_replication(), card_alltoall(mesh), remat_under(placed), \
            placed[0], placed[1], an, PartitionerPlacements():
        out = fn(*args)
    del out
    return an.stats()


def _fsdp_weights(params, mesh):
    """(the weights a step gathers over ``data``, the ``data`` mesh dim,
    the embedding tables): every leaf but the experts'. An expert's
    product takes its tokens from the dispatch buffer, which is not
    sharded by batch, so gathering the expert over ``data`` would repeat
    the product on every ``data`` rank; DTensor's own choice (the
    contraction over ``data``) is kept, and under expert parallelism the
    ``data`` shard is the expert dim."""
    out = []
    map_with_path(lambda path, t: None if "moe" in path and path[-1] in (
        "wi", "wg", "wo") else out.append(t), params)
    tables = [params[k] for k in ("tok_embed", "unembed") if k in params]
    return out, (tuple(mesh.mesh_dim_names).index("data"),), tables


def analyze_step(cfg, shape, mesh, expert_parallel=False):
    """Trace ``cfg``'s step at ``shape`` on ``mesh`` over meta shards."""
    fn, args = build_step_and_args(cfg, shape, mesh, expert_parallel)
    params = args[0].params if shape.kind == "train" else args[0]
    return trace(fn, args, mesh, *_fsdp_weights(params, mesh))


def analyze_hfl(cfg, shape, mesh, quant_bits=0):
    """(local step stats, sync stats) of the hierarchical mode."""
    (fn, args), (sync_fn, sync_args) = build_hfl_steps_and_args(
        cfg, shape, mesh, quant_bits=quant_bits)
    return (trace(fn, args, mesh, *_fsdp_weights(
        args[0].params, args[0].params["tok_embed"].device_mesh)),
            trace(sync_fn, sync_args, mesh))


def run_one(arch: str, shape_name, mesh_kind: str,
            expert_parallel=False, cfg=None, tag="", hfl=False,
            quant_bits=0, device="cuda", mesh_shape=None):
    """One dry run as a JSON-ready record. ``shape_name``: a key of
    ``INPUT_SHAPES`` or an ``InputShape``; ``mesh_shape``: (data, model)
    or (pod, data, model) for a local mesh in place of the production
    one of ``mesh_kind``."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
           "kind": shape.kind, "tag": tag, "hfl": bool(hfl),
           "device": device,
           "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
           "expert_parallel": bool(expert_parallel)}
    reason = should_skip(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    if mesh_shape is None:
        n_dev = 512 if mesh_kind == "multi" else 256
    else:
        n_dev = math.prod(mesh_shape)
        *pod, data, model = mesh_shape
    try:
        with fake_world(n_dev):
            if mesh_shape is None:
                mesh = make_production_mesh(
                    multi_pod=(mesh_kind == "multi"), device_type=device)
            else:
                mesh = make_local_mesh(data, model, pod=pod[0] if pod else 0,
                                       device_type=device)
            t0 = time.time()
            if hfl:
                ms, sync_ms = analyze_hfl(cfg, shape, mesh,
                                          quant_bits=quant_bits)
                rec["sync_collective_bytes_per_dev"] = sync_ms.collective_bytes
                rec["sync_link_bytes_per_dev"] = sync_ms.collective_link_bytes
                rec["sync_collectives_by_dim"] = sync_ms.collectives_by_dim
            else:
                ms = analyze_step(cfg, shape, mesh, expert_parallel)
            rec.update({
                "status": "ok",
                "n_devices": n_dev,
                "trace_s": round(time.time() - t0, 2),
                "op_flops_per_dev": ms.flops,
                "op_matmul_flops_per_dev": ms.matmul_flops,
                "op_kernel_flops_per_dev": ms.kernel_flops,
                "op_kernel_calls": ms.kernel_calls,
                "op_bytes_per_dev": ms.bytes,
                "collective_bytes_per_dev": ms.collective_bytes,
                "collective_link_bytes_per_dev": ms.collective_link_bytes,
                "n_collectives": ms.n_collectives,
                "collectives_by_dim": ms.collectives_by_dim,
                "n_ops": ms.n_ops,
                "mem_peak_bytes_per_dev": ms.peak_bytes,
                "model_flops_global": model_flops(cfg, shape),
            })
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots", "none"])
    ap.add_argument("--attn-impl", default=None,
                    choices=[None, "naive", "chunked", "flash"])
    ap.add_argument("--swa-override", type=int, default=0,
                    help="retrofit sliding-window attention (window N) onto "
                         "full-attention archs so long_500k decode runs "
                         "(rows marked swa-retrofit, DESIGN.md §5)")
    ap.add_argument("--hfl", action="store_true",
                    help="trace the hierarchical (AutoFLSat) local+sync "
                         "steps instead of the plain train step (multi only)")
    ap.add_argument("--quant-bits", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the traced mesh (the shards are meta)")
    args = ap.parse_args(argv)
    if args.hfl:
        args.mesh = "multi"

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                suffix = f"__{args.tag}" if args.tag else ""
                f = outdir / f"{arch}__{shape}__{mk}{suffix}.json"
                if args.skip_existing and f.exists():
                    prev = json.loads(f.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached ] {f.name}", flush=True)
                        continue
                cfg = get_config(arch)
                if args.remat:
                    cfg = dataclasses.replace(cfg, remat=args.remat)
                if args.attn_impl:
                    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
                if args.swa_override and cfg.encoder is None \
                        and not cfg.sliding_window \
                        and cfg.arch_type not in ("ssm", "hybrid"):
                    cfg = dataclasses.replace(
                        cfg, sliding_window=args.swa_override)
                rec = run_one(arch, shape, mk, args.expert_parallel, cfg=cfg,
                              tag=args.tag, hfl=args.hfl,
                              quant_bits=args.quant_bits, device=args.device)
                f.write_text(json.dumps(rec, indent=1))
                s = rec["status"]
                n_ok += s == "ok"
                n_skip += s == "skipped"
                n_err += s == "error"
                extra = ""
                if s == "ok":
                    extra = (f"trace={rec['trace_s']}s "
                             f"flops/dev={rec['op_flops_per_dev']:.3e} "
                             f"link B/dev={rec['collective_link_bytes_per_dev']:.3e} "
                             f"peak GiB/dev={rec['mem_peak_bytes_per_dev'] / 2**30:.2f}")
                elif s == "error":
                    extra = rec["error"][:120]
                print(f"[{s:7s}] {arch} x {shape} x {mk} {extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err}", flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
