"""Path-based parameter and input partitioning rules. Port of the JAX
package's ``sharding/partition.py``.

2-D sharding: every large weight puts one dim on ``model`` (tensor
parallel) and one on ``data`` (FSDP/ZeRO-3 storage sharding, which the
reference's XLA serves with per-layer all-gathers; DTensor instead places
op by op, and may gather the activations). Dims shard only when divisible
by the axis size — e.g. whisper/mamba2 vocab sizes are indivisible by 16
and stay replicated.

Mesh axes: single-pod ("data", "model"); multi-pod ("pod", "data",
"model"). Params never shard over ``pod`` (each pod = one AutoFLSat
cluster replica); batch shards over ("pod", "data").

Spec trees hold :class:`P`, the port's counterpart of JAX's
``PartitionSpec`` (an entry per tensor dim: ``None``, an axis name, or a
tuple of names, major to minor), so they compare spec for spec with the
JAX package's. A mesh is anything with ``mesh_dim_names`` and ``shape``:
an ``AbstractMesh`` or a ``DeviceMesh``. :func:`named` turns specs into
DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import os

from repro_torch.models import model as M


class P:
    """A partition spec: one entry per leading tensor dim (dims past the
    last entry are unsharded). A one-name tuple is stored as the name, as
    JAX's ``PartitionSpec`` stores it."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1
                            else p for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self):
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other):
        return isinstance(other, P) and self._parts == other._parts

    def __hash__(self):
        return hash(self._parts)

    def __repr__(self):
        return f"P{self._parts!r}"


# ---------------------------------------------------------------------------


def _axsize(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def _maybe(mesh, axis, dim):
    """Use `axis` for a dim of size `dim` only when divisible."""
    return axis if dim % _axsize(mesh, axis) == 0 else None


def _rule(mesh, path_names, shape, expert_parallel=False):
    """P for one (unstacked) param leaf."""
    name = path_names[-1]
    d = _maybe
    if name == "tok_embed":
        return P(d(mesh, "model", shape[0]), d(mesh, "data", shape[1]))
    if name == "unembed":
        return P(d(mesh, "data", shape[0]), d(mesh, "model", shape[1]))
    # never shard the hd (head-feature) dim: attention contracts over it,
    # and a sharded contraction all-reduces the full (heads, S, S) score
    # tensor. Indivisible head counts replicate heads. REPRO_SHARD_HD=1
    # restores the rule that shards it (baseline bookkeeping only).
    shard_hd = os.environ.get("REPRO_SHARD_HD") == "1"
    if name in ("wq", "wk", "wv") and len(shape) == 3:
        dmod, h, hd = shape
        if h % _axsize(mesh, "model") == 0:
            return P(d(mesh, "data", dmod), "model", None)
        return P(d(mesh, "data", dmod), None,
                 d(mesh, "model", hd) if shard_hd else None)
    if name == "wo" and len(shape) == 3:          # (H, hd, D) attention out
        h, hd, dmod = shape
        if h % _axsize(mesh, "model") == 0:
            return P("model", None, d(mesh, "data", dmod))
        return P(None, d(mesh, "model", hd) if shard_hd else None,
                 d(mesh, "data", dmod))
    if name in ("bq", "bk", "bv"):
        h, hd = shape
        if h % _axsize(mesh, "model") == 0:
            return P("model", None)
        return P(None, d(mesh, "model", hd) if shard_hd else None)
    if name in ("wi", "wg") and len(shape) == 2:  # mlp (D, F)
        return P(d(mesh, "data", shape[0]), d(mesh, "model", shape[1]))
    if name == "wo" and len(shape) == 2:          # mlp (F, D)
        return P(d(mesh, "model", shape[0]), d(mesh, "data", shape[1]))
    if name == "router":
        return P(d(mesh, "data", shape[0]), None)
    if name in ("wi", "wg") and len(shape) == 3:  # moe (E, D, F)
        e_ax = d(mesh, "data", shape[0]) if expert_parallel else None
        return P(e_ax, None if expert_parallel else d(mesh, "data", shape[1]),
                 d(mesh, "model", shape[2]))
    if name == "wo" and len(shape) == 3:          # moe (E, F, D)
        e_ax = d(mesh, "data", shape[0]) if expert_parallel else None
        return P(e_ax, d(mesh, "model", shape[1]),
                 None if expert_parallel else d(mesh, "data", shape[2]))
    if name == "in_proj":                         # ssm (D, ·)
        return P(d(mesh, "data", shape[0]), d(mesh, "model", shape[1]))
    if name == "out_proj":                        # ssm (d_inner, D)
        return P(d(mesh, "model", shape[0]), d(mesh, "data", shape[1]))
    if name == "conv_w":
        return P(None, d(mesh, "model", shape[1]))
    if name in ("conv_b", "norm_scale") and len(shape) == 1:
        return P(d(mesh, "model", shape[0]))
    if name in ("A_log", "D", "dt_bias"):
        return P(d(mesh, "model", shape[0]))
    if name == "w" and len(shape) == 2:           # vision projector
        return P(None, d(mesh, "data", shape[1]))
    # norms, small biases, scalars
    return P(*([None] * len(shape)))


def _path_names(path):
    """Names of a tree path as the reference spells them: dict keys as
    themselves, sequence indices as ``[i]``, NamedTuple fields by name."""
    return [f"[{k}]" if isinstance(k, int) else str(k) for k in path]


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of a dict / tuple / list /
    NamedTuple tree; ``path`` holds dict keys, field names and sequence
    indices (ints)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg, mesh, expert_parallel=False):
    """Tree of P matching init_params(cfg) structure."""
    abstract = M.abstract_params(cfg)

    def leaf_spec(path, leaf):
        names = _path_names(path)
        stacked = "layers" in names
        shape = leaf.shape[1:] if stacked else leaf.shape
        spec = _rule(mesh, names, shape, expert_parallel)
        if stacked:
            spec = P(*((None,) + tuple(spec)))
        return spec

    return map_with_path(leaf_spec, abstract)


# ---------------------------------------------------------------------------
# inputs / caches
# ---------------------------------------------------------------------------


def _dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _dp_size(mesh):
    n = 1
    for a in _dp_axes(mesh):
        n *= _axsize(mesh, a)
    return n


def batch_specs(cfg, mesh, batch_tree):
    """Specs for a train/prefill batch dict (shard batch dim over DP axes)."""
    dp = _dp_axes(mesh)

    def spec(path, leaf):
        b = leaf.shape[0]
        lead = dp if b % _dp_size(mesh) == 0 else None
        return P(lead, *([None] * (leaf.dim() - 1)))

    return map_with_path(spec, batch_tree)


def cache_specs(cfg, mesh, cache_tree):
    """Decode-cache specs: batch over DP axes; if batch=1 (long-context),
    shard the KV seq axis over `data`; head/state dims over `model`."""
    dp = _dp_axes(mesh)
    msz = _axsize(mesh, "model")

    def spec(path, leaf):
        name = _path_names(path)[-1]
        shp = leaf.shape                      # (ns, B, ...)
        b = shp[1]
        bspec = dp if b % _dp_size(mesh) == 0 else None
        if name in ("k", "v", "xk", "xv"):
            ns, _, s, kh, hd = shp
            sspec = None
            if bspec is None and s % _axsize(mesh, "data") == 0:
                sspec = "data"
            # same rule as weights: never shard hd (contracted in attention)
            if kh % msz == 0:
                hspec = ("model", None)
            elif os.environ.get("REPRO_SHARD_HD") == "1":
                hspec = (None, "model" if hd % msz == 0 else None)
            else:
                hspec = (None, None)
            return P(None, bspec, sspec, hspec[0], hspec[1])
        if name == "conv":
            ch = shp[3]
            return P(None, bspec, None, "model" if ch % msz == 0 else None)
        if name == "ssm":
            h = shp[2]
            return P(None, bspec, "model" if h % msz == 0 else None, None,
                     None)
        return P(*([None] * leaf.dim()))

    return map_with_path(spec, cache_tree)


def decode_arg_specs(cfg, mesh, decode_tree):
    """Specs for {"cache":..., "tokens": (B,1), "pos": (B,)}."""
    dp = _dp_axes(mesh)
    cache = cache_specs(cfg, mesh, decode_tree["cache"])
    b = decode_tree["tokens"].shape[0]
    bspec = dp if b % _dp_size(mesh) == 0 else None
    return {"cache": cache,
            "tokens": P(bspec, None),
            "pos": P(bspec)}


def train_state_specs(cfg, mesh, expert_parallel=False):
    from repro_torch.train.steps import TrainState
    ps = param_specs(cfg, mesh, expert_parallel)
    return TrainState(params=ps, opt={"m": ps, "v": ps, "step": P()})


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec):
    """DTensor placements of one P on ``mesh``, one per mesh dim:
    ``Shard(tensor dim)`` or ``Replicate()``. A tuple entry shards one
    tensor dim over several mesh dims, major to minor, which is DTensor's
    order only when the names come in mesh order; it must. A mesh dim of
    size 1 replicates: a shard over it is the whole dim, and torch 2.11's
    view rules refuse to flatten a dim "sharded" over it. (This serves
    meshes with a dim of size 1, such as the one-rank mesh that
    ``chip_smoke.py`` phase 11 restores onto; the one-rank dry run traces
    plain tensors, ``launch.dryrun.meta_dtensor``.)"""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    taken = set()
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: axes {axes} of dim {dim} are not in "
                             f"the mesh order {names}")
        for i in pos:
            if i in taken:
                raise ValueError(f"{spec}: mesh axis {names[i]} shards two "
                                 "tensor dims")
            taken.add(i)
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def named(mesh, spec_tree):
    """The tree of DTensor placements of a tree of P on ``mesh``."""
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda s: placements(mesh, s), spec_tree)
