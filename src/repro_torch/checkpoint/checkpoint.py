"""Checkpointing: tree of tensors <-> .npz, device-aware restore. Port of
the JAX package's ``checkpoint/checkpoint.py``; the two read each other's
files.

Leaves are stored under their joined tree path (dict keys, tuple indices,
NamedTuple field names: ``params/layers/0/ssm/in_proj``, ``opt/step``);
structure round-trips through any dict/tuple/NamedTuple nesting
(``TrainState`` included). ``restore_pytree`` places every leaf on the
``device`` it is given, or shards it over a ``DeviceMesh``.

Durability (the on-disk fault story): ``save_pytree`` writes to a temp
file in the target directory, fsyncs it and ``os.replace``s it into place
— a crash or power cut mid-save can truncate only the temp file, never the
live checkpoint — and stores a CRC32 per leaf under ``__meta__/crc/<key>``.
``restore_pytree`` re-hashes every leaf it loads and raises
``ChecksumError`` on mismatch, so a bit flipped on disk surfaces as a hard
error instead of silently restoring garbage weights. Checkpoints written
before CRCs existed restore without verification."""
from __future__ import annotations

import os
import pathlib
import tempfile
import zlib

import numpy as np
import torch

from repro_torch import resolve_device


class ChecksumError(ValueError):
    """A checkpoint leaf's on-disk bytes fail their stored CRC32."""


def _flatten_with_paths(tree, prefix=()):
    """[(key path, leaf)] in the reference's flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if hasattr(tree, "_fields"):                      # NamedTuple
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f),
                                              prefix + (f,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(template, leaves, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves,
                                           prefix + (f,))
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaves["/".join(prefix)]


def _leaf_crc(arr) -> np.uint32:
    return np.uint32(zlib.crc32(np.ascontiguousarray(arr).tobytes()))


def save_pytree(path, tree, extra_meta=None):
    path = pathlib.Path(path)
    if path.suffix != ".npz":          # np.savez(path) would append it
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    arrs = {k: np.asarray(v.detach().cpu()) if torch.is_tensor(v)
            else np.asarray(v) for k, v in _flatten_with_paths(tree)}
    for k in list(arrs):               # per-leaf CRC32 (on-disk SEU guard)
        arrs[f"__meta__/crc/{k}"] = _leaf_crc(arrs[k])
    if extra_meta:
        for k, v in extra_meta.items():
            arrs[f"__meta__/{k}"] = np.asarray(v)
    # atomic publish: write the whole archive to a temp file in the same
    # directory, fsync, then os.replace — a crash mid-save can never leave
    # a truncated .npz at the live path
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrs)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def restore_pytree(path, template, device="cuda", mesh=None,
                   placements=None):
    """Restore into the structure of ``template`` (values ignored; a tree
    of tensors, meta tensors included), every leaf in its template
    leaf's dtype on ``device`` (default the card).

    ``placements``: optional tree of DTensor placements matching
    ``template`` (``sharding.partition.named``), over the ``DeviceMesh``
    ``mesh`` of ``device``'s type: each leaf is ``distribute_tensor``ed
    with its placements, so a checkpoint written on one mesh restores onto
    another (the reference's ``shardings=``)."""
    device = resolve_device(device)
    leaves = {}
    with np.load(path, allow_pickle=False) as data:
        for key, leaf in _flatten_with_paths(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            crc_key = f"__meta__/crc/{key}"
            if crc_key in data and \
                    _leaf_crc(arr) != np.uint32(data[crc_key]):
                raise ChecksumError(
                    f"{key}: CRC32 mismatch — checkpoint bytes corrupted on "
                    "disk (or the file was tampered with)")
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            leaves[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device, dtype=leaf.dtype)
    tree = _unflatten(template, leaves)
    if placements is None:
        return tree
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), tree,
                    placements)


def load_meta(path):
    with np.load(path, allow_pickle=False) as data:
        return {k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith("__meta__/")}
