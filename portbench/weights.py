"""Weights from the seed, made by the benchmark and handed to both sides.

The program takes its parameters as a tree (nested dicts and tuples of
float32 tensors, the type it serves and trains them in). The benchmark
takes the shapes from the configuration's reference (``param_shapes``)
and draws every leaf itself: one large call a leaf, on the device, from a
generator seeded by the run's seed and the leaf's path, by the rule the
configuration file gives for that path. So any leaf can be drawn again
alone (the training cell's check of the parameters' change does),
bitwise the same.

A path is the dotted key of a leaf: ``layers.0.ssm.in_proj``, the
superblock offset as the second part.
"""
from __future__ import annotations

import math
import zlib


def tree(by_path):
    """The program's tree of ``by_path``'s leaves: a dotted path's parts
    are dict keys, and a run of numeric parts under one key (the layer
    offsets of ``layers``) a tuple."""
    root = {}
    for path, leaf in by_path.items():
        node, parts = root, path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def stacked(path):
    """True for a leaf stacked over the model's layers (leading axis)."""
    return path.startswith("layers.")


def rule_for(init_rules, path):
    """The first rule whose pattern is the path or a dotted suffix of it."""
    for pattern, rule in init_rules:
        if path == pattern or path.endswith("." + pattern):
            return rule
    raise KeyError(f"no init rule in the configuration for {path!r}")


def leaf_seed(seed, path):
    """A generator seed from the run's seed and the leaf's path (seeds up
    to 2**63 are taken as they are)."""
    return (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (2 ** 63)


def draw(torch, rule, shape, seed, path, device):
    """One float32 leaf of ``shape`` by ``rule``."""
    f32 = torch.float32
    if rule == "ones":
        return torch.ones(shape, dtype=f32, device=device)
    if rule == "zeros":
        return torch.zeros(shape, dtype=f32, device=device)
    if rule == "log_arange":
        # log(1 .. n) over the last axis: Mamba-2's A = -(1 .. n)
        n = shape[-1]
        return torch.log(torch.arange(1, n + 1, dtype=f32, device=device)
                         ).expand(shape).clone()
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    if "normal" in rule:
        std = rule["normal"]
        if isinstance(std, list):          # fan-in over the listed axes
            std = math.prod(shape[a] for a in std) ** -0.5
        return torch.randn(shape, generator=gen, dtype=f32,
                           device=device).mul_(std)
    if "dt_bias" in rule:
        # softplus(dt_bias) log-uniform over [dt_min, dt_max]
        lo, hi = (math.log(v) for v in rule["dt_bias"])
        u = torch.rand(shape, generator=gen, dtype=f32, device=device)
        dt = torch.exp(u * (hi - lo) + lo)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init rule {rule!r} for {path!r}")


def make(torch, init_rules, shapes, seed, device, lead=()):
    """The weights of ``shapes`` ({path: shape}): a dict of path ->
    float32 tensor, each with ``lead`` prepended to its shape and the same
    values in every slice of it."""
    out = {}
    for path, shape in sorted(shapes.items()):
        shape = tuple(shape)
        leaf = draw(torch, rule_for(init_rules, path), shape, seed, path,
                    device)
        if lead:
            full = torch.empty(lead + shape, dtype=leaf.dtype, device=device)
            full.copy_(leaf.expand(lead + shape))
            leaf = full
        out[path] = leaf
    return out


def layer_norms(torch, x, path):
    """Norm of each layer's slice of a stacked leaf, else of the leaf: a
    1-D float32 tensor (on the leaf's device; no host read)."""
    x = x.to(torch.float32)
    if stacked(path):
        return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)
    return torch.linalg.vector_norm(x).reshape(1)
