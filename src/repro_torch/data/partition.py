"""Non-IID client partitioning (Dirichlet label skew), behind the random
seam. Port of the JAX package's ``data/partition.py``.
"""
from __future__ import annotations

import torch


def dirichlet_labels(source, n_clients, n_per_client, n_classes, alpha):
    """Per-client label arrays (K, N) int64 with Dirichlet(alpha) skew:
    per-client class mixes from ``source.label_mix``, then ``n_per_client``
    labels per client from ``source.client_labels``."""
    probs = source.label_mix(n_clients, n_classes, alpha)      # (K, C)
    return source.client_labels(probs, n_per_client)


def dirichlet_partition(source, labels, n_clients, alpha):
    """Partition an existing label array (N,) into client index lists
    (ragged -> truncated to the min client size for static shapes), a
    (K, m) int64 tensor. Per-client class mixes from
    ``source.partition_mix``; each sample goes to a client drawn by
    ``source.sample_clients`` with weights its class's share in each
    client's mix."""
    n_classes = int(labels.max()) + 1
    probs = source.partition_mix(n_clients, n_classes, alpha)  # (K, C)
    cls_probs = probs[:, labels].T                             # (N, K)
    cls_probs = cls_probs / cls_probs.sum(-1, keepdim=True)
    assign = source.sample_clients(cls_probs)
    idx = [torch.where(assign == c)[0] for c in range(n_clients)]
    m = min(int(i.shape[0]) for i in idx)
    m = max(m, 1)
    return torch.stack([i[:m] for i in idx])
