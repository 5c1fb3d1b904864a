"""Non-IID client label skew (Dirichlet), behind the random seam.

Port of ``dirichlet_labels`` from the JAX package's ``data/partition.py``.
"""
from __future__ import annotations


def dirichlet_labels(source, n_clients, n_per_client, n_classes, alpha):
    """Per-client label arrays (K, N) int64 with Dirichlet(alpha) skew:
    per-client class mixes from ``source.label_mix``, then ``n_per_client``
    labels per client from ``source.client_labels``."""
    probs = source.label_mix(n_clients, n_classes, alpha)      # (K, C)
    return source.client_labels(probs, n_per_client)
