"""The port's one seam for random numbers.

The JAX package draws with ``jax.random`` (threefry), which torch cannot
reproduce. Every draw of the port therefore goes through a *random
source*: an object with the methods of :class:`TorchRandom`, built from a
seed by a factory (``random_source(seed)``). Each method names one draw
site of the reference, so a source backed by ``jax.random`` can replay the
reference's exact key stream:

dataset draws (``data/synthetic.py``, seed = ``SimConfig.seed``)
    ``class_prototypes``, ``label_mix``, ``client_labels``,
    ``train_noise``, ``test_labels``, ``test_noise``;
partitioning an existing label array (``data/partition.py``)
    ``partition_mix`` — the reference's ``dirichlet(key, ...)`` per-client
    class mix; ``sample_clients`` — its per-sample ``choice`` of a client
    over ``split(key, n_samples)``;
model init (``models/small.py``, seed = ``FLConfig.seed``)
    ``init_normals`` — the reference's ``split(PRNGKey(seed))`` init key;
training order (``core/spaceify.py``, ``core/autoflsat.py``)
    ``round_keys(m)`` — the reference's ``split(self.key, m + 1)``: the
    engine key advances, ``m`` client keys come back;
    ``event_key()`` — FedBuff's ``self.key, sub = split(self.key)`` at
    each processed client return: the engine key advances, one client
    key comes back;
    ``permutations(key, n, n_epochs)`` — per epoch ``k, sub = split(k)``
    then ``permutation(sub, n)``.

Every method returns CPU tensors; callers move them to their device, so a
run on the card and a run on the CPU see the same draws.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch


class TorchRandom:
    """Default random source: one seeded ``torch.Generator`` on the CPU.

    A client key from :meth:`round_keys` is a plain integer, the seed of
    that client's permutation stream, so a key reused for a pad slot
    replays the first client's permutations, as in the reference."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.g = torch.Generator().manual_seed(self.seed)

    # -- dataset ---------------------------------------------------------
    def class_prototypes(self, n_classes: int, channels: int):
        """(freqs ~ N(0, 1), phases ~ U[0, 1)), each (n_classes, 4, c)."""
        shape = (n_classes, 4, channels)
        return (torch.randn(shape, generator=self.g),
                torch.rand(shape, generator=self.g))

    def label_mix(self, n_clients: int, n_classes: int, alpha: float):
        """Per-client class probabilities ~ Dirichlet(alpha), (K, C)."""
        g = _gamma(alpha, n_clients * n_classes, self.g)
        g = g.reshape(n_clients, n_classes)
        return (g / g.sum(1, keepdim=True)).to(torch.float32)

    def client_labels(self, probs, n_per_client: int):
        """(K, N) int64 labels, row k drawn from ``probs[k]``."""
        return torch.multinomial(probs.to(torch.float64), n_per_client,
                                 replacement=True, generator=self.g)

    def partition_mix(self, n_clients: int, n_classes: int, alpha: float):
        """Per-client class probabilities ~ Dirichlet(alpha), (K, C)."""
        return self.label_mix(n_clients, n_classes, alpha)

    def sample_clients(self, probs):
        """(N,) int64: sample i's client, drawn from ``probs[i]`` (N, K)."""
        return torch.multinomial(probs.to(torch.float64), 1,
                                 generator=self.g)[:, 0]

    def train_noise(self, shape):
        return torch.randn(tuple(shape), generator=self.g)

    def test_labels(self, n_test: int, n_classes: int):
        return torch.randint(0, n_classes, (n_test,), generator=self.g)

    def test_noise(self, shape):
        return torch.randn(tuple(shape), generator=self.g)

    # -- model init ------------------------------------------------------
    def init_normals(self, shapes: Sequence[tuple]) -> List[torch.Tensor]:
        """One N(0, 1) float32 draw per weight leaf, in ``shapes`` order."""
        return [torch.randn(tuple(s), generator=self.g) for s in shapes]

    # -- training order --------------------------------------------------
    def round_keys(self, m: int) -> list:
        """Advance the engine key and return ``m`` client keys."""
        return torch.randint(0, 2 ** 62, (m,), generator=self.g).tolist()

    def event_key(self):
        """Advance the engine key and return one client key."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.g))

    def permutations(self, key, n: int, n_epochs: int):
        """(n_epochs, n) int64: the client's minibatch order per epoch."""
        g = torch.Generator().manual_seed(int(key))
        return torch.stack([torch.randperm(n, generator=g)
                            for _ in range(n_epochs)]) \
            if n_epochs else torch.empty((0, n), dtype=torch.int64)


def _gamma(alpha: float, n: int, gen: torch.Generator) -> torch.Tensor:
    """n float64 draws of Gamma(alpha, 1) from ``gen`` (Marsaglia & Tsang,
    2000; alpha < 1 is boosted as Gamma(alpha + 1) * U**(1 / alpha))."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=torch.float64)
    todo = torch.arange(n)
    while len(todo):
        x = torch.randn(len(todo), generator=gen, dtype=torch.float64)
        u = torch.rand(len(todo), generator=gen, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if alpha < 1.0:
        u = torch.rand(n, generator=gen, dtype=torch.float64)
        out = out * u ** (1.0 / alpha)
    return out
