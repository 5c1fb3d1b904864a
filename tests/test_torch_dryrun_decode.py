"""The dry run's one-sequence decode against XLA's partitioning, one op at
a time, on a (4, 2) (data, model) fake mesh, in seconds.

With one sequence (``long_500k``) the ``data`` mesh dim cannot split the
batch, so ``sharding/partition.py`` shards the cache's sequence over
``data``. XLA's partitioner (the JAX package's compiled program) then
keeps every weight on its ``data`` shard, contracts the one token against
each shard and all-reduces the small partial activations; it reduces
attention's softmax over the key shards as ``(..., 1)`` statistics; and it
looks up a token's row on the rank that holds it. DTensor, placing op by
op, gathered every weight over ``data`` before each product (each ``data``
rank repeating the whole product), gathered the scores whole over their
keys, and moved the whole embedding table's shard with an all-to-all
before the lookup: a smoke qwen3 decode of one sequence on (4, 2) moved
72x the reference's link bytes at 2x a rank's share of the matmul FLOPs.
The tests below hold each repaired op alone; ``test_small_mesh_dry_run``
holds the whole steps against the reference.
"""
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.mesh import make_local_mesh


class _Kept(OA.OpAnalyzer):
    """The analyzer, also keeping itself (its collectives) and the largest
    storage it counted."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.largest = 0
        _Kept.last = self

    def _add(self, t, own=False):
        super()._add(t, own)
        self.largest = max(self.largest,
                           self._live[id(t.untyped_storage())][1])


def _collectives():
    return sorted((c.kind, c.mesh_dims, c.bytes_out)
                  for c in _Kept.last.collectives)


@pytest.fixture
def mesh(monkeypatch):
    monkeypatch.setattr(D, "OpAnalyzer", _Kept)
    with D.fake_world(8):
        yield make_local_mesh(4, 2, device_type="cpu")


@pytest.mark.parametrize("batch", [1, 8])
def test_product_keeps_weight_shard_where_data_cannot_split_batch(
        mesh, batch):
    """``x @ w`` for a weight stored (d over ``data``, f over ``model``).
    One sequence, replicated over ``data``: the weight keeps its ``data``
    shard, each rank contracts its slice of d (a quarter of the product),
    and the partial output is all-reduced over ``data``: no weight moves.
    Eight sequences sharded over ``data``: the weight is gathered over
    ``data`` (FSDP), as before, and nothing is reduced."""
    d, f = 256, 512
    x_pl = (Replicate(), Replicate()) if batch == 1 else \
        (Shard(0), Replicate())
    x = D.meta_dtensor((batch, 1, d), torch.float32, mesh, x_pl)
    w = D.meta_dtensor((d, f), torch.float32, mesh, (Shard(0), Shard(1)))
    out = []

    def step(x, w):
        out.append(torch.einsum("bsd,df->bsf", x, w))
    st = D.trace(step, (x, w), mesh, [w], (0,))
    y = out[0]
    assert y.shape == (batch, 1, f)
    assert not any(p.is_partial() for p in y.placements)
    if batch == 1:
        assert _collectives() == [("all-reduce", ("data",), f // 2 * 4)]
        assert st.matmul_flops == 2 * d * f / 8
    else:
        assert _collectives() == [("all-gather", ("data",), d * f // 2 * 4)]
        assert st.matmul_flops == 2 * batch // 4 * d * f / 2


def test_linear_keeps_weight_shard_for_one_sequence(mesh):
    """The same rule through ``matmul`` (mamba2's ``x @ in_proj``): a
    replicated row keeps the weight on its ``data`` shard."""
    d, f = 256, 1104
    x = D.meta_dtensor((1, d), torch.float32, mesh, (Replicate(),) * 2)
    w = D.meta_dtensor((d, f), torch.float32, mesh, (Shard(0), Shard(1)))
    D.trace(lambda x, w: x @ w, (x, w), mesh, [w], (0,))
    assert _collectives() == [("all-reduce", ("data",), f // 2 * 4)]


def test_lookup_of_a_row_sharded_table_moves_rows_not_the_table(mesh):
    """A decode step's token lookup in a table with its vocab over
    ``model`` and d_model over ``data``: each rank looks up the rows it
    holds, the rows come out partial over ``model`` and sharded over
    ``data``, and only rows move. DTensor moved the whole table's shard
    to a column shard with an all-to-all first (65,536 B a rank for this
    table)."""
    v, d = 512, 256
    table = D.meta_dtensor((v, d), torch.float32, mesh,
                           (Shard(1), Shard(0)))
    tokens = D.meta_dtensor((1, 1), torch.int64, mesh, (Replicate(),) * 2)
    out = []

    def step(table, tokens):
        out.append(table[tokens])
    D.trace(step, (table, tokens), mesh, [table], (0,), [table])
    rows = out[0]
    assert rows.shape == (1, 1, d)
    assert list(rows.placements) == [Replicate(), Replicate()]
    got = _collectives()
    assert not [c for c in got if c[0] == "all-to-all"]
    assert sum(n for _, _, n in got) <= 2 * d * 4
    assert got == [("all-gather", ("data",), d * 4),
                   ("all-reduce", ("model",), d // 4 * 4)]


def test_softmax_over_key_shards_reduces_only_statistics(mesh):
    """Softmax over scores (batch, kv heads, group, query, keys) whose keys
    lie on ``data`` (a one-sequence cache's sequence) and kv heads on
    ``model``: the output keeps the scores' shards, and the only traffic
    is the max and the sum, (..., 1) floats, all-reduced over ``data``.
    DTensor gathered the scores whole over the keys."""
    shape = (1, 2, 4, 1, 2048)
    s = D.meta_dtensor(shape, torch.float32, mesh, (Shard(4), Shard(1)))
    out = []

    def step(s):
        out.append(torch.softmax(s, dim=-1))
    D.trace(step, (s,), mesh)
    w = out[0]
    assert w.shape == shape and list(w.placements) == [Shard(4), Shard(1)]
    stat = 1 * 1 * 4 * 1 * 1 * 4                  # a rank's (..., 1) floats
    assert _collectives() == [("all-reduce", ("data",), stat)] * 2
    shard = 1 * 1 * 4 * 1 * 2048 // 4 * 4
    assert _Kept.last.largest == shard


@pytest.mark.parametrize("grad_pl", ["same", "by-query"])
def test_softmax_backward_over_key_shards_keeps_them(mesh, grad_pl):
    """Softmax's backward where the forward's output is sharded by key on
    ``data``: the backward runs on those shards (a gradient placed
    otherwise moved there first), and the sum of grad·out is a (..., 1)
    statistic all-reduced over ``data``. No storage is larger than a
    rank's shard of the scores."""
    shape = (2, 2, 4, 64, 256)
    pl = (Shard(4), Shard(1))
    s = D.meta_dtensor(shape, torch.float32, mesh, pl)
    dw = D.meta_dtensor(shape, torch.float32, mesh,
                        pl if grad_pl == "same" else (Shard(3), Shard(1)))
    grads = []

    def step(s, dw):
        leaf = s.detach().requires_grad_()
        with torch.enable_grad():
            w = torch.softmax(leaf, dim=-1)
            grads.extend(torch.autograd.grad(w, [leaf], grad_outputs=dw))
    D.trace(step, (s, dw), mesh)
    assert list(grads[0].placements) == list(pl)
    stat = 2 * 1 * 4 * 64 * 1 * 4
    got = [c for c in _collectives() if c[0] == "all-reduce"]
    # the forward's max and sum, the backward's sum of grad·out
    assert got == [("all-reduce", ("data",), stat)] * 3
    shard = 2 * 1 * 4 * 64 * 256 // 4 * 4
    assert _Kept.last.largest == shard


def test_slices_of_a_sharded_dim_share_one_gather(mesh):
    """mamba2's one-token ``in_proj`` output, its columns over ``model``,
    sliced into z, xbc and dt: one all-gather for the three slices, where
    DTensor gathered the whole row once a slice."""
    proj = D.meta_dtensor((1, 1104), torch.float32, mesh,
                          (Replicate(), Shard(1)))
    out = []

    def step(p):
        out.extend([p[..., :512], p[..., 512:1088], p[..., -16:]])
    D.trace(step, (proj,), mesh)
    assert [t.shape[-1] for t in out] == [512, 576, 16]
    assert _collectives() == [("all-gather", ("model",), 1104 * 4)]


def test_decode_scores_split_by_key_over_model(mesh):
    """A decode step's scores (b·k, g, hd) @ (b·k, hd, s), both replicated
    over ``model`` (kv heads that ``model`` does not divide) and with fewer
    rows (g) than ``model`` has ranks: the product is split by key, each
    rank scoring its keys against the whole query, with no collective.
    Split along hd, as before, the partial scores were reduced whole over
    ``model`` (60% of jamba's ``long_500k`` link bytes)."""
    q = D.meta_dtensor((8, 1, 32), torch.float32, mesh, (Replicate(),) * 2)
    k = D.meta_dtensor((8, 32, 2048), torch.float32, mesh,
                       (Shard(2), Replicate()))
    out = []
    st = D.trace(lambda q, k: out.append(torch.bmm(q, k)), (q, k), mesh)
    assert list(out[0].placements) == [Shard(2), Shard(2)]
    assert _collectives() == []
    assert st.matmul_flops == 2 * 8 * 1 * 2048 * 32 / 8


def test_selections_along_a_sharded_dim_share_one_gather(mesh):
    """SSD's inter-chunk loop reads ``states[:, z]`` chunk by chunk; with a
    sequence sharded over ``model`` the chunks lie on it. One all-gather
    serves every chunk, where DTensor gathered the whole states once a
    chunk (128 x 1 GiB a layer of jamba's ``prefill_32k``)."""
    states = D.meta_dtensor((4, 8, 4, 16), torch.float32, mesh,
                            (Shard(0), Shard(1)))
    out = []
    D.trace(lambda s: out.extend(s[:, z] for z in range(8)), (states,), mesh)
    assert [tuple(t.shape) for t in out] == [(4, 4, 16)] * 8
    # a rank's sequence (4 / 4 data ranks) of all 8 chunks
    assert _collectives() == [("all-gather", ("model",), 1 * 8 * 4 * 16 * 4)]
