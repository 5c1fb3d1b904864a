"""The dry run on the card machine's torch (2.11), guarded on this CPU's.

The card machine has torch 2.11.0+cu128. Its DTensor has no sharding
rule for some ops the port's steps meet (``flip``, ``index_add``,
autograd's ``detach_``), refuses to flatten dims of which a non-leading
one is sharded, makes an unnormalized ``Shard(-1)`` for an accumulating
``index_put``, a ``_MaskPartial`` it cannot reduce over meta shards for a
gather from a sharded dim, and reads a strided shard as an order of mesh
dims in its redistribution planner (``tools/dryrun_probe.py`` lists each
refusal by op, its placements and frames). ``launch/dryrun.py`` places
those ops itself, on every torch (``PartitionerPlacements``), so both
torches trace the same per-rank program. The tests below hold that:

* every op that the small-mesh dry runs (``tools/dryrun_small.py``) bring
  to DTensor's sharding propagator on this CPU's torch is one that 2.11
  has a rule for, or traced without one there
  (``tests/dtensor_ops_2_11.json``, from the probe on the card machine);
  this does not cover 2.11's planner, which ``chip_smoke.py`` phase 12
  exercises on the card;
* each own placement, one op at a time on a (4, 2) fake mesh;
* K5 over heads that ``model`` divides and kv heads it does not, K5 on
  padded head shards where it divides neither, ``silu_backward`` placed by
  the dry run, and the lm head over chunks of a vocab sharded on
  ``model``.
"""
import dataclasses
import json
import os
import sys

import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import dryrun_small as DS  # noqa: E402

with open(os.path.join(REPO, "tests", "dtensor_ops_2_11.json")) as f:
    CARD_OPS = json.load(f)


@pytest.mark.parametrize("case", [pytest.param(c, id=c["id"])
                                  for c in DS.CASES])
def test_small_mesh_ops_have_rules_on_the_card_torch(case):
    """Each small-mesh case traces ok on its mesh and on one rank, and
    every op that reached DTensor's sharding propagator is one that the
    card machine's torch (2.11.0+cu128) has a rule for or traced without
    one."""
    proc = DS.spawn(case["id"], "cpu", ops=True)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    for name in ("mesh", "one"):
        assert res[name]["status"] == "ok", res[name].get("error")
    allowed = set(CARD_OPS["ops_with_rules"]) \
        | set(CARD_OPS["traced_without_rule"])
    assert res["ops"], "no op reached the propagator"
    assert sorted(set(res["ops"]) - allowed) == []


@pytest.fixture
def mesh():
    with D.fake_world(8):
        yield make_local_mesh(4, 2, device_type="cpu")


def _traced(mesh, fn, *args):
    """``fn(*args)`` under the dry run's modes; (its result, the stats)."""
    out = []
    st = D.trace(lambda *a: out.append(fn(*a)), args, mesh)
    return out[0], st


def _dt(mesh, shape, placements, dtype=torch.float32):
    return D.meta_dtensor(shape, dtype, mesh, placements)


def test_merged_view_makes_a_plain_strided_shard(mesh):
    """(batch, heads) merged with the batch on ``data`` and the heads on
    ``model``: the local view, a strided shard of the merged dim (split
    factor: the rank's 2 sequences), as torch 2.13's view rule makes it;
    no collective. Its spec reads the strided shard as a shard, not as an
    order of mesh dims (2.11's planner refused one it could not read so),
    and it redistributes."""
    from torch.distributed.tensor.placement_types import _StridedShard
    x = _dt(mesh, (8, 2, 16, 32), (Shard(0), Shard(1)))
    y, st = _traced(mesh, lambda x: x.view(16, 16, 32), x)
    assert y.shape == (16, 16, 32)
    assert y.placements == (Shard(0), _StridedShard(0, split_factor=2))
    assert y._local_tensor.shape == (2, 16, 32)
    assert st.n_collectives == 0
    assert getattr(y._spec, "use_strided_shard_as_shard_order",
                   False) is False
    z = D._moved(y, [Replicate(), Replicate()])
    assert z._local_tensor.shape == (16, 16, 32)


@pytest.mark.parametrize("dim,collectives", [(1, 0), (2, 1)])
def test_flip_and_pad_keep_the_shards_of_other_dims(mesh, dim, collectives):
    """``flip`` and ``constant_pad_nd`` along a dim no mesh dim splits run
    on each rank's shard with the input's placements; along a sharded dim
    that dim is gathered first."""
    x = _dt(mesh, (8, 16, 32), (Shard(0), Shard(2)))
    pad = [0, 0, 3, 0] if dim == 1 else [2, 1]

    def step(x):
        return x.flip(dim), torch.nn.functional.pad(x, pad)
    (f, p), st = _traced(mesh, step, x)
    assert f.shape == (8, 16, 32)
    want = (8, 19, 32) if dim == 1 else (8, 16, 35)
    assert p.shape == want
    kept = (Shard(0), Shard(2)) if dim == 1 else (Shard(0), Replicate())
    assert f.placements == p.placements == kept
    assert p._local_tensor.shape == tuple(
        n // m for n, m in zip(want, (4, 1, 2 if dim == 1 else 1)))
    assert st.n_collectives == 2 * collectives


@pytest.mark.parametrize("rows,partial", [(8, True), (64, False)])
def test_index_add_adds_each_ranks_rows(mesh, rows, partial):
    """MoE's counts and dispatch: ``zeros.index_add(0, ids, src)`` with the
    ids and 64 rows of ``src`` on ``data``. Float rows into 8 rows of
    zeros: each rank adds its own rows and the result is partial over
    ``data``, as XLA scatters (its later reduction moves fewer bytes than
    gathering the rows); into 64 rows the rows are gathered instead; a
    ``src`` sharded by columns over ``model`` keeps that shard. Integer
    counts gather their ids (the counts come out replicated), as torch
    2.13 places them."""
    ids = _dt(mesh, (64,), (Shard(0), Replicate()), torch.int64)
    src = _dt(mesh, (64, 64), (Shard(0), Shard(1)))

    def step(ids, src):
        counts = torch.zeros(8, dtype=torch.int64, device="meta").index_add(
            0, ids, torch.ones_like(ids))
        out = torch.zeros(rows, 64, device="meta").index_add(0, ids, src)
        return counts, out
    (counts, out), st = _traced(mesh, step, ids, src)
    assert counts.placements == (Replicate(), Replicate())
    assert out.shape == (rows, 64)
    assert out.placements == ((Partial() if partial else Replicate()),
                              Shard(1))
    assert out._local_tensor.shape == (rows, 32)
    # the counts' ids and ones gathered, and the rows' ids and rows where
    # they are gathered
    assert st.n_collectives == (2 if partial else 4)


def test_lookup_gradient_is_a_partial_table(mesh):
    """The gradient of a lookup, ``zeros(table).index_put_([ids], rows,
    accumulate=True)``: each rank adds its own rows into a table-sized
    partial sum over ``data`` (the ids' shard), the table's columns
    sharded where the rows are (``model``), as XLA scatters; torch 2.11
    made an unnormalized ``Shard(-1)`` here."""
    ids = _dt(mesh, (8, 16), (Shard(0), Replicate()), torch.int64)
    rows = _dt(mesh, (8, 16, 64), (Shard(0), Shard(2)))

    def step(ids, rows):
        z = rows.new_zeros((512, 64))
        return torch.ops.aten.index_put.default(z, [ids], rows, True)
    g, st = _traced(mesh, step, ids, rows)
    assert g.shape == (512, 64)
    assert g.placements == (Partial(), Shard(1))
    assert g._local_tensor.shape == (512, 32)
    assert st.n_collectives == 0


def test_scatter_and_column_index_put_as_torch_2_13_places_them(mesh):
    """The two ops where a MoE train step's placements parted between the
    torches: a top-k's backward, ``zeros.scatter(1, index, grad)``, runs on
    each rank's rows, placed as the gradient (2.11 made its zeros plain
    and came out replicated); the gradient of a token lookup,
    ``zeros(x).index_put([ids], rows, accumulate=True)`` with x's columns
    on ``data``, gathers the rows over ``model`` and adds each rank's
    columns (2.11 sharded the result's rows over ``model``)."""
    grad = _dt(mesh, (128, 4), (Shard(0), Shard(0)))
    index = _dt(mesh, (128, 4), (Shard(0), Replicate()), torch.int64)
    rows = _dt(mesh, (256, 256), (Shard(1), Shard(0)))
    ids = _dt(mesh, (256,), (Replicate(), Replicate()), torch.int64)
    seen = set()

    def step(grad, index, rows, ids):
        z = torch.zeros(128, 4, device="meta").scatter(1, index, grad)
        g = torch.ops.aten.index_put.default(rows.new_zeros((128, 256)),
                                             [ids], rows, True)
        return z, g
    with DS.record_ops(seen):
        (z, g), st = _traced(mesh, step, grad, index, rows, ids)
    assert {"aten.scatter.src", "aten.index_put.default"}.isdisjoint(seen)
    assert z.shape == (128, 4) and z.placements == (Shard(0), Shard(0))
    assert z._local_tensor.shape == (16, 4)
    assert g.shape == (128, 256) and g.placements == (Shard(1), Replicate())
    assert g._local_tensor.shape == (128, 64)
    # the rows gathered over model, nothing else moved
    assert st.n_collectives == 1
    assert list(st.collective_bytes) == ["all-gather"]


def test_gold_logit_gather_is_partial_over_the_vocab(mesh):
    """The cross-entropy's gold logits, ``logits.gather(-1, labels)`` with
    the vocab on ``model``: each rank gathers the labels in its columns,
    the result partial over ``model`` (torch 2.11's ``_MaskPartial``
    could not be reduced over meta shards); a partial sum over ``data``
    stays partial, its labels gathered there."""
    labels = _dt(mesh, (8, 16, 1), (Shard(0), Replicate()), torch.int64)
    for data, want, moved in ((Shard(0), Shard(0), {}),
                              (Partial(), Partial(), {"all-gather"})):
        logits = _dt(mesh, (8, 16, 512), (data, Shard(2)))
        g, st = _traced(mesh, lambda x, i: x.gather(-1, i), logits, labels)
        assert g.shape == (8, 16, 1)
        assert g.placements == (want, Partial())
        # over a partial batch, the labels are gathered
        assert set(st.collective_bytes) == set(moved)


def test_partial_plus_shard_reduce_scatters_the_partial(mesh):
    """A partial projection plus a bias sharded by heads over ``model``:
    the partial one is reduce-scattered to the heads' shard (torch 2.11's
    planner would move the bias to a partial sum, which it cannot)."""
    q = _dt(mesh, (8, 64, 2, 32), (Shard(0), Partial()))
    b = _dt(mesh, (2, 32), (Replicate(), Shard(0)))
    y, st = _traced(mesh, lambda q, b: q + b, q, b)
    assert y.placements == (Shard(0), Shard(2))
    assert st.n_collectives == 1
    assert list(st.collective_bytes) == ["reduce-scatter"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_k5_runs_on_each_ranks_heads_where_kv_heads_do_not_divide(kind):
    """The smoke mixtral (8 heads, 2 kv heads) with ``attn_impl="flash"``
    on a (2, 4) mesh, two sequences (so ``model`` cannot take the batch):
    ``model`` divides the query heads and not the kv heads. Each rank
    repeats its heads' kv groups and runs K5 on 2 of the 8 heads: its K5
    FLOPs and matmul FLOPs are 1 to 1.2 times its eighth of the one-rank
    trace's (DTensor gathered the heads, and each rank ran K5 on all of
    them: 4.0 times)."""
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              attn_impl="flash")
    shape = InputShape("t", 128, 2, kind)
    one = D.run_one("mixtral-8x22b", shape, "local", cfg=cfg,
                    mesh_shape=(1, 1), device="cpu")
    rec = D.run_one("mixtral-8x22b", shape, "local", cfg=cfg,
                    mesh_shape=(2, 4), device="cpu")
    assert one["status"] == "ok", one.get("error")
    assert rec["status"] == "ok", rec.get("error")
    name = "repro_torch::swa_attention"
    assert rec["op_kernel_calls"][name] == one["op_kernel_calls"][name] > 0
    share = one["op_kernel_flops_per_dev"][name] / 8
    assert share <= rec["op_kernel_flops_per_dev"][name] <= 1.2 * share
    share = one["op_matmul_flops_per_dev"] / 8
    assert share <= rec["op_matmul_flops_per_dev"] <= 1.2 * share


@pytest.mark.parametrize("arch,vocab", [("qwen3-14b", 512),
                                        ("mamba2-1.3b", 4097)])
def test_lm_head_chunks_move_nothing_more(monkeypatch, arch, vocab):
    """A decode step's lm head over chunks of the vocab
    (``models.model.LOGITS_CHUNK``, 128 columns here) on (4, 2): with the
    vocab on ``model`` (qwen3's 512) each rank takes its chunks of its
    own rows, so the matmul FLOPs equal the one product's and no more
    than 1% more bytes move; with a vocab ``model`` does not divide
    (4097, whole on each rank) the casts of one chunk are live at a time,
    so the peak is no higher."""
    cfg = dataclasses.replace(get_smoke_config(arch), vocab=vocab)
    shape = InputShape("t", 128, 8, "decode")

    def run():
        return D.run_one(arch, shape, "local", cfg=cfg, mesh_shape=(4, 2),
                         device="cpu")
    whole = run()
    monkeypatch.setattr(M, "LOGITS_CHUNK", 128)
    chunked = run()
    assert whole["status"] == chunked["status"] == "ok", chunked.get("error")
    assert chunked["op_matmul_flops_per_dev"] == \
        whole["op_matmul_flops_per_dev"]
    assert chunked["collective_link_bytes_per_dev"] <= \
        1.01 * whole["collective_link_bytes_per_dev"]
    assert chunked["mem_peak_bytes_per_dev"] <= \
        whole["mem_peak_bytes_per_dev"]


@pytest.mark.parametrize("h,kh,m", [(10, 2, 4), (6, 6, 4), (40, 8, 16),
                                    (12, 12, 16)])
def test_k5_runs_on_padded_head_shards(h, kh, m):
    """K5 where ``model`` (m ranks) divides neither head count: q, partial
    over ``model`` as a projection leaves it, is padded to m · ceil(h / m)
    heads and reduce-scattered to them, each rank runs K5 on its ceil(h /
    m) heads with its kv groups repeated out to them (K5's FLOPs ceil(h /
    m) / (h / m) times a rank's share, as XLA pads the heads: 1.200 for
    qwen3-14b's 40 heads on 16 ranks, 1.333 for whisper-small's 12), and
    the output moves to q's sequence shard with the padding cut off."""
    from repro_torch.kernels import swa_attention as K5
    b, l, hd = 4, 128, 32
    with D.fake_world(2 * m):
        mesh = make_local_mesh(2, m, device_type="cpu")
        q = _dt(mesh, (b, l, h, hd), (Shard(0), Partial()))
        k = _dt(mesh, (b, l, kh, hd), (Shard(0), Partial()))
        v = _dt(mesh, (b, l, kh, hd), (Shard(0), Partial()))
        out, st = _traced(mesh, lambda q, k, v: K5.swa_attention(
            q, k, v, 0, True), q, k, v)
    mine = -(-h // m)
    assert out.shape == (b, l, h, hd)
    assert out.placements == (Shard(0), Shard(1))
    assert out._local_tensor.shape == (b // 2, l // m, h, hd)
    name = "repro_torch::swa_attention"
    assert st.kernel_calls == {name: 1}
    # the rank's K5 ran on (b / 2, l, ceil(h / m), hd)
    local = torch.empty(b // 2, l, mine, hd, device="meta")
    assert st.kernel_flops[name] == K5.band_flops(local, None, 0, True)
    whole = torch.empty(b, l, h, hd, device="meta")
    share = K5.band_flops(whole, None, 0, True) / (2 * m)
    assert st.kernel_flops[name] / share == pytest.approx(mine / (h / m),
                                                          rel=1e-12)


@pytest.mark.parametrize("partial", [True, False])
def test_silu_backward_is_placed_by_the_dry_run(mesh, partial):
    """``silu_backward`` of a gradient and an input sharded on other dims
    over ``model`` (a MoE's or an MLP's gate activation): the dry run
    places it as torch 2.13 does and computes it on each rank's shards;
    the op never reaches DTensor's sharding propagator, whose choice
    parted between torches (2.11 moved the input where 2.13 moved the
    gradient). Partial over ``data``, both are reduce-scattered and the
    gradient moves to the input's shards; else the input moves to the
    gradient's."""
    first = Partial() if partial else Shard(1)
    g = _dt(mesh, (4, 128, 512), (first, Shard(0)))
    x = _dt(mesh, (4, 128, 512), (Partial() if partial else Shard(1),
                                  Shard(2)))
    seen = set()
    with DS.record_ops(seen):
        y, st = _traced(mesh, lambda g, x: torch.ops.aten.silu_backward(g, x),
                        g, x)
    assert "aten.silu_backward.default" not in seen
    assert y.shape == (4, 128, 512)
    if partial:
        # a reduce-scatter of each over data, the gradient's two shards
        # moved
        assert y.placements == (Shard(0), Shard(2))
        assert y._local_tensor.shape == (1, 128, 256)
        assert st.n_collectives == 4
        assert set(st.collective_bytes) == {"reduce-scatter", "all-to-all"}
    else:
        assert y.placements == (Shard(1), Shard(0))
        assert y._local_tensor.shape == (2, 32, 512)
        assert st.n_collectives == 1
        assert set(st.collective_bytes) == {"all-to-all"}
