"""The multi-pod dry run's peak against the JAX package's, on the CPU, and
``tools/dryrun_compare.py``'s account of a partial rerun.

On the (pod, data, model) mesh a ``remat`` layer's backward pass runs its
forward again (``torch.utils.checkpoint``), and the autograd engine runs
that recomputation without the caller's torch-function modes: the dry
run's ``FsdpGather`` did not gather the weights there, DTensor contracted
the recomputed products over their ``data`` shards, and the partial sums
were reduced whole. qwen2-72b's ``train_4k`` on the production (2, 16, 16)
mesh then held the whole batch's attention probabilities in float32, a
(256, 8, 8, 4096, 4096) gradient of ``softmax(scores).to(q.dtype)``, and a
clone of half of it, 1,578.88 GiB a rank against the reference's 222.1
(``launch.dryrun.remat_under`` now enters the modes in the recomputation).
What flipped DTensor's choice is the ``data`` dim's size: on (2, 2, 16)
with the same 8 sequences a rank it gathered the weight (2 ranks) and
kept the batch's shards. The tests below hold the causes of the
multi-pod peak one op at a time, in seconds (``tools/dryrun_peak.py``
prints what a whole step holds at its peak): the recomputation's weight
gather; softmax's backward on the forward's shards (by query over
``model``, where DTensor gathered every query's scores); the products
over strided shards that a view merging a sharded minor dim makes (the
q-gradient of the scores, a batch of merged heads or chunks) and the
view back; a head view that 16 does not divide; the cross-entropy over
a sharded vocab; and queries sharded by sequence meeting keys sharded
otherwise. With them a smoke train step on (2, 2, 2) traces in ~30 s
(over 15 minutes before), and ``test_small_mesh_dry_run`` holds it
whole.
"""
import json
import math
import os
import sys
import time
import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import dryrun_compare as DC  # noqa: E402


def _write(d, arch, shape, mesh, **rec):
    d.mkdir(parents=True, exist_ok=True)
    f = d / f"{arch}__{shape}__{mesh}.json"
    f.write_text(json.dumps(dict(arch=arch, shape=shape, mesh=mesh, **rec)))
    return f


def test_compare_lists_cases_not_rerun(tmp_path, capsys):
    """The reference's cases the port has no record of, and the port records
    older than the --before sweep's record of the same case, are listed by
    name: a partial rerun does not read as complete."""
    ok = dict(status="ok", op_flops_per_dev=2.0, mem_peak_bytes_per_dev=2.0,
              collective_link_bytes_per_dev=2.0)
    ref = dict(status="ok", hlo_flops_per_dev=2.0,
               mem_argument_bytes_per_dev=1.0, mem_temp_bytes_per_dev=1.0,
               mem_output_bytes_per_dev=0.0, mem_alias_bytes_per_dev=0.0,
               collective_link_bytes_per_dev=2.0)
    for arch in ("a", "b", "c"):
        _write(tmp_path / "ref", arch, "train_4k", "multi", **ref)
    stale = _write(tmp_path / "port", "a", "train_4k", "multi", **ok)
    os.utime(stale, (time.time() - 3600,) * 2)
    _write(tmp_path / "before", "a", "train_4k", "multi", **ok)
    _write(tmp_path / "before", "b", "train_4k", "multi", **ok)
    _write(tmp_path / "port", "b", "train_4k", "multi", **ok)
    port, refs = DC.load(tmp_path / "port"), DC.load(tmp_path / "ref")
    before = DC.load(tmp_path / "before")
    missing, old = DC.not_rerun(port, refs, before)
    assert missing == [("c", "train_4k", "multi")]
    assert old == [("a", "train_4k", "multi")]
    assert DC.main(["--port", str(tmp_path / "port"), "--ref",
                    str(tmp_path / "ref"), "--before",
                    str(tmp_path / "before")]) == 0
    out = capsys.readouterr().out
    assert "reference cases without a port record: 1\n  c x train_4k x " \
        "multi" in out
    assert "port records older than the --before sweep's: 1\n  a x " \
        "train_4k x multi" in out


@pytest.mark.parametrize("remat,gathers", [("full", 2), ("none", 1)])
def test_recomputation_gathers_weights_as_the_forward(remat, gathers):
    """A ``remat`` product on a (2, 2, 2) (pod, data, model) mesh: its
    weight, sharded over ``data`` as FSDP storage, is gathered for the
    forward and, where the layer is rematerialised, again for the
    recomputation in the backward pass; the cast weight's gathered bytes
    appear once per product (``remat_under``). Before, the recomputation
    ran without ``FsdpGather`` (the autograd engine drops the caller's
    torch-function modes) and DTensor moved the activations instead: one
    gather of the weight and one of the activations."""
    b, s, d, f = 16, 8, 1024, 1024
    with D.fake_world(8):
        mesh = make_local_mesh(2, 2, pod=2, device_type="cpu")
        x = D.meta_dtensor((b, s, d), torch.bfloat16, mesh,
                           (Shard(0), Shard(0), Replicate()))
        w = D.meta_dtensor((d, f), torch.float32, mesh,
                           (Replicate(), Shard(0), Shard(1)))
        cfg = types.SimpleNamespace(remat=remat)

        def step(x, w):
            leaf = w.detach().requires_grad_()
            with torch.enable_grad():
                y = M._remat(lambda x, w: torch.relu(torch.einsum(
                    "bsd,df->bsf", x, w.to(x.dtype))), cfg)(x, leaf)
                dy = D.meta_dtensor(y.shape, y.dtype, mesh, y.placements)
                return torch.autograd.grad(y, [leaf], grad_outputs=dy)
        st = D.trace(step, (x, w), mesh, [w], (1,))
    # the weight cast to bfloat16 and gathered over data: (d, f / 2)
    assert st.collective_bytes["all-gather"] == gathers * d * f // 2 * 2


class _Largest(OA.OpAnalyzer):
    """The analyzer, also keeping the largest storage it counted."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.largest = 0
        _Largest.last = self

    def _add(self, t, own=False):
        super()._add(t, own)
        self.largest = max(self.largest,
                           self._live[id(t.untyped_storage())][1])


@pytest.mark.parametrize("grad_dim", [2, 3])
def test_softmax_backward_keeps_the_forward_shards(monkeypatch, grad_dim):
    """Softmax over keys of scores sharded by query over ``model`` (as the
    attention's forward leaves them), its gradient sharded by query or by
    key: the backward runs on the query shards, and no storage is larger
    than one rank's shard of the scores. Before, a key-sharded gradient
    made DTensor gather both operands (every query's scores whole on each
    rank: 4.4 copies in a full-width qwen2-72b layer on (2, 2, 16))."""
    monkeypatch.setattr(D, "OpAnalyzer", _Largest)
    shape = (8, 4, 64, 64)                       # batch, heads, q, k
    with D.fake_world(8):
        mesh = make_local_mesh(2, 2, pod=2, device_type="cpu")
        s = D.meta_dtensor(shape, torch.float32, mesh,
                           (Shard(0), Shard(0), Shard(2)))
        dw = D.meta_dtensor(shape, torch.float32, mesh,
                            (Shard(0), Shard(0), Shard(grad_dim)))

        def step(s, dw):
            leaf = s.detach().requires_grad_()
            with torch.enable_grad():
                w = torch.softmax(leaf, dim=-1)
                return torch.autograd.grad(w, [leaf], grad_outputs=dw)
        D.trace(step, (s, dw), mesh)
    shard = 8 // 4 * 4 * 64 // 2 * 64 * 4
    assert _Largest.last.largest == shard


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 2, 2)])
def test_query_gradient_product_keeps_the_strided_query_shard(
        monkeypatch, mesh_shape):
    """The scores ``einsum("bqkgh,bskh->bkgqs", q, k)`` of one attention
    layer with its gradient sharded by query over ``model`` (as softmax's
    backward leaves it), batch over the other mesh dims: the products of
    q's and k's gradients merge (group, query) into one dim, on which the
    query shard becomes a strided shard. Both products run on the rank's
    shards: no storage is larger than a rank's partial scores of the
    forward, the only gather is k's, and each product does a rank's share
    of the FLOPs. Before, DTensor had no product rule for the strided
    shard and gathered the gradient whole over ``model`` for each (3 x
    8.59e9 B a rank in one full-width qwen2-72b layer on (2, 2, 16), 3.31x
    the reference's peak)."""
    monkeypatch.setattr(D, "OpAnalyzer", _Largest)
    b, q, k, g, h = 4, 64, 2, 2, 16
    with D.fake_world(math.prod(mesh_shape)):
        mesh = make_local_mesh(*mesh_shape[-2:], pod=(
            mesh_shape[0] if len(mesh_shape) == 3 else 0), device_type="cpu")
        batch = (Shard(0),) * (len(mesh_shape) - 1)
        qg = D.meta_dtensor((b, q, k, g, h), torch.float32, mesh,
                            batch + (Replicate(),))
        kk = D.meta_dtensor((b, q, k, h), torch.float32, mesh,
                            batch + (Shard(3),))
        ds = D.meta_dtensor((b, k, g, q, q), torch.float32, mesh,
                            batch + (Shard(3),))
        grads = []

        def step(qg, kk, ds):
            leaves = [t.detach().requires_grad_() for t in (qg, kk)]
            with torch.enable_grad():
                s = torch.einsum("bqkgh,bskh->bkgqs", *leaves)
                grads.extend(torch.autograd.grad(s, leaves, grad_outputs=ds))
        st = D.trace(step, (qg, kk, ds), mesh)
    assert [tuple(t.shape) for t in grads] == [(b, q, k, g, h), (b, q, k, h)]
    n = math.prod(mesh_shape)
    rows = b // (n // 2)                          # a rank's sequences
    assert _Largest.last.largest == rows * k * g * q * q * 4
    assert st.collective_bytes == {"all-gather": rows * k * q * h * 4}
    one = 2 * b * k * g * q * q * h               # one product, one rank
    assert st.matmul_flops == 3 * one / n


def test_uneven_head_view_moves_the_shard_to_the_sequence(monkeypatch):
    """Queries (b, s, 12 heads, hd), their heads over 4 ``model`` ranks,
    viewed as (kv heads 6, group 2), which 4 does not divide: the ``model``
    shard moves to the sequence (an all-to-all of a rank's queries) and
    the view keeps a rank's share, so the attention after it runs on
    query shards. Before, the heads were gathered whole on each rank (the
    scores of every query then partial over ``model``: 2.1e10 B a rank in
    one full-width qwen2-72b layer on (2, 2, 16), 2.4x the reference's
    peak)."""
    monkeypatch.setattr(D, "OpAnalyzer", _Largest)
    b, s, h, kh, hd = 2, 64, 12, 6, 16
    out = []
    with D.fake_world(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        q = D.meta_dtensor((b, s, h, hd), torch.float32, mesh,
                           (Shard(0), Shard(2)))
        st = D.trace(lambda q: out.append(q.reshape(b, s, kh, h // kh, hd)),
                     (q,), mesh)
    assert out[0].shape == (b, s, kh, h // kh, hd)
    assert list(out[0].placements) == [Shard(0), Shard(1)]
    share = b // 2 * s * h * hd * 4 // 4
    assert st.collective_bytes == {"all-to-all": share}
    assert _Largest.last.largest == share


def test_cross_entropy_over_a_sharded_vocab_keeps_the_shards(monkeypatch):
    """A train step's cross-entropy on logits (b, s, V) with the vocab
    over ``model``: ``logsumexp`` reduces (b, s, 1) statistics over the
    vocab's shards, and the gradient of the gold logit's ``gather`` (zeros
    of the logits' shape, then ``scatter_add``) keeps the vocab's shards,
    each rank adding the labels in its columns. No storage is larger than
    a rank's shard of the logits. Before, DTensor gathered the logits whole
    over the vocab for ``logsumexp`` and made the gradient's zeros whole
    (5 x 4.98e9 B a rank in one full-width qwen2-72b layer on (2, 2,
    16))."""
    from repro_torch.train.steps import cross_entropy
    monkeypatch.setattr(D, "OpAnalyzer", _Largest)
    b, s, v = 4, 32, 1024
    grads = []
    with D.fake_world(8):
        mesh = make_local_mesh(2, 2, pod=2, device_type="cpu")
        logits = D.meta_dtensor((b, s, v), torch.float32, mesh,
                                (Shard(0), Shard(0), Shard(2)))
        labels = D.meta_dtensor((b, s), torch.int64, mesh,
                                (Shard(0), Shard(0), Replicate()))

        def step(logits, labels):
            leaf = logits.detach().requires_grad_()
            with torch.enable_grad():
                loss = cross_entropy(leaf, labels)
                grads.extend(torch.autograd.grad(loss, [leaf]))
        st = D.trace(step, (logits, labels), mesh)
    assert list(grads[0].placements) == [Shard(0), Shard(0), Shard(2)]
    shard = b // 4 * s * v // 2 * 4
    assert _Largest.last.largest == shard
    assert "all-gather" not in st.collective_bytes


@pytest.mark.parametrize("k_dim", [1, 2])
def test_scores_of_sequence_sharded_queries_gather_the_keys(k_dim):
    """Attention's scores (b·h, q, hd) @ (b·h, hd, s) with the queries
    sharded by sequence over ``model`` and the keys by hd or by key (12
    heads, which 16 ranks do not divide, as in whisper): the keys are
    gathered and the scores keep the query shard, with no reduction.
    Before, DTensor moved both operands to a shard of hd and reduced
    partial scores (99% of whisper's ``prefill_32k`` link bytes on the
    multi-pod mesh, 5.03x the reference's), or to a shard of the batch
    where ``model`` divides it."""
    bh, q, hd, s = 8, 2048, 64, 2048
    with D.fake_world(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        a = D.meta_dtensor((bh, q, hd), torch.float32, mesh,
                           (Shard(0), Shard(1)))
        b = D.meta_dtensor((bh, hd, s), torch.float32, mesh,
                           (Shard(0), Shard(k_dim)))
        out = []
        st = D.trace(lambda a, b: out.append(torch.bmm(a, b)), (a, b), mesh)
    assert list(out[0].placements) == [Shard(0), Shard(1)]
    assert st.collective_bytes == {"all-gather": bh // 2 * hd * s * 4}
    assert st.matmul_flops == 2 * bh * q * s * hd / 8


@pytest.mark.parametrize("other", ["replicated", "by-row"])
def test_product_over_a_strided_batch_stays_on_its_shards(other):
    """Products that merge (batch, chunks, heads) or (batch, heads) into
    one batch dim with the heads sharded over ``model``: a strided shard
    of the batch. The product runs on each rank's batch, the other operand
    moved to it (a local slice where it is replicated over ``model``; a
    gather of it where it is sharded there by row), and the view back to
    (batch, ..., heads) keeps the heads' shard. Before, DTensor gathered
    the strided operand whole (12 x 4.3 GB a rank of jamba's
    ``prefill_32k``) and replicated the heads in the view back (the
    scores of one full-width phi-3 layer's train step on (2, 2, 16), 4.3e9
    B a rank)."""
    b, z, h, c, p = 2, 4, 8, 16, 4
    with D.fake_world(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        cb = D.meta_dtensor((b, z, h, c, c), torch.float32, mesh,
                            (Shard(0), Shard(2)))
        x = D.meta_dtensor((b * z * h, c, p), torch.float32, mesh, (
            Shard(0), Replicate() if other == "replicated" else Shard(1)))
        out = []
        st = D.trace(lambda cb, x: out.append(torch.bmm(
            cb.reshape(b * z * h, c, c), x).view(b, z, h, c, p)),
            (cb, x), mesh)
    assert out[0].shape == (b, z, h, c, p)
    assert list(out[0].placements) == [Shard(0), Shard(2)]
    moved = {} if other == "replicated" else {
        "all-gather": b * z * h // 2 * c * p * 4}
    assert st.collective_bytes == moved
    assert st.matmul_flops == 2 * b * z * h * c * c * p / 8


def test_strided_rows_meeting_a_vocab_sharded_table_gather_the_rows():
    """An lm head: rows of sequences sharded over ``model`` merged under
    the batch (a strided shard of the rows) against a table whose vocab
    lies on ``model``. The rows, the smaller operand, are gathered and the
    logits keep the vocab's shard, as DTensor alone does for this
    product. The rule that keeps a strided shard of the rows must not
    gather the table instead: written so, it held the table whole on each
    rank (4.98e9 B a rank for one full-width qwen2-72b layer on (2, 2,
    16))."""
    b, s, d, v = 4, 64, 32, 1024
    with D.fake_world(8):
        mesh = make_local_mesh(2, 4, device_type="cpu")
        x = D.meta_dtensor((b, s, d), torch.float32, mesh,
                           (Shard(0), Shard(1)))
        w = D.meta_dtensor((d, v), torch.float32, mesh,
                           (Replicate(), Shard(1)))
        out = []
        st = D.trace(lambda x, w: out.append(torch.einsum(
            "bsd,dv->bsv", x, w)), (x, w), mesh)
    assert list(out[0].placements) == [Shard(0), Shard(2)]
    assert st.collective_bytes == {"all-gather": b // 2 * s * d * 4}
    assert st.matmul_flops == 2 * b * s * d * v / 8
