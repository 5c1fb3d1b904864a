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
kept the batch's shards. A whole multi-pod train step takes 10–25 minutes
to trace here (``tools/dryrun_peak.py`` prints what it holds at its
peak), so the tests below hold the two causes of its peak one op at a
time, in seconds, on a (2, 2, 2) mesh: the recomputation's weight
gather, and softmax's backward on the forward's shards (by query over
``model``, where DTensor gathered every query's scores).
"""
import json
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

    def _add(self, t):
        super()._add(t)
        self.largest = max(self.largest, t.untyped_storage().nbytes())


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
