"""The train step of every architecture's smoke config under the port's
dry run (``repro_torch.launch.dryrun``) on a (4, 2) fake mesh: every one
traces, MoE configs included, the sharded program communicates, and a
rank does its share of the step that one rank traces whole."""
import pytest

from repro_torch.configs import ARCH_IDS, InputShape, get_smoke_config
from repro_torch.launch import dryrun as D


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_dry_run_is_ok(arch):
    cfg = get_smoke_config(arch)
    shape = InputShape("t", 64, 8, "train")
    rec = D.run_one(arch, shape, "local", cfg=cfg, mesh_shape=(4, 2),
                    device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["op_matmul_flops_per_dev"] > 0
    assert rec["n_collectives"] > 0
    assert set(rec["collectives_by_dim"]) <= {"data", "model"}
    assert rec["mem_peak_bytes_per_dev"] > 0
    one = D.run_one(arch, shape, "local", cfg=cfg, mesh_shape=(1, 1),
                    device="cpu")
    assert one["status"] == "ok", one.get("traceback")
    # an eighth of the matmul work, at most 10% more (every rank computing
    # the whole batch, as DTensor's op-by-op placement does unless the
    # weights are gathered first, is 2-4x); at most 0.4 of the whole
    # step's peak (0.14-0.29 now; the whole batch on every rank is over 1)
    share = one["op_matmul_flops_per_dev"] / 8
    assert share <= rec["op_matmul_flops_per_dev"] <= 1.1 * share
    assert rec["mem_peak_bytes_per_dev"] <= 0.4 * one["mem_peak_bytes_per_dev"]
