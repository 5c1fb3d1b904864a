"""The harness end to end at a tiny size on the CPU (the program's plain
routes; the kernels' CPU versions), traced and untraced."""
import json

import pytest

from portbench.tests.tiny import ROOT, need_cuda, run_tiny


@pytest.mark.parametrize("which", ["train", "moe_prefill", "ssm_prefill"])
def test_tiny_cell_runs_and_is_correct(which):
    r = run_tiny(which)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    names = set(r["metrics"])
    assert {"setup_s", "peak_gib"} <= names
    assert ("train_tokens_per_s" in names) == (which == "train")
    assert ("ttft_p95_s" in names) == (which != "train")
    assert all(m["value"] >= 0 for m in r["metrics"].values())
    json.dumps(r)


def test_training_window_is_whole_rounds():
    r = run_tiny("train")
    assert r["attempted"] % 4 == 0          # sync_every of hfl-tiny


@pytest.mark.parametrize("which", ["train", "ssm_prefill"])
def test_traced_run(which):
    r = run_tiny(which, trace=1)
    assert r["correct"]
    assert list(r)[-1] == "checks"
    assert "window_s" in r["device"] and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    mfu = "mfu.train" if which == "train" else "mfu.prefill"
    assert 0 < r["metrics"][mfu]["value"] < 100


@pytest.mark.parametrize("which", ["moe_prefill", "train"])
def test_same_seed_same_inputs(which):
    """Weights and prompts (or token streams) come from the seed alone,
    and a large seed (more than 32 bits) is taken as it is."""
    import time

    import torch

    from portbench import harness
    from portbench.drivers import hfl_train, prefill
    from portbench.tests.tiny import tiny_spec
    env = harness.Env(torch, tiny_spec(which), 0, 0.0, 0, "cpu",
                      time.perf_counter())
    seed = 2 ** 31 + 12345
    if which == "train":
        a, b, c = (hfl_train.Trainer(env, s) for s in (seed, seed, seed + 1))
        assert all(torch.equal(a.p[k], b.p[k]) for k in a.p)
        assert not torch.equal(a.p["tok_embed"], c.p["tok_embed"])
        fa, fb = a.feed.next(), b.feed.next()
        assert torch.equal(fa[1]["tokens"], fb[1]["tokens"])
        assert not torch.equal(fa[0]["tokens"], fa[1]["tokens"])
    else:
        a, b = prefill.Server(env, seed), prefill.Server(env, seed)
        assert all(torch.equal(a.w[k], b.w[k]) for k in a.w)
        assert torch.equal(a.draw(), b.draw())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mamba2-prefill-2k"])
def test_cell_on_the_card(workload):
    need_cuda()
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
