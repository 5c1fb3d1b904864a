"""The control: the plain reference computed with every weight product in
float8 (the step below the configurations' bfloat16), put in the
program's place, must come out not correct under the cell's limits (here
the CPU test size's). The same readings at the cells' own sizes come from
``portbench/calibrate.py`` on the card."""
import time

import pytest
import torch

from portbench import checks
from portbench.tests.tiny import tiny_spec


def _env(which):
    from portbench import harness
    spec = tiny_spec(which)
    return spec, harness.Env(torch, spec, 0, 0.0, 0, "cpu",
                             time.perf_counter())


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_training_control_is_not_correct(seed):
    from portbench.drivers import hfl_train as D
    spec, env = _env("train")
    ref = D.reference(env, seed)
    ctl = D.numbers(D.reference(env, seed, "fp8"), ref)
    ok, _ = checks.judge(dict(ctl, sync_gap=0.0), spec["limits"]["numbers"])
    assert ctl["grad_gap"] > spec["limits"]["numbers"]["grad_gap"]["limit"]
    assert not ok, ctl


@pytest.mark.parametrize("which", ["moe_prefill", "ssm_prefill"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_prefill_control_is_not_correct(which, seed):
    """At the positions a run compares (each request's last) and with the
    run's statistics over its ``check_calls`` calls."""
    from portbench.drivers import prefill as D
    spec, env = _env(which)
    s = D.Server(env, seed)
    b = s.shape[0]
    g, e, keep = [], [], []
    for _ in range(spec["traffic"]["check_calls"]):
        tok = s.draw()
        stats = {}
        ref = D.reference_logits(env, s.w, tok, stats=stats)
        ctl = D.reference_logits(env, s.w, tok, "fp8")
        g += D.gaps(ref, ctl.argmax(-1))
        e += D.errors(ref, ctl)
        keep += D.near_ties(env, stats.get("margin"), b)
    nums = D.numbers(g, e, b, keep)
    ok, _ = checks.judge(nums, spec["limits"]["numbers"])
    assert not ok, nums
