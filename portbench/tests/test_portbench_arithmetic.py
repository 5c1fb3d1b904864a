"""The yardstick's arithmetic on fixed inputs: percentiles, the interval
union behind busy and idle time, the naming of idle gaps, operation and
byte counts, the norm gaps of the comparison."""
import math

import pytest

from portbench import checks, costs, tracing
from portbench.drivers.prefill import Sample, numbers, percentile
from portbench.harness import load_json
from portbench.reference import mamba2, mixtral
from portbench.tests.tiny import ROOT


def test_percentile_nearest_rank():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile(list(range(1, 101)), 100) == 100
    assert percentile([3.0], 95) == 3.0
    assert percentile([1, 2, 3, 4], 95) == 4
    assert percentile(list(range(1, 21)), 95) == 19
    assert percentile([5, 1, 4, 2, 3], 50) == 3


def test_numbers_by_request_and_by_slot():
    # 3 calls of 2 requests: slot 1 is wrong in every call
    err = [0.01, 0.5, 0.02, 0.6, 0.03, 0.7]
    gap = [0.0, 1.0, 0.0, 2.0, 0.1, 3.0]
    n = numbers(gap, err, 2)
    assert n == {"token_gap": 3.0, "logit_err": pytest.approx(0.265),
                 "slot_logit_err": 0.6}
    # a request left out (a near-tie) leaves its slot's median to the
    # rest; the widest gap and the median over all requests keep it
    n = numbers(gap, err, 2, [True, True, True, True, True, False])
    assert n["slot_logit_err"] == pytest.approx(0.55)
    assert n["token_gap"] == 3.0
    assert n["logit_err"] == pytest.approx(0.265)
    n = numbers(gap, err, 2, [True, False, True, False, True, True])
    assert n["slot_logit_err"] == 0.7
    assert numbers(gap, err, 2, [False] * 6)["slot_logit_err"] == math.inf


def test_sample_holds_k_and_draws_from_the_seed():
    def draw(seed, n, k=3):
        s = Sample(k, seed)
        for i in range(n):
            s.offer(i)
            assert len(s.kept) == min(i + 1, k)
        return sorted(s.kept)
    assert draw(2 ** 33 + 5, 50) == draw(2 ** 33 + 5, 50)
    assert draw(1, 2) == [0, 1]
    seen = {x for seed in range(200) for x in draw(seed, 20)}
    assert seen == set(range(20))       # every call can be drawn


def test_union_busy_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert tracing.union_intervals(spans) == [(0, 12), (20, 30), (40, 41)]
    assert tracing.busy_time(spans, 0, 50) == 12 + 10 + 1
    assert tracing.busy_time(spans, 6, 22) == 6 + 2
    assert tracing.gaps(spans, 0, 50) == [(12, 20), (30, 40), (41, 50)]
    assert tracing.gaps([], 1, 2) == [(1, 2)]


def test_gaps_named_by_the_innermost_open_host_event():
    host = [(0, 100, "portbench::tier1"), (10, 20, "aten::mul"),
            (30, 31, "aten::add")]
    named = tracing.name_gaps([(12, 40), (35, 36), (50, 52), (200, 300),
                               (60, 80)], host)
    assert named == pytest.approx({
        "aten::mul": 28e-6, tracing.SMALL_GAP_NAME: 3e-6,
        tracing.HOST_IDLE_NAME: 100e-6, "portbench::tier1": 20e-6})


def test_top_keeps_the_largest():
    assert tracing.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                              ["c", 2.0]]


def test_k4_count_at_the_serving_shape():
    # phase 9's mamba2 prefill of 4 x 1024 tokens: 17.37 GFLOP a call
    ops, nbytes = costs.k4_cost(4, 4, 256, 64, 64, 1, 128)
    assert ops == 17_365_336_064
    assert nbytes == 4 * (2 * 4 * 4 * 256 * 64 * 64 + 4 * 4 * 256 * 64 + 64
                          + 2 * 4 * 4 * 256 * 128 + 4 * 4 * 64 * 64 * 128)
    assert costs.k4_least_s(4, 4, 256, 64, 64, 1, 128) == pytest.approx(
        3 * ops / 495e12)


def test_k5_count_at_the_serving_shape():
    # mixtral's 4 x 8192 tokens, 48 heads over 8, window 4096: 2.474 TFLOP
    ops, nbytes = costs.k5_cost(4, 8192, 48, 8, 128, 4096, 2)
    assert ops == 4 * 128 * 4 * 48 * (4096 * 4097 // 2 + 4096 * 4096)
    assert ops == pytest.approx(2.474e12, rel=1e-3)
    assert nbytes == 939_524_096
    assert costs.k5_least_s(4, 8192, 48, 8, 128, 4096) == ops / 989e12


@pytest.mark.parametrize("length,window", [(1, 0), (7, 0), (7, 3),
                                           (16, 16), (16, 20), (33, 5)])
def test_visible_pairs_against_a_count(length, window):
    n = sum(1 for i in range(length) for j in range(length)
            if j <= i and (not window or j > i - window))
    assert costs.visible_pairs(length, window) == n


def test_model_counts_of_the_cells():
    m2 = load_json(ROOT / "portbench/configs/mamba2-1.3b.json")
    mx = load_json(ROOT / "portbench/configs/mixtral-8x22b-4L.json")
    # mamba2: in_proj 2048 x (2 * 4096 + 2 * 128 + 64), out_proj 4096 x 2048
    w = mamba2.layer_matmul_params(m2)
    assert w == 2048 * 8512 + 4096 * 2048
    one = mamba2.prefill_flops(m2, 1, 256)
    ssd = costs.ssd_forward_flops(1, 256, 64, 64, 1, 128, 256)
    assert one == 48 * (256 * (2 * w + 2 * 4 * 4352) + ssd) \
        + 2 * 2048 * 50280
    n = 1_343_000_000
    assert mamba2.train_flops(m2, n, 4, 1024) == \
        6 * n * 4096 + 3 * 48 * costs.ssd_forward_flops(
            4, 1024, 64, 64, 1, 128, 256)
    # mixtral: a token's products a layer, the band, the last lm heads
    per_tok = (4 * 6144 * 48 * 128 + 4 * 6144 * 8 * 128
               + 2 * 3 * 2 * 6144 * 16384 + 2 * 6144 * 8)
    band, _ = costs.k5_cost(4, 8192, 48, 8, 128, 4096, 2)
    assert mixtral.prefill_flops(mx, 4, 8192) == \
        4 * (4 * 8192 * per_tok + band) + 2 * 4 * 6144 * 32768


def test_norm_gaps_and_judging():
    prog = {"a": [1.0, 2.2], "b": [0.0]}
    ref = {"a": [1.0, 2.0], "b": [1e-9]}
    # the median of the reference's norms (1.0) floors the tiny leaf's
    assert checks.worst_norm_gap(prog, ref) == pytest.approx(0.1)
    keep = checks.moved_leaves({"a": [1.0, 1.0], "b": [1e-9]})
    assert keep == {"a": [True, True], "b": [False]}
    assert checks.worst_rel_gap([1.0, 2.0], [1.0, 2.5]) == pytest.approx(0.2)
    assert checks.worst_rel_diff({"a": [0.1, 0.0]}, {"a": [2.0, 1.0]}) == \
        pytest.approx(0.1 / 2.0)
    ok, rows = checks.judge({"x": 0.1, "y": math.nan},
                            {"x": {"limit": 0.2}, "y": {"limit": 1.0}})
    assert not ok and rows["x"] == {"value": 0.1, "limit": 0.2}
    ok, _ = checks.judge({"x": 0.1}, {"x": {"limit": 0.2}})
    assert ok
    ok, _ = checks.judge({}, {"x": {"limit": 0.2}})
    assert not ok


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        assert isinstance(tree, tuple)
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tuple(tree.shape)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "mixtral-8x22b-4L",
                                  "tests/data/mamba2-tiny",
                                  "tests/data/mixtral-tiny"])
def test_weights_tree_is_the_programs(name):
    """The benchmark's weights (shapes from the reference, the tree from
    their paths) have the program's tree, path for path and shape for
    shape."""
    import time

    import torch

    from portbench import harness, weights
    from repro_torch.models import model as M
    path = (ROOT / "portbench" / f"{name}.json") if "/" in name else \
        (ROOT / "portbench" / "configs" / f"{name}.json")
    spec = {"config": load_json(path), "traffic": {}}
    env = harness.Env(torch, spec, 0, 0.0, 0, "cpu", time.perf_counter())
    shapes = env.reference().param_shapes(spec["config"])
    ours = weights.tree({p: torch.empty(s, device="meta")
                         for p, s in shapes.items()})
    path_kind = next(iter(spec["config"]["paths"]))
    theirs = M.abstract_params(env.program_config(path_kind))
    assert list(_leaves(ours)) == list(_leaves(theirs))
