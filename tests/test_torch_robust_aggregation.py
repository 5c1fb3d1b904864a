"""Port parity: the Byzantine-robust aggregation layer of ``repro_torch``
against the JAX package's, on the same numpy cohorts.

Every estimator runs on both packages at K = 5 with 3 valid rows and 2
pad rows (weight 0) that are NaN or +inf. Outputs agree at the
reference's bar, rtol 1e-5 / atol 1e-6 (``tests/test_robust_aggregation.
py``; the trimmed mean and median go through kernel K2's plain version
here, which adds in another order than the oracle), and the attenuated
row counts are equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as JA
from repro_torch.convert import params_from_numpy as _to_torch
from repro_torch.core import aggregation as TA

torch.set_num_threads(1)

SHAPES = {"p0": (17,), "p1": (4, 9), "p2": (3, 3, 1, 2)}


def params_from_numpy(tree):
    """The reference's parameters as CPU tensors (the port's default
    device is the card)."""
    return _to_torch(tree, device="cpu")


def _cohort(seed, k=5, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.standard_normal((k,) + s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _both(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}, \
        params_from_numpy(tree)


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("pad", [np.nan, np.inf])
@pytest.mark.parametrize("name", sorted(TA.ROBUST_AGGREGATORS))
def test_aggregator_matches_reference(name, pad):
    """3 valid rows (one of them an outlier, so the clip and the trims
    act) + 2 non-finite pad rows."""
    stacked = _cohort(1)
    for v in stacked.values():
        v[1] *= 40.0                     # outlier row
        v[3:] = pad
    reference = {n: (0.1 * np.ones(s)).astype(np.float32)
                 for n, s in SHAPES.items()}
    w = np.array([32.0, 16.0, 32.0, 0.0, 0.0])
    js, ts = _both(stacked)
    jr, tr = _both(reference)
    want, n_want = JA.make_robust_aggregator(name).aggregate(
        js, w, jr, mode="jnp")
    got, n_got = TA.make_robust_aggregator(name).aggregate(ts, w, tr)
    assert n_got == n_want
    _assert_close(got, want)


@pytest.mark.parametrize("agg", [TA.NormClipAggregator(multiplier=1.2),
                                 TA.TrimmedMeanAggregator(trim=0.4),
                                 TA.KrumAggregator(byzantine_f=0)])
def test_configured_aggregators_match_reference(agg):
    """Non-default settings, all rows valid, against the same settings in
    the JAX package."""
    stacked = _cohort(2, k=6)
    w = np.arange(1.0, 7.0)
    jcls = {TA.NormClipAggregator: JA.NormClipAggregator,
            TA.TrimmedMeanAggregator: JA.TrimmedMeanAggregator,
            TA.KrumAggregator: JA.KrumAggregator}[type(agg)]
    jagg = jcls(**dataclasses.asdict(agg))
    zeros = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    js, ts = _both(stacked)
    jz, tz = _both(zeros)
    want, n_want = jagg.aggregate(js, w, jz, mode="jnp")
    got, n_got = agg.aggregate(ts, w, tz)
    assert n_got == n_want
    _assert_close(got, want)


def test_registry_and_its_errors():
    assert TA.make_robust_aggregator(None) is None
    assert TA.make_robust_aggregator("mean") is None
    assert sorted(TA.ROBUST_AGGREGATORS) == sorted(JA.ROBUST_AGGREGATORS)
    for name, cls in TA.ROBUST_AGGREGATORS.items():
        agg = TA.make_robust_aggregator(name)
        assert isinstance(agg, cls) and agg.name == name
        assert dataclasses.asdict(agg) == dataclasses.asdict(
            JA.ROBUST_AGGREGATORS[name]())
    inst = TA.TrimmedMeanAggregator(trim=0.3)
    assert TA.make_robust_aggregator(inst) is inst
    with pytest.raises(ValueError, match="unknown aggregator"):
        TA.make_robust_aggregator("huber")
    with pytest.raises(TypeError):
        TA.make_robust_aggregator(3.14)
    with pytest.raises(dataclasses.FrozenInstanceError):
        TA.NormClipAggregator().multiplier = 1.0


def test_robust_apply_buffered_deltas_median_matches_reference():
    """FedBuff's robust flush: global += coordinate-wise median of the
    weighted deltas (the case of ``tests/test_robust_aggregation.py``)."""
    rng = np.random.default_rng(4)
    g = {"w": rng.standard_normal(40).astype(np.float32)}
    base = {"w": np.stack([g["w"]] * 3)}
    new = {"w": base["w"] + rng.standard_normal((3, 40)).astype(np.float32)}
    wts = np.array([0.5, 1.0, 2.0], np.float32)
    want, n_want = JA.robust_apply_buffered_deltas(
        _both(g)[0], _both(new)[0], _both(base)[0], jnp.asarray(wts),
        JA.MedianAggregator(), mode="jnp")
    got, n_got = TA.robust_apply_buffered_deltas(
        params_from_numpy(g), params_from_numpy(new),
        params_from_numpy(base), wts, TA.MedianAggregator())
    assert n_got == n_want == 1
    deltas = wts[:, None] * (new["w"] - base["w"])
    np.testing.assert_allclose(got["w"].numpy(),
                               g["w"] + np.median(deltas, axis=0),
                               rtol=1e-5, atol=1e-6)
    _assert_close(got, want)


def test_custom_aggregator_instance_is_used_verbatim():
    class First(TA.RobustAggregator):
        name = "first"

        def aggregate(self, stacked_params, weights, reference):
            return {k: v[0] for k, v in stacked_params.items()}, 7

    agg = TA.make_robust_aggregator(First())
    out, n_att = TA.robust_apply_buffered_deltas(
        {"w": torch.zeros(8)}, {"w": torch.ones(2, 8)},
        {"w": torch.zeros(2, 8)}, np.array([3.0, 5.0]), agg)
    assert n_att == 7
    np.testing.assert_allclose(out["w"].numpy(), 3.0)


def test_rank_defenses_survive_model_replacement_mean_does_not():
    """One model-replacement row in five (``(1 + s) * ref - s * trained``,
    ``tests/test_robust_aggregation.py``): the plain mean is dragged far
    from the honest mean, trimmed mean and median stay near it, and both
    packages agree."""
    rng = np.random.default_rng(0)
    honest = (1.0 + 0.05 * rng.standard_normal((5, 100))).astype(np.float32)
    s = 50.0
    poisoned = honest.copy()
    poisoned[0] = -s * honest[0]
    w = np.ones(5)
    honest_mean = honest[1:].mean(0)
    plain = TA.weighted_average({"w": torch.from_numpy(poisoned)}, w)
    assert np.abs(plain["w"].numpy() - honest_mean).max() > 5.0
    ref0 = {"w": np.zeros(100, np.float32)}
    for tagg, jagg in ((TA.TrimmedMeanAggregator(trim=0.2),
                        JA.TrimmedMeanAggregator(trim=0.2)),
                       (TA.MedianAggregator(), JA.MedianAggregator())):
        got, _ = tagg.aggregate({"w": torch.from_numpy(poisoned)}, w,
                                params_from_numpy(ref0))
        want, _ = jagg.aggregate({"w": jnp.asarray(poisoned)}, w,
                                 _both(ref0)[0], mode="jnp")
        assert np.abs(got["w"].numpy() - honest_mean).max() < 0.5
        _assert_close(got, want)


@pytest.mark.parametrize("pad", [1e3, -7.0])
@pytest.mark.parametrize("name", ["trimmed_mean", "median"])
def test_rank_aggregators_ignore_finite_pad_garbage(name, pad):
    """The rank pair hands K2 the cohort as it is, with the validity mask:
    finite garbage in the zero-weight rows (which a sort would rank among
    the real ones, were it read) leaves the result equal to the JAX
    package's."""
    stacked = _cohort(3)
    for v in stacked.values():
        v[3:] = pad
    w = np.array([8.0, 32.0, 16.0, 0.0, 0.0])
    js, ts = _both(stacked)
    zeros = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    jz, tz = _both(zeros)
    want, n_want = JA.make_robust_aggregator(name).aggregate(
        js, w, jz, mode="jnp")
    got, n_got = TA.make_robust_aggregator(name).aggregate(ts, w, tz)
    assert n_got == n_want
    _assert_close(got, want)


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("name", ["trimmed_mean", "median"])
def test_robust_apply_buffered_deltas_rank_pair_matches_reference(name, k):
    """FedBuff's robust flush through the trimmed mean and the median,
    every leaf of the buffer in one K2 call, against the JAX package."""
    rng = np.random.default_rng(k)
    g = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in SHAPES.items()}
    base = {n: np.stack([v] * k) for n, v in g.items()}
    new = {n: b + rng.standard_normal(b.shape).astype(np.float32)
           for n, b in base.items()}
    wts = rng.uniform(0.2, 2.0, k).astype(np.float32)
    agg = TA.make_robust_aggregator(name)
    want, n_want = JA.robust_apply_buffered_deltas(
        _both(g)[0], _both(new)[0], _both(base)[0], jnp.asarray(wts),
        JA.make_robust_aggregator(name), mode="jnp")
    got, n_got = TA.robust_apply_buffered_deltas(
        params_from_numpy(g), params_from_numpy(new),
        params_from_numpy(base), wts, agg)
    assert n_got == n_want
    _assert_close(got, want)
