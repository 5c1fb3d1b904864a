"""Port parity: kernel K2 (``trimmed_agg_stacked``), the fused sort +
rank-weighted combine behind the trimmed-mean and median aggregators.

On the CPU the wrapper takes its plain version, which is held here against
the jnp oracle ``ref.trimmed_agg_stacked_ref`` and the Pallas kernel in
interpret mode at the reference's own bar, rtol 1e-5 / atol 1e-6
(``tests/test_trimmed_agg_stacked.py``). The CUDA kernel itself is held
against the plain version on the card by ``tests/test_torch_kernels.py``
and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import trimmed_agg as K2

torch.set_num_threads(1)


def _rank_weights(k, rw_vals):
    rw = np.zeros((k,), np.float32)
    for r, v in rw_vals:
        rw[r] += v
    return rw


def _combine(x, rw):
    return K2.trimmed_agg_stacked(torch.from_numpy(np.asarray(x)),
                                  torch.from_numpy(np.asarray(rw))).numpy()


@pytest.mark.parametrize("n,k", [(7, 1), (2048, 3), (2049, 5), (100_003, 4)])
def test_plain_k2_matches_reference(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((k, n)).astype(np.float32)
    rw = rng.dirichlet(np.ones(k)).astype(np.float32)
    got = _combine(x, rw)
    oracle = np.asarray(ref.trimmed_agg_stacked_ref(jnp.asarray(x),
                                                    jnp.asarray(rw)))
    pallas = np.asarray(ops.trimmed_stacked_combine(
        jnp.asarray(x), jnp.asarray(rw), mode="pallas_interpret"))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [3, 4])
def test_median_rank_weights_match_numpy_median(k):
    x = np.random.default_rng(k).standard_normal((k, 513)).astype(np.float32)
    rw = _rank_weights(k, [((k - 1) // 2, 0.5), (k // 2, 0.5)])
    np.testing.assert_allclose(_combine(x, rw), np.median(x, axis=0),
                               rtol=1e-6, atol=1e-6)


def test_inf_pad_rows_sort_last_and_stay_inert():
    real = np.random.default_rng(5).standard_normal((3, 257)) \
        .astype(np.float32)
    x = np.concatenate([real, np.full((2, 257), np.inf, np.float32)])
    got = _combine(x, _rank_weights(5, [(1, 1.0)]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.median(real, axis=0),
                               rtol=1e-6, atol=1e-6)


def test_k1_is_the_identity():
    x = np.random.default_rng(7).standard_normal((1, 2048)) \
        .astype(np.float32)
    np.testing.assert_array_equal(_combine(x, np.ones(1, np.float32)), x[0])


def test_nan_row_sorts_last():
    """A NaN ranks after +inf, as in the oracle's jnp.sort: the median of
    (1, NaN, 3) over three rows is 3, and the top rank holds the NaN."""
    x = np.array([[1.0, 5.0], [np.nan, 2.0], [3.0, np.inf]], np.float32)
    got = _combine(x, _rank_weights(3, [(1, 1.0)]))
    np.testing.assert_array_equal(got, [3.0, 5.0])
    top = _combine(x, _rank_weights(3, [(2, 1.0)]))
    assert np.isnan(top[0]) and top[1] == np.inf
    want = np.asarray(ref.trimmed_agg_stacked_ref(
        jnp.asarray(x), jnp.asarray(_rank_weights(3, [(2, 1.0)]))))
    np.testing.assert_array_equal(top, want)


def test_cpu_route_is_plain_counts_nothing_and_checks_inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 11, 47)).astype(np.float32))
    rw = torch.tensor([0.0, 1.0, 0.0])
    before = K2.launches
    got = K2.trimmed_agg_stacked(x, rw)
    assert K2.launches == before
    assert torch.equal(got, K2.trimmed_agg_stacked_plain(x, rw))
    assert got.shape == (11, 47)
    with pytest.raises(TypeError):
        K2.trimmed_agg_stacked(x.to(torch.float64), rw)
    with pytest.raises(TypeError):
        K2.trimmed_agg_stacked(x, rw.to(torch.int32))
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x, rw[:2])
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x[:0], rw[:0])
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x[:, :, ::2], rw)
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x, rw.to("meta"))
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x.to("meta"), rw.to("meta"))
