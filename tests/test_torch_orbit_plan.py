"""Port parity: orbit geometry, contact-plan engine and hardware timing of
``repro_torch`` against the JAX package, bitwise.

The visibility series run in float32 in both packages (64-bit JAX is off
in this suite), so the access windows must come out equal array for
array; the contact-plan queries and link times are numpy in both and
must agree exactly."""
import numpy as np
import pytest
import torch

from repro.core.contact_plan import ContactPlan as JaxPlan
from repro.orbit.constellation import WalkerStar as JaxWalker
from repro.orbit.constellation import satellite_elements as jax_elements
from repro.orbit.groundstations import gs_ecef as jax_gs
from repro.orbit.visibility import access_window_arrays as jax_windows
from repro.orbit.visibility import interplane_los_series as jax_los
from repro.sim.hardware import FLYCUBE as JAX_FLYCUBE
from repro.sim.hardware import SMALLSAT_SBAND as JAX_SBAND
from repro.sim.hardware import FleetProfile as JaxFleet
from repro_torch.core.contact_plan import ContactPlan, build_contact_plan
from repro_torch.orbit.constellation import WalkerStar, satellite_elements
from repro_torch.orbit.groundstations import gs_ecef
from repro_torch.orbit.visibility import (access_window_arrays,
                                          interplane_los_series)
from repro_torch.sim.hardware import FLYCUBE, SMALLSAT_SBAND, FleetProfile

torch.set_num_threads(1)


def test_elements_and_stations_equal():
    for nc, spc in [(2, 5), (3, 4), (10, 10)]:
        for a, b in zip(jax_elements(JaxWalker(nc, spc)),
                        satellite_elements(WalkerStar(nc, spc))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jax_gs(13), gs_ecef(13))


@pytest.mark.parametrize("nc,spc,n_gs,days", [(2, 5, 3, 1.0), (3, 4, 5, 0.5)])
def test_access_window_arrays_equal(nc, spc, n_gs, days):
    times = np.arange(0.0, days * 86_400, 30.0)
    incl = np.radians(90.0)
    want = jax_windows(JaxWalker(nc, spc), *jax_elements(JaxWalker(nc, spc))
                       [:2], incl, times, jax_gs(n_gs))
    c = WalkerStar(nc, spc)
    got = access_window_arrays(c, *satellite_elements(c)[:2], incl, times,
                               gs_ecef(n_gs), device="cpu")
    assert len(want[0]) > 0
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_interplane_los_equal():
    times = np.arange(0.0, 86_400.0, 30.0)
    c = WalkerStar(2, 5)
    raan, phase, _ = satellite_elements(c)
    want = jax_los(JaxWalker(2, 5), raan, phase, np.radians(90.0), times, 0, 5)
    got = interplane_los_series(c, raan, phase, np.radians(90.0), times, 0,
                                5, device="cpu")
    np.testing.assert_array_equal(want, got)


def test_build_contact_plan_equal():
    from repro.core.contact_plan import build_contact_plan as jax_build
    kw = dict(horizon_s=86_400.0, dt_s=30.0, with_isl_pairs=True)
    want = jax_build(2, 5, 3, **kw)
    got = build_contact_plan(2, 5, 3, device="cpu", **kw)
    assert got.sat_windows == want.sat_windows
    assert got.pair_windows == want.pair_windows
    np.testing.assert_array_equal(got.cluster_of, want.cluster_of)


def test_build_contact_plan_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        build_contact_plan(1, 2, 1, horizon_s=600.0)


def _random_windows(rng, nc, spc, n_gs, horizon=86_400.0, p_empty=0.25):
    """The randomized plan shape of tests/test_contact_plan_engine.py."""
    sat_windows = []
    for _ in range(nc * spc):
        wins = []
        if rng.random() > p_empty:
            for g in range(n_gs):
                t = rng.uniform(0, 4000)
                while t < horizon:
                    dur = rng.uniform(100, 900)
                    wins.append((t, min(t + dur, horizon), g))
                    t += dur + rng.uniform(500, 9000)
        wins.sort()
        sat_windows.append(wins)
    pair_windows = {}
    for ci in range(nc):
        for cj in range(ci + 1, nc):
            wins, t = [], rng.uniform(0, 2000)
            while t < horizon and rng.random() > 0.05:
                dur = rng.uniform(30, 400)
                wins.append((t, t + dur))
                t += dur + rng.uniform(200, 5000)
            pair_windows[(ci, cj)] = wins
    return sat_windows, pair_windows


def _both_plans(seed):
    rng = np.random.default_rng(seed)
    nc, spc = int(rng.integers(1, 4)), int(rng.integers(1, 13))
    sat_w, pair_w = _random_windows(rng, nc, spc, int(rng.integers(1, 4)))
    kw = dict(horizon_s=86_400.0, sat_windows=sat_w,
              cluster_of=np.repeat(np.arange(nc), spc), pair_windows=pair_w,
              min_isl_sats=int(rng.integers(1, 12)))
    return (rng, JaxPlan(constellation=JaxWalker(nc, spc), **kw),
            ContactPlan(constellation=WalkerStar(nc, spc), **kw))


@pytest.mark.parametrize("seed", range(6))
def test_batched_queries_bitwise(seed):
    rng, want, got = _both_plans(100 + seed)
    K = want.constellation.n_sats
    for _ in range(5):
        tvec = rng.uniform(-100, want.horizon_s + 1000, K)
        for a, b in zip(want.next_contacts(tvec), got.next_contacts(tvec)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(want.next_cluster_contacts(tvec),
                        got.next_cluster_contacts(tvec)):
            np.testing.assert_array_equal(a, b)
        t = float(tvec[0])
        assert got.next_contacts(t)[0].tolist() == \
            want.next_contacts(t)[0].tolist()


@pytest.mark.parametrize("seed", range(4))
def test_chain_pair_transfers_bitwise(seed):
    rng, want, got = _both_plans(200 + seed)
    C = want.constellation.n_clusters
    for t in rng.uniform(-100, want.horizon_s, 10):
        tx = float(rng.uniform(0, 2000))
        assert got.chain_pair_transfers(float(t), tx) == \
            want.chain_pair_transfers(float(t), tx)
        per_pair = {(ci, cj): float(rng.uniform(0, 1500))
                    for ci in range(C) for cj in range(ci + 1, C)}
        assert got.chain_pair_transfers(float(t), per_pair) == \
            want.chain_pair_transfers(float(t), per_pair)


def test_fleet_tx_time_bitwise():
    mix = [SMALLSAT_SBAND, FLYCUBE, SMALLSAT_SBAND, FLYCUBE, FLYCUBE]
    jmix = [JAX_SBAND, JAX_FLYCUBE, JAX_SBAND, JAX_FLYCUBE, JAX_FLYCUBE]
    got, want = FleetProfile.from_profiles(mix), JaxFleet.from_profiles(jmix)
    for n_bytes in (267_035.5, 854_552.0, 1.0):
        for link in ("downlink", "uplink", "isl"):
            np.testing.assert_array_equal(got.tx_time(n_bytes, link),
                                          want.tx_time(n_bytes, link))
            assert SMALLSAT_SBAND.tx_time(n_bytes, link) == \
                JAX_SBAND.tx_time(n_bytes, link)
    np.testing.assert_array_equal(got.train_time(np.arange(5)),
                                  want.train_time(np.arange(5)))
