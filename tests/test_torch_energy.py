"""Port parity: the eclipse geometry (``repro_torch.orbit.eclipse``), the
power helpers (``sim/hardware.py``) and the battery engine
(``repro_torch.sim.energy.EnergySim``) against the JAX package, on the same
numpy inputs.

The cases follow tests/test_energy.py, test_energy_engine.py and
test_energy_properties.py; the per-step integrator
``repro.sim.energy_ref.EnergySimRef`` is the oracle of the property case,
as it is there.

Tolerances: every eclipse boolean, ``PackedEclipse`` array, transition,
SoC array and recovery time is exact against the JAX package. The Sun
direction, a float32 unit vector whose sines and cosines torch and XLA
round differently, agrees to 2 ulp (atol 1.2e-7). Against the per-step
oracle the bar is the reference's own: SoC atol 1e-8 Wh, recovery times
abs 1e-5 s."""
import dataclasses

import numpy as np
import pytest

from repro.orbit import eclipse as JE
from repro.orbit import visibility as JV
from repro.sim import energy as JEN
from repro.sim import faults as JF
from repro.sim import hardware as JH
from repro.sim.energy_ref import EnergySimRef
from repro_torch.orbit import eclipse as TE
from repro_torch.orbit import visibility as TV
from repro_torch.orbit.constellation import WalkerStar, satellite_elements
from repro_torch.sim import energy as TEN
from repro_torch.sim import faults as TF
from repro_torch.sim import hardware as TH

CONSTELLATIONS = [(2, 5, 2.0, 30.0), (2, 3, 1.0, 60.0), (4, 10, 3.0, 60.0)]


def _elements(C, S, days, dt):
    c = WalkerStar(C, S)
    raan, phase, _ = satellite_elements(c)
    return c, raan, phase, np.radians(c.inclination_deg), \
        np.arange(0.0, days * 86_400.0, dt)


def _packed_equal(a, b):
    assert a.t0 == b.t0
    for f in ("init_eclipsed", "trans_t", "offsets"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_sun_direction_matches_reference():
    times = np.arange(0.0, 3 * 86_400.0, 30.0)
    want = np.asarray(JE.sun_direction_eci(times))
    got = TE.sun_direction_eci(times, device="cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    # equinox at t = 0: the Sun on +x
    np.testing.assert_array_equal(got[0], [1.0, 0.0, 0.0])


@pytest.mark.parametrize("shape", CONSTELLATIONS)
def test_eclipse_series_bitwise(shape):
    c, raan, phase, incl, times = _elements(*shape)
    want = JE.eclipse_series(c, raan, phase, incl, times)
    got = TE.eclipse_series(c, raan, phase, incl, times, device="cpu")
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("shape", CONSTELLATIONS)
@pytest.mark.parametrize("chunk", [8192, 1000, 7])
def test_packed_eclipse_bitwise(shape, chunk):
    c, raan, phase, incl, times = _elements(*shape)
    if chunk == 7:
        times = times[:600]             # many chunk boundaries, kept short
    want = JE.eclipse_series(c, raan, phase, incl, times, chunk=chunk,
                             packed=True)
    got = TE.eclipse_series(c, raan, phase, incl, times, chunk=chunk,
                            packed=True, device="cpu")
    _packed_equal(want, got)
    np.testing.assert_array_equal(got.to_dense(times), want.to_dense(times))
    assert got.nbytes == want.nbytes


def test_eclipse_fractions_bitwise():
    c, raan, phase, incl, times = _elements(2, 5, 1.0, 60.0)
    np.testing.assert_array_equal(
        TE.eclipse_fraction(c, raan, phase, incl, times, device="cpu"),
        JE.eclipse_fraction(c, raan, phase, incl, times))
    for C, S in ((1, 1), (2, 5)):
        assert TE.mean_eclipse_fraction(WalkerStar(C, S), device="cpu") == \
            JE.mean_eclipse_fraction(WalkerStar(C, S))


@pytest.mark.parametrize("seed", range(4))
def test_transitions_from_bool_matrix_bitwise(seed):
    rng = np.random.default_rng(seed)
    T, K = int(rng.integers(1, 60)), int(rng.integers(1, 7))
    vis = rng.random((T, K)) < 0.4
    times = np.arange(T) * 30.0 + 7.0
    prev = rng.random(K) < 0.5
    for p in (None, prev):
        for a, b in zip(TV.transitions_from_bool_matrix(vis, times, prev=p),
                        JV.transitions_from_bool_matrix(vis, times, prev=p)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TV.transitions_from_bool_matrix(vis[0], times)


def test_power_helpers_bitwise():
    duties = [{"training": 0.3, "radio_tx": 0.1},
              {"training": 0.0, "training_tx": 0.2, "radio_tx": 0.8},
              {"idle": 1.0}, {}]
    for d in duties:
        assert TH.oap_added_mw(d) == JH.oap_added_mw(d)
        for tp, jp in ((TH.FLYCUBE, JH.FLYCUBE),
                       (TH.SMALLSAT_SBAND, JH.SMALLSAT_SBAND)):
            for ecl in (None, 0.0, 0.5):
                assert TH.power_feasible(d, tp, ecl) == \
                    JH.power_feasible(d, jp, ecl)
    for r in (None, 6.9e6, 7.5e6):
        assert TH.analytic_eclipse_fraction(r) == \
            JH.analytic_eclipse_fraction(r)
    assert TEN.mixed_fleet((TH.FLYCUBE, TH.SMALLSAT_SBAND), 5) == \
        (TH.FLYCUBE, TH.SMALLSAT_SBAND) * 2 + (TH.FLYCUBE,)


# ---------------------------------------------------------------------------
# EnergySim
# ---------------------------------------------------------------------------


def _fleets(rng, K):
    gens = rng.uniform(300, 9000, K)
    idles = rng.uniform(300, 2000, K)
    return tuple(tuple(dataclasses.replace(
        mod.FLYCUBE, power_generation_mw=float(g),
        power=mod.PowerModes(idle=float(i))) for g, i in zip(gens, idles))
        for mod in (JH, TH))


def _random_eclipse(rng, T, K):
    """Alternating sunlit/eclipse runs of random length per satellite."""
    ecl = np.zeros((T, K), bool)
    for k in range(K):
        i, state = 0, bool(rng.integers(2))
        while i < T:
            run = int(rng.integers(1, 40))
            ecl[i:i + run, k] = state
            state = not state
            i += run
    return ecl


def _sim_state(s):
    return {n: v for n, v in vars(s).items()
            if isinstance(v, (np.ndarray, float, int))}


def _assert_sims_equal(a, b):
    sa, sb = _sim_state(a), _sim_state(b)
    assert sorted(sa) == sorted(sb)
    for n in sa:
        np.testing.assert_array_equal(sa[n], sb[n], err_msg=n)


def _drive(rng, sims, horizon, K):
    """A random sequence of advances, bills and queries applied to every
    sim in ``sims``; yields after each step."""
    t = 0.0
    for _ in range(12):
        t += float(rng.uniform(0.0, horizon * 0.25))
        for s in sims:
            s.advance_to(t)
        yield t
        if rng.random() < 0.5:
            ks = rng.integers(0, K, size=3)
            tr = rng.uniform(0, 4000, 3)
            cm = rng.uniform(0, 400, 3)
            bills = [s.bill_activity(ks, tr, cm) for s in sims]
            assert len(set(bills)) == 1, bills
            yield t


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("attack", [None, dict(duty=0.6, mode="radio_tx"),
                                    dict(duty=0.9, mode="training_tx",
                                         eclipse_only=False, targets=(1,))])
def test_energysim_bitwise(seed, attack):
    """Dense and packed eclipse inputs, random advance/bill sequences:
    every SoC, eligibility mask, recovery time and sunlit query equal."""
    rng = np.random.default_rng(seed)
    T, K, dt = 240, 6, 30.0
    times = np.arange(T) * dt
    ecl = _random_eclipse(rng, T, K)
    jf, tf = _fleets(rng, K)
    kw = dict(battery_capacity_wh=rng.uniform(0.05, 3.0, K),
              initial_soc=rng.uniform(0, 1, K),
              min_soc=float(rng.uniform(0.1, 0.9)))
    extra = float(rng.choice([0.0, 500.0]))
    atk = (None, None) if attack is None else \
        (JF.EnergyDrainAttack(**attack), TF.EnergyDrainAttack(**attack))
    packed_t = TE.PackedEclipse(0.0, ecl[0].copy(),
                                *_csr(ecl, times, K))
    packed_j = JE.PackedEclipse(0.0, ecl[0].copy(), *_csr(ecl, times, K))
    sims = [JEN.EnergySim(times, ecl, jf, JEN.EnergyConfig(**kw),
                          extra_load_mw=extra,
                          attack=atk[0]),
            TEN.EnergySim(times, ecl, tf, TEN.EnergyConfig(**kw),
                          extra_load_mw=extra, attack=atk[1]),
            TEN.EnergySim(None, packed_t, tf, TEN.EnergyConfig(**kw),
                          extra_load_mw=extra, attack=atk[1]),
            JEN.EnergySim(None, packed_j, jf, JEN.EnergyConfig(**kw),
                          extra_load_mw=extra, attack=atk[0])]
    for a, b in zip(sims[0].transition_events(),
                    sims[1].transition_events()):
        np.testing.assert_array_equal(a, b)
    for t in _drive(rng, sims, T * dt, K):
        ref = sims[0]
        for s in sims[1:]:
            np.testing.assert_array_equal(s.soc_wh, ref.soc_wh)
            np.testing.assert_array_equal(s.soc_frac(), ref.soc_frac())
            np.testing.assert_array_equal(s.eligible(), ref.eligible())
            np.testing.assert_array_equal(s.recover_times(np.arange(K)),
                                          ref.recover_times(np.arange(K)))
            assert [s.recover_time(k) for k in range(K)] == \
                [ref.recover_time(k) for k in range(K)]
            np.testing.assert_array_equal(s.sunlit_at(t), ref.sunlit_at(t))
            np.testing.assert_array_equal(s.sunrise_after(t),
                                          ref.sunrise_after(t))
    _assert_sims_equal(sims[0], sims[1])


def _csr(ecl, times, K):
    sat, tt = JV.transitions_from_bool_matrix(ecl, times)
    offsets = np.zeros(K + 1, np.int64)
    np.cumsum(np.bincount(sat, minlength=K), out=offsets[1:])
    return tt, offsets


@pytest.mark.parametrize("seed", range(5))
def test_energysim_matches_per_step_oracle(seed):
    """tests/test_energy_properties.py's property, seeded: the port's
    interval engine against the reference's per-step integrator."""
    rng = np.random.default_rng(1000 + seed)
    T, K = int(rng.integers(2, 200)), int(rng.integers(1, 7))
    dt = float(rng.choice([10.0, 30.0, 60.0]))
    times = np.arange(T) * dt
    ecl = _random_eclipse(rng, T, K)
    jf, tf = _fleets(rng, K)
    kw = dict(battery_capacity_wh=rng.uniform(0.02, 3.0, K),
              initial_soc=rng.uniform(0.0, 1.0, K),
              min_soc=float(rng.uniform(0.1, 0.9)))
    extra = float(rng.choice([0.0, 500.0, 2370.0]))
    sim = TEN.EnergySim(times, ecl, tf, TEN.EnergyConfig(**kw),
                        extra_load_mw=extra)
    ref = EnergySimRef(times, ecl, jf, JEN.EnergyConfig(**kw),
                       extra_load_mw=extra)
    t = 0.0
    for _ in range(10):
        t += float(rng.uniform(0.0, T * dt * 0.3))
        sim.advance_to(t)
        ref.advance_to(t)
        assert np.allclose(sim.soc_wh, ref.soc_wh, atol=1e-8)
        if rng.random() < 0.5:
            ks = rng.integers(0, K, size=3)
            tr = rng.uniform(0.0, 4000.0, 3)
            cm = rng.uniform(0.0, 400.0, 3)
            assert sim.bill_activity(ks, tr, cm) == \
                pytest.approx(ref.bill_activity(ks, tr, cm))
            assert np.allclose(sim.soc_wh, ref.soc_wh, atol=1e-8)
        got = sim.recover_times(np.arange(K))
        for k in range(K):
            want = ref.recover_time(k)
            if want is None:
                assert not np.isfinite(got[k])
            else:
                assert got[k] == pytest.approx(want, abs=1e-5)


def test_for_plan_builds_the_eclipse_on_the_given_device():
    """``EnergySim.for_plan`` of both packages over the same contact plan,
    with a mixed timing fleet, a power-side override and an attack: the
    packed eclipse (built by torch on the CPU here) and every engine
    array equal."""
    from repro.core.contact_plan import build_contact_plan as jplan
    from repro_torch.core.contact_plan import build_contact_plan as tplan
    kw = dict(horizon_s=86_400.0, dt_s=60.0)
    jp, tp = jplan(2, 3, 2, **kw), tplan(2, 3, 2, device="cpu", **kw)
    K = 6
    for over in (None, "fleet"):
        jcfg = JEN.EnergyConfig(
            battery_capacity_wh=10.0, initial_soc=0.6, eclipse_dt_s=60.0,
            fleet=JEN.mixed_fleet((JH.SMALLSAT_SBAND, JH.FLYCUBE), K)
            if over else None)
        tcfg = TEN.EnergyConfig(
            battery_capacity_wh=10.0, initial_soc=0.6, eclipse_dt_s=60.0,
            fleet=TEN.mixed_fleet((TH.SMALLSAT_SBAND, TH.FLYCUBE), K)
            if over else None)
        a = JEN.EnergySim.for_plan(
            jp, JH.FLYCUBE, jcfg,
            fleet=JEN.mixed_fleet((JH.FLYCUBE, JH.SMALLSAT_SBAND), K),
            attack=JF.EnergyDrainAttack(duty=0.5))
        b = TEN.EnergySim.for_plan(
            tp, TH.FLYCUBE, tcfg,
            fleet=TEN.mixed_fleet((TH.FLYCUBE, TH.SMALLSAT_SBAND), K),
            attack=TF.EnergyDrainAttack(duty=0.5), device="cpu")
        _assert_sims_equal(a, b)
        for t in (0.0, 3000.0, 40_000.0, 90_000.0):
            a.advance_to(t)
            b.advance_to(t)
            np.testing.assert_array_equal(a.soc_wh, b.soc_wh)
            np.testing.assert_array_equal(a.sunlit_at(t), b.sunlit_at(t))
