"""Port parity: the fault layer of ``repro_torch`` (``sim/faults.py`` and
the engine's payload faults) against the JAX package, on the same numpy
inputs.

The cases follow tests/test_faults.py, test_faults_properties.py and
test_storms.py: seeded outage / reset / storm timelines (CSR arrays), the
batched queries over them, the counter-based drop and corruption draws,
the energy-drain and poison attacks, and the corrupted or poisoned rows a
delivered update becomes.

Tolerances: every timeline array, query answer and draw is exact (the
module is numpy in both packages). Parameters after corruption or
poisoning agree at rtol = atol = 1e-5, the bar of
tests/test_quant_agg_stacked.py (the reference's float32 arithmetic may
be fused by XLA), and the untouched rows are exact."""
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spaceify as JS
from repro.sim import faults as JF
from repro_torch.core import spaceify as TS
from repro_torch.sim import faults as TF

HORIZON = 0.8 * 86_400.0


def _config(mod, storms=None, poison=None, attack=None, **kw):
    """One ``FaultConfig`` of ``mod`` (either package's faults module);
    nested configs are given as dicts (``storms['events']`` as tuples)."""
    if storms is not None:
        storms = dict(storms)
        storms["events"] = tuple(mod.StormEvent(*e)
                                 for e in storms.get("events", ()))
        storms = mod.StormConfig(**storms)
    return mod.FaultConfig(
        storms=storms,
        poison=None if poison is None else mod.PoisonAttack(**poison),
        attack=None if attack is None else mod.EnergyDrainAttack(**attack),
        **kw)


def _sims(n_sats, cluster_of=None, **kw):
    return (JF.FaultSim(_config(JF, **kw), n_sats, HORIZON,
                        cluster_of=cluster_of),
            TF.FaultSim(_config(TF, **kw), n_sats, HORIZON,
                        cluster_of=cluster_of))


CONFIGS = {
    "off": {},
    "outages": dict(mean_up_s=7200.0, mean_down_s=1800.0, seed=11),
    "short_outages": dict(mean_up_s=3000.0, mean_down_s=2000.0, seed=3),
    "resets": dict(radiation_rate_per_day=6.0, seed=5),
    "drops": dict(drop_prob=0.4, corrupt_prob=0.2, seed=9),
    "drawn_storms": dict(mean_up_s=9000.0, mean_down_s=1500.0,
                         drop_prob=0.2, corrupt_prob=0.1, seed=7,
                         storms=dict(rate_per_day=8.0,
                                     mean_duration_s=4000.0,
                                     outage_prob=0.6, drop_prob=0.5,
                                     corrupt_prob=0.3)),
    "scripted_storms": dict(seed=2, storms=dict(
        outage_prob=1.0, drop_prob=0.7, corrupt_prob=0.5,
        events=((1000.0, 2000.0, 0), (8000.0, 6000.0, 1, 0.5)))),
}


def _assert_same_state(a, b):
    """Every attribute of two FaultSims equal (arrays exact, storms as
    tuples), the config aside."""
    va, vb = vars(a), vars(b)
    assert sorted(va) == sorted(vb)
    for name in va:
        x, y = va[name], vb[name]
        if name == "cfg":
            continue
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        elif isinstance(x, (list, tuple)) and x and \
                dataclasses.is_dataclass(x[0]):
            assert [dataclasses.astuple(e) for e in x] == \
                [dataclasses.astuple(e) for e in y], name
        else:
            assert x == y, name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fault_timelines_bitwise(name):
    cluster_of = np.arange(8, dtype=np.int32) % 2
    a, b = _sims(8, cluster_of=cluster_of, **CONFIGS[name])
    _assert_same_state(a, b)
    for prop in ("has_base_outages", "has_storms", "has_outages",
                 "has_resets", "has_payload_faults", "seed_value"):
        assert getattr(a.cfg, prop) == getattr(b.cfg, prop), prop
    assert a.has_storms == b.has_storms
    np.testing.assert_array_equal(a.outage_fraction(), b.outage_fraction())
    for ea, eb in zip(a.outage_events(), b.outage_events()):
        np.testing.assert_array_equal(ea, eb)
    for ea, eb in zip(a.reset_events(), b.reset_events()):
        np.testing.assert_array_equal(ea, eb)
    if a.has_storms:
        for ea, eb in zip(a.storm_timeline_events(),
                          b.storm_timeline_events()):
            np.testing.assert_array_equal(ea, eb)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batched_queries_bitwise(name):
    cluster_of = np.arange(6, dtype=np.int32) % 3
    a, b = _sims(6, cluster_of=cluster_of, **CONFIGS[name])
    rng = np.random.default_rng(len(name))
    ks = np.arange(6)
    for t in rng.uniform(0.0, HORIZON, 25):
        np.testing.assert_array_equal(a.available(t), b.available(t))
        np.testing.assert_array_equal(a.next_up(ks, np.full(6, t)),
                                      b.next_up(ks, np.full(6, t)))
        np.testing.assert_array_equal(a.storm_severity(ks, t),
                                      b.storm_severity(ks, t))
    q = rng.integers(0, 6, 40)
    t0 = rng.uniform(0.0, HORIZON, 40)
    t1 = t0 + rng.uniform(0.0, 20_000.0, 40)
    np.testing.assert_array_equal(a.resets_between(q, t0, t1),
                                  b.resets_between(q, t0, t1))
    np.testing.assert_array_equal(a.storm_exposure(q, t0, t1),
                                  b.storm_exposure(q, t0, t1))
    for k, x, y in zip(q, t0, t1):
        assert a.reset_in(int(k), x, y) == b.reset_in(int(k), x, y)
        assert a.storms_between(x, y) == b.storms_between(x, y)


@pytest.mark.parametrize("name", ["drops", "drawn_storms",
                                  "scripted_storms", "off"])
def test_counter_based_draws_bitwise(name):
    """Drop, pair-drop and corruption draws at 200 contact times per
    satellite, in reverse order on the port (the draws are keyed by
    (seed, stream, sat, ms), so query order must not matter)."""
    cluster_of = np.arange(4, dtype=np.int32) % 2
    a, b = _sims(4, cluster_of=cluster_of, **CONFIGS[name])
    times = np.linspace(10.0, HORIZON, 200)
    for k in range(4):
        want = [(a.contact_dropped(k, t), a.corruption_at(k, t),
                 a.drop_prob_at(k, t), a.corrupt_prob_at(k, t))
                for t in times]
        got = [(b.contact_dropped(k, t), b.corruption_at(k, t),
                b.drop_prob_at(k, t), b.corrupt_prob_at(k, t))
               for t in times[::-1]][::-1]
        assert got == want
    for t in times[:50]:
        assert a.pair_dropped(0, 1, t) == b.pair_dropped(0, 1, t)
        assert a.pair_drop_prob_at(0, 1, t) == b.pair_drop_prob_at(0, 1, t)


@pytest.mark.parametrize("seed", range(6))
def test_storm_merge_bitwise(seed):
    """The seeded sweep of tests/test_storms.py's merge property: drawn
    storm outages merged into the i.i.d. ones, exact in both packages."""
    rng = np.random.default_rng(seed)
    n_sats = int(rng.integers(1, 10))
    kw = dict(mean_up_s=float(rng.uniform(2_000.0, 50_000.0)),
              mean_down_s=1_500.0, seed=seed,
              storms=dict(rate_per_day=float(rng.uniform(0.5, 24.0)),
                          mean_duration_s=4_000.0,
                          outage_prob=float(rng.uniform(0.1, 1.0))))
    a, b = _sims(n_sats, cluster_of=np.arange(n_sats, dtype=np.int32) % 3,
                 **kw)
    _assert_same_state(a, b)
    for k in range(n_sats):
        s = b._out_start[b._out_off[k]:b._out_off[k + 1]]
        e = b._out_end[b._out_off[k]:b._out_off[k + 1]]
        assert (e > s).all() and (s[1:] > e[:-1]).all()


@pytest.mark.parametrize("attack", [
    dict(), dict(duty=0.5, mode="radio_tx", eclipse_only=False),
    dict(duty=0.9, mode="training_tx", targets=(1,)),
    dict(duty=0.3, mode="radio_tx", targets=(0, 2))])
def test_energy_drain_attack_load_bitwise(attack):
    a, b = JF.EnergyDrainAttack(**attack), TF.EnergyDrainAttack(**attack)
    rng = np.random.default_rng(0)
    idle, tx, ttx = (rng.uniform(500.0, 3000.0, 4) for _ in range(3))
    np.testing.assert_array_equal(a.added_load_mw(idle, tx, ttx),
                                  b.added_load_mw(idle, tx, ttx))
    assert a.eclipse_only == b.eclipse_only


def test_poison_attack_compromised():
    a = JF.PoisonAttack(satellites=(1, 4), scale=3.0)
    b = TF.PoisonAttack(satellites=(1, 4), scale=3.0)
    assert [a.compromised(k) for k in range(6)] == \
        [b.compromised(k) for k in range(6)] == \
        [False, True, False, False, True, False]


# ---------------------------------------------------------------------------
# payload faults on delivered updates
# ---------------------------------------------------------------------------

# leaf names out of sorted order: the noise is drawn leaf by leaf in the
# reference's (sorted) pytree order, whatever the dict's order
LEAVES = {"conv1": (3, 3, 1, 4), "b1": (4,), "dense": (36, 8), "bd": (8,)}


def _params(rng, lead=()):
    return {n: rng.standard_normal(lead + s).astype(np.float32)
            for n, s in LEAVES.items()}


def _engines(fs_j, fs_t):
    """Stand-ins for the two engines: only ``faults`` is read."""
    j = types.SimpleNamespace(faults=fs_j)
    t = types.SimpleNamespace(faults=fs_t)
    t._payload_fault = functools.partial(TS.SpaceifiedFL._payload_fault, t)
    return j, t


def _deliveries(fs, n_sats):
    """(k, t) of one delivery per corruption mode, found by scanning."""
    found = {}
    for t in np.arange(1000.0, HORIZON, 137.0):
        for k in range(n_sats):
            d = fs.corruption_at(k, float(t))
            if d is not None and d[0] not in found:
                found[d[0]] = (k, float(t))
    assert sorted(found) == ["noise", "scale", "sign_flip"]
    return found


def _check(want, got, rows=None, touched=None):
    assert list(got) == list(LEAVES)        # the port keeps its leaf order
    for n in LEAVES:
        w, g = np.asarray(want[n]), got[n].numpy()
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=n)
        if rows is not None:
            keep = [r for r in range(rows) if r != touched]
            np.testing.assert_array_equal(g[keep], w[keep], err_msg=n)


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "noise", "poison"])
def test_corrupt_row_matches_reference(mode):
    a, b = _sims(4, corrupt_prob=0.5, seed=4,
                 poison=dict(satellites=(3,), scale=3.0))
    j, t = _engines(a, b)
    k, t_del = (3, 5000.0) if mode == "poison" else _deliveries(a, 3)[mode]
    rng = np.random.default_rng(1)
    stacked, ref = _params(rng, (4,)), _params(rng)
    want, bad_j = JS.SpaceifiedFL._corrupt_row(
        j, {n: jnp.asarray(v) for n, v in stacked.items()}, 2, k, t_del,
        {n: jnp.asarray(v) for n, v in ref.items()})
    got, bad_t = TS.SpaceifiedFL._corrupt_row(
        t, {n: torch.from_numpy(v) for n, v in stacked.items()}, 2, k,
        t_del, {n: torch.from_numpy(v) for n, v in ref.items()})
    assert bad_j and bad_t
    _check(want, got, rows=4, touched=2)


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "noise", "poison"])
def test_payload_fault_model_matches_reference(mode):
    a, b = _sims(4, corrupt_prob=0.5, seed=4,
                 poison=dict(satellites=(3,), scale=2.5))
    j, t = _engines(a, b)
    k, t_del = (3, 5000.0) if mode == "poison" else _deliveries(a, 3)[mode]
    rng = np.random.default_rng(2)
    params, ref = _params(rng), _params(rng)
    want, bad_j = JS.SpaceifiedFL._payload_fault_model(
        j, k, {n: jnp.asarray(v) for n, v in params.items()}, t_del,
        {n: jnp.asarray(v) for n, v in ref.items()})
    got, bad_t = TS.SpaceifiedFL._payload_fault_model(
        t, k, {n: torch.from_numpy(v) for n, v in params.items()}, t_del,
        {n: torch.from_numpy(v) for n, v in ref.items()})
    assert bad_j and bad_t
    _check(want, got)


def test_intact_delivery_is_untouched():
    a, b = _sims(4, corrupt_prob=0.0, seed=4)
    _, t = _engines(a, b)
    params = {n: torch.from_numpy(v)
              for n, v in _params(np.random.default_rng(3), (2,)).items()}
    out, bad = TS.SpaceifiedFL._corrupt_row(t, params, 0, 1, 1234.0, None)
    assert not bad and out is params
