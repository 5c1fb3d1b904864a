"""Port parity: client selection (``select_top``, the built-in policies
and ``deadline_aware`` / ``energy_aware`` / ``oracle`` over live energy
and fault engines) and the discrete-event clock of ``repro_torch``
(including the world timeline's eclipse, fault, storm and battery
sources) against the JAX package, bitwise (both are numpy in both
packages: every score, mask, skip count, epoch budget and event order is
exact)."""
import dataclasses

import numpy as np
import pytest

from repro.core import policy as JP
from repro.sim import events as JE
from repro_torch.core import policy as TP
from repro_torch.sim import events as TE


def test_select_top_rule_cases():
    """The cases of tests/test_policy.py::test_select_top_rule."""
    score = np.array([5.0, 1.0, 1.0, 0.5, 9.0])
    elig = np.array([True, True, True, False, True])
    for width in (3, 10, 0):
        assert TP.select_top(score, elig, width) == \
            JP.select_top(score, elig, width)
    assert TP.select_top(score, elig, 3) == [1, 2, 0]
    assert TP.select_top(score, np.zeros(5, bool), 3) == []


@pytest.mark.parametrize("seed", range(8))
def test_select_top_random_ties_bitwise(seed):
    rng = np.random.default_rng(seed)
    K = int(rng.integers(1, 60))
    score = rng.integers(0, 6, K).astype(np.float64) * 1800.0
    score[rng.random(K) < 0.1] = np.inf
    elig = rng.random(K) < 0.7
    for width in (1, 5, K):
        assert TP.select_top(score, elig, width) == \
            JP.select_top(score, elig, width)


@pytest.mark.parametrize("selection", ["first_contact", "scheduled",
                                       "intra_sl"])
def test_builtin_policy_decisions_bitwise(selection):
    rng = np.random.default_rng(len(selection))
    K = 12
    proj = {"contact_avail": rng.uniform(0, 9e3, K),
            "ret_avail": rng.uniform(9e3, 3e4, K),
            "valid": rng.random(K) < 0.8}
    t_down = rng.uniform(0.1, 3.0, K)
    common = dict(t=0.0, epochs=2.0, proj=proj, fleet=None,
                  t_up_k=t_down * 2, t_down_k=t_down, clients_per_round=5,
                  round_deadline_s=float("inf"))
    want = JP.resolve_policy(None, selection).decide(JP.PolicyInputs(**common))
    got = TP.resolve_policy(None, selection).decide(TP.PolicyInputs(**common))
    np.testing.assert_array_equal(got.score, want.score)
    np.testing.assert_array_equal(got.eligible, want.eligible)
    assert got.skips == want.skips == {}


def test_resolve_policy_contract():
    """Every registered name, the three non-built-in policies included,
    resolves to the class of the same name as in the JAX package, with the
    same hooks and knobs."""
    assert sorted(TP.POLICIES) == sorted(JP.POLICIES)
    for sel in sorted(JP.POLICIES):
        got = TP.resolve_policy(sel, "scheduled")
        want = JP.resolve_policy(sel, "scheduled")
        assert type(got).__name__ == type(want).__name__
        assert (got.name, got.member_budgets, got.defers_in_eclipse) == \
            (want.name, want.member_budgets, want.defers_in_eclipse)
        assert vars(got) == vars(want)
    assert not hasattr(TP, "NOT_PORTED")
    inst = TP.ScheduledPolicy()
    assert TP.resolve_policy(inst, "first_contact") is inst
    with pytest.raises(ValueError, match="unknown selection policy"):
        TP.resolve_policy("no_such_policy", "scheduled")
    with pytest.raises(ValueError, match="unknown FLConfig.selection"):
        TP.resolve_policy(None, "no_such_selection")
    with pytest.raises(TypeError):
        TP.resolve_policy(42, "scheduled")


def _drain(mod, pushes):
    q = mod.EventQueue()
    for t, kind, key in pushes:
        q.push(t, kind, key=key)
    return [(e.t, e.kind, e.key) for e in (q.pop() for _ in pushes)]


@pytest.mark.parametrize("seed", range(6))
def test_event_queue_pop_order_bitwise(seed):
    """Random pushes with heavy timestamp ties, as in
    tests/test_event_engine_properties.py: both queues pop identically,
    by (t, priority, key, seq)."""
    rng = np.random.default_rng(seed)
    kinds = sorted(JE.PRIORITY)
    assert sorted(TE.PRIORITY) == kinds
    assert TE.PRIORITY == JE.PRIORITY
    pushes = [(float(rng.integers(0, 5)) * 10.0,
               kinds[int(rng.integers(len(kinds)))], int(rng.integers(0, 8)))
              for _ in range(int(rng.integers(2, 60)))]
    got = _drain(TE, pushes)
    assert got == _drain(JE, pushes)
    assert got == sorted(got, key=lambda e: (e[0], TE.PRIORITY[e[1]], e[2]))


def test_event_queue_rejects_past_and_pop_until():
    for mod in (TE, JE):
        q = mod.EventQueue()
        for i, t in enumerate([5.0, 1.0, 3.0, 3.0, 9.0]):
            q.push(t, mod.TRAIN_DONE, key=i)
        head = q.pop_until(3.0)
        assert [(e.t, e.key) for e in head] == [(1.0, 1), (3.0, 2), (3.0, 3)]
        with pytest.raises(ValueError):
            q.push(2.0, mod.TRAIN_DONE)
        assert q.peek_time() == 5.0


@pytest.mark.parametrize("seed", range(4))
def test_world_timeline_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 80))
    times = np.sort(rng.uniform(0.0, 1000.0, n))
    keys = rng.integers(0, 5, n)
    cuts = np.sort(rng.uniform(0.0, 1000.0, 3)).tolist() + [1000.0]

    def build(mod):
        tl = mod.WorldTimeline()
        tl.add_source(mod.CONTACT_OPEN, times[:n // 2], keys[:n // 2])
        tl.add_source(mod.CONTACT_CLOSE, times[n // 2:], keys[n // 2:])
        return tl

    a, b = build(TE), build(JE)
    assert [a.advance_through(t) for t in cuts] == \
        [b.advance_through(t) for t in cuts]
    assert a.stats.as_dict() == b.stats.as_dict()
    c, d = build(TE), build(JE)
    ev_t = [(e.t, e.kind, e.key) for t in cuts for e in c.events_between(t)]
    ev_j = [(e.t, e.kind, e.key) for t in cuts for e in d.events_between(t)]
    assert ev_t == ev_j


# ---------------------------------------------------------------------------
# the policies over live energy and fault engines (tests/test_policy.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plans_and_data():
    from repro.core.contact_plan import build_contact_plan as jplan
    from repro.data.synthetic import make_federated_dataset as jds
    from repro_torch.core.contact_plan import build_contact_plan as tplan
    from repro_torch.data.synthetic import make_federated_dataset as tds
    kw = dict(horizon_s=0.8 * 86_400.0, dt_s=60.0)
    return ((jplan(2, 3, 2, **kw), jds("femnist", 6, 16)),
            (tplan(2, 3, 2, device="cpu", **kw),
             tds("femnist", 6, 16, device="cpu")))


@pytest.fixture
def engines(plans_and_data):
    """A fresh FedAvgSat of each package on the same 2 x 3 plan with
    storms, outages, drops, resets and drained batteries (nothing is
    trained: the policies only read the projections and the engines'
    state)."""
    from repro.core.spaceify import FedAvgSat as JFedAvg
    from repro.core.spaceify import FLConfig as JFL
    from repro.sim import energy as JEN
    from repro.sim import faults as JF
    from repro.sim import hardware as JH
    from repro_torch.core.spaceify import FedAvgSat as TFedAvg
    from repro_torch.core.spaceify import FLConfig as TFL
    from repro_torch.sim import energy as TEN
    from repro_torch.sim import faults as TF
    from repro_torch.sim import hardware as TH

    def cfg(fl, en, fm, hw):
        faults = fm.FaultConfig(
            mean_up_s=7200.0, mean_down_s=1800.0, drop_prob=0.3,
            radiation_rate_per_day=2.0, seed=5,
            storms=fm.StormConfig(rate_per_day=6.0, mean_duration_s=7200.0,
                                  drop_prob=0.6))
        energy = en.EnergyConfig(
            battery_capacity_wh=8.0, min_soc=0.4,
            initial_soc=tuple(1.0 if k % 3 else 0.03 for k in range(6)))
        fleet = en.mixed_fleet((hw.FLYCUBE, hw.SMALLSAT_SBAND), 6)
        return fl(model="mlp", clients_per_round=3, batch_size=16,
                  faults=faults, energy=energy,
                  round_deadline_s=9000.0), fleet

    (jplan, jds), (tplan, tds) = plans_and_data
    jc, jfleet = cfg(JFL, JEN, JF, JH)
    tc, tfleet = cfg(TFL, TEN, TF, TH)
    return (JFedAvg(jplan, jfleet, jds, jc), TFedAvg(tplan, tfleet, tds, tc))


POLICY_CASES = [("deadline_aware", {}),
                ("deadline_aware", dict(storm_penalty_s=5e3,
                                        comm_weight=3.0)),
                ("energy_aware", {}),
                ("energy_aware", dict(defer_soc=0.8, critical_soc=0.2)),
                ("oracle", {}), ("scheduled", {}), ("first_contact", {})]


@pytest.mark.parametrize("name,kw", POLICY_CASES)
def test_policy_decisions_bitwise(engines, name, kw):
    """Decisions, selections and per-member epoch budgets of each policy
    at 12 selection times over a faulted, battery-gated fleet."""
    ja, tb = engines
    jpol, tpol = JP.POLICIES[name](**kw), TP.POLICIES[name](**kw)
    fired = set()
    for t in np.linspace(0.0, 0.6 * 86_400.0, 12):
        for ep in (1, 2):
            jproj = ja._projected_returns(t, ep)
            tproj = tb._projected_returns(t, ep)
            assert sorted(jproj) == sorted(tproj)
            for key in jproj:
                np.testing.assert_array_equal(tproj[key], jproj[key],
                                              err_msg=key)
            want = jpol.decide(ja._policy_inputs(jproj, t, ep))
            got = tpol.decide(tb._policy_inputs(tproj, t, ep))
            np.testing.assert_array_equal(got.score, want.score)
            np.testing.assert_array_equal(got.eligible, want.eligible)
            assert got.skips == want.skips
            fired |= set(got.skips)
            assert TP.select_top(got.score, got.eligible, 3) == \
                JP.select_top(want.score, want.eligible, 3)
            jb = jpol.epoch_budgets(ja._policy_inputs(None, t, ep), 4)
            tb_ = tpol.epoch_budgets(tb._policy_inputs(None, t, ep), 4)
            assert (jb is None) == (tb_ is None)
            if jb is not None:
                np.testing.assert_array_equal(tb_, jb)
                assert tb_.dtype == jb.dtype
    np.testing.assert_array_equal(tb.energy.soc_wh, ja.energy.soc_wh)
    if name in ("deadline_aware", "energy_aware", "oracle"):
        assert fired, f"{name}: no skip or demotion in 24 decisions"


# ---------------------------------------------------------------------------
# the world timeline's optional sources
# ---------------------------------------------------------------------------


def test_world_timeline_optional_sources_bitwise(engines):
    """``WorldTimeline.for_fl(plan, energy, faults)``: eclipse, outage,
    reset and storm sources beside the contact windows, materialized one
    event at a time and in bulk, plus battery-floor crossings noted by
    ``note_eligibility``: the same events in the same order."""
    ja, tb = engines
    jt = JE.WorldTimeline.for_fl(ja.plan, ja.energy, ja.faults)
    tt = TE.WorldTimeline.for_fl(tb.plan, tb.energy, tb.faults)
    cuts = np.linspace(0.0, ja.plan.horizon_s, 7)[1:]
    ev_j = [(e.t, e.kind, e.key) for t in cuts[:3]
            for e in jt.events_between(t)]
    ev_t = [(e.t, e.kind, e.key) for t in cuts[:3]
            for e in tt.events_between(t)]
    assert ev_t == ev_j
    kinds = {e[1] for e in ev_t}
    for kind in (TE.ECLIPSE_ENTRY, TE.ECLIPSE_EXIT, TE.FAULT_DOWN,
                 TE.FAULT_UP, TE.RADIATION_RESET, TE.STORM_BEGIN,
                 TE.CONTACT_OPEN):
        assert kind in kinds, kind
    assert [(e.t, e.kind, e.key) for e in tt.iter_events(cuts[4])] == \
        [(e.t, e.kind, e.key) for e in jt.iter_events(cuts[4])]
    assert tt.advance_through(cuts[5]) == jt.advance_through(cuts[5])
    rng = np.random.default_rng(0)
    for i in range(5):
        mask = rng.random(6) < 0.5
        jt.note_eligibility(mask, float(i))
        tt.note_eligibility(mask, float(i))
    assert tt.stats.as_dict() == jt.stats.as_dict()
    assert tt.stats.counts.get(TE.BATTERY_FLOOR, 0) > 0
    assert dataclasses.asdict(TE.Event(1.0, TE.STORM_END, 2)) == \
        dataclasses.asdict(JE.Event(1.0, JE.STORM_END, 2))
