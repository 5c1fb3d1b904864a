"""Port parity: client selection (``select_top`` and the built-in
policies) and the discrete-event clock of ``repro_torch`` against the JAX
package, bitwise (both are numpy in both packages)."""
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
    for sel in ("first_contact", "scheduled", "intra_sl"):
        assert type(TP.resolve_policy(sel, "scheduled")).__name__ == \
            type(JP.resolve_policy(sel, "scheduled")).__name__
    inst = TP.ScheduledPolicy()
    assert TP.resolve_policy(inst, "first_contact") is inst
    for name in ("deadline_aware", "energy_aware", "oracle"):
        with pytest.raises(NotImplementedError):
            TP.resolve_policy(name, "scheduled")
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
