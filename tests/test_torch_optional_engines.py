"""Port parity of the engines' optional layers: faults, storms, the
energy-drain and poison attacks, battery energy, deadline/quorum rounds
with ``carry`` and ``discard``, bounded retries, and the
``deadline_aware`` / ``energy_aware`` / ``oracle`` policies, on FedAvg,
FedProx, FedBuff and AutoFLSat, against the JAX package.

The matrix follows tests/test_event_parity.py's scenarios (a 2 x 3
constellation, MLP, a mixed fast/slow-radio fleet) with the fault, energy
and deadline settings of tests/test_faults.py, test_storms.py and
test_policy.py. Both packages get the same numpy inputs; the port's
training draws are the reference's (``JaxRandom`` of
tests/test_torch_slice.py).

Tolerances: every non-accuracy ``RoundRecord`` field and the event
clock's per-kind counts are exact. Accuracy is a count over 512 test
samples: the port rounds convolutions and reductions in another order
than XLA (see tests/test_torch_slice.py), and each quantized round
re-snaps weights near a half step to the other level, so the gap grows
with the round: ACC_TOL (2 samples) in the first two rounds, 24 samples
after (the bar chip_smoke.py holds card against CPU). Global parameters
after corruption or poisoning agree at rtol = atol = 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import spaceify as JS
from repro.core.autoflsat import AutoFLSat as JAuto
from repro.core.contact_plan import build_contact_plan as jax_plan
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.sim import energy as JEN
from repro.sim import faults as JF
from repro.sim import hardware as JH
from repro_torch.core import spaceify as TS
from repro_torch.core.autoflsat import AutoFLSat as TAuto
from repro_torch.core.contact_plan import build_contact_plan
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.sim import energy as TEN
from repro_torch.sim import faults as TF
from repro_torch.sim import hardware as TH
from test_torch_slice import ACC_TOL, JaxRandom

torch.set_num_threads(1)

K = 6
ACC_TOL_LATE = 24 / 512
ENGINES = {"fedavg": (JS.FedAvgSat, TS.FedAvgSat),
           "fedprox": (JS.FedProxSat, TS.FedProxSat),
           "fedbuff": (JS.FedBuffSat, TS.FedBuffSat),
           "autoflsat": (JAuto, TAuto)}

STORMS = dict(rate_per_day=6.0, mean_duration_s=7200.0, drop_prob=0.6,
              corrupt_prob=0.5)
# half the fleet starts nearly drained: the battery floor binds
DRAINED = dict(battery_capacity_wh=10.0, min_soc=0.4,
               initial_soc=tuple(1.0 if k % 2 == 0 else 0.05
                                 for k in range(K)))
SCENARIOS = {
    "storms_seu_resets": dict(
        energy={}, quant_bits=8,
        faults=dict(storms=STORMS, corrupt_prob=0.3,
                    radiation_rate_per_day=2.0)),
    "poison_trimmed_mean": dict(
        quant_bits=0, aggregator="trimmed_mean",
        faults=dict(poison=dict(satellites=(1, 4), scale=3.0))),
    "drain_attack_median_retries": dict(
        energy={}, quant_bits=8, aggregator="median", max_retries=1,
        faults=dict(attack={}, drop_prob=0.5)),
    "deadline_carry": dict(
        quant_bits=8, round_deadline_s=3000.0, quorum=2, late_policy="carry",
        faults=dict(drop_prob=0.4)),
    "deadline_discard_retries": dict(
        energy={}, quant_bits=0, round_deadline_s=3000.0,
        late_policy="discard", max_retries=2, faults=dict(drop_prob=0.4)),
    "deadline_only": dict(quant_bits=8, round_deadline_s=1500.0),
    "drained_batteries": dict(energy=DRAINED, quant_bits=8),
    "deadline_aware": dict(
        energy={}, quant_bits=8, policy="deadline_aware",
        round_deadline_s=6000.0,
        faults=dict(storms=STORMS, radiation_rate_per_day=1.0)),
    "energy_aware": dict(energy=DRAINED, quant_bits=8, policy="energy_aware",
                         faults=dict(storms=STORMS)),
    "oracle": dict(
        energy={}, quant_bits=8, policy="oracle",
        faults=dict(storms=STORMS, radiation_rate_per_day=1.0)),
}


def _faults(mod, storms=None, poison=None, attack=None, **kw):
    base = dict(mean_up_s=7200.0, mean_down_s=1800.0, drop_prob=0.2, seed=3)
    base.update(kw)
    return mod.FaultConfig(
        storms=None if storms is None else mod.StormConfig(**storms),
        poison=None if poison is None else mod.PoisonAttack(**poison),
        attack=None if attack is None else mod.EnergyDrainAttack(**attack),
        **base)


def fl_config(spaceify, energy_mod, faults_mod, energy=None, faults=None,
              **kw):
    base = dict(model="mlp", clients_per_round=4, epochs=2, batch_size=16,
                max_rounds=4, max_local_epochs=6, buffer_size=3)
    base.update(kw)
    return spaceify.FLConfig(
        energy=None if energy is None else energy_mod.EnergyConfig(
            **{"battery_capacity_wh": 10.0, **energy}),
        faults=None if faults is None else _faults(faults_mod, **faults),
        **base)


def _hw(mod):
    fast = mod.HardwareProfile(name="fast", epoch_time_s=50.0,
                               downlink_rate_bps=8e9, uplink_rate_bps=8e9,
                               isl_rate_bps=8e9)
    slow = dataclasses.replace(fast, name="slowradio", epoch_time_s=80.0,
                               downlink_rate_bps=2e9, uplink_rate_bps=2e9,
                               isl_rate_bps=2e9)
    return tuple(fast if k % 2 == 0 else slow for k in range(K))


@pytest.fixture(scope="module")
def world():
    kw = dict(horizon_s=0.8 * 86_400.0, dt_s=60.0, with_isl_pairs=True)
    return dict(
        plans=(jax_plan(2, 3, 2, **kw),
               build_contact_plan(2, 3, 2, device="cpu", **kw)),
        data=(jax_dataset("femnist", K, 32),
              make_federated_dataset("femnist", K, 32, device="cpu",
                                     random_source=JaxRandom)))


def run_both(world, engine, **scenario):
    """Build ``engine`` in both packages on the same plan, fleet and data
    (the port with the reference's draws) and run it."""
    jcls, tcls = ENGINES[engine]
    a = jcls(world["plans"][0], _hw(JH), world["data"][0],
             fl_config(JS, JEN, JF, **scenario))
    b = tcls(world["plans"][1], _hw(TH), world["data"][1],
             fl_config(TS, TEN, TF, **scenario), random_source=JaxRandom)
    return a, a.run(), b, b.run()


def assert_records_match(ra, rb):
    assert len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        dx, dy = dataclasses.asdict(x), dataclasses.asdict(y)
        assert sorted(dx) == sorted(dy)
        for f in dx:
            if f == "accuracy":
                tol = ACC_TOL if x.round < 2 else ACC_TOL_LATE
                assert abs(dx[f] - dy[f]) <= tol + 1e-12, (x.round, f,
                                                           dx[f], dy[f])
            else:
                assert dx[f] == dy[f], (x.round, f, dx[f], dy[f])


COUNTERS = ("skipped_faulted", "dropped_contacts", "corrupted_updates",
            "deadline_expired", "stragglers_carried", "retries_exhausted",
            "storm_events", "skipped_low_power", "policy_deferred")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_optional_layers_match_reference(world, engine, scenario):
    a, ra, b, rb = run_both(world, engine, **SCENARIOS[scenario])
    assert_records_match(ra, rb)
    assert a.event_stats.as_dict() == b.event_stats.as_dict()
    assert (b.energy is None) == ("energy" not in SCENARIOS[scenario])
    if b.energy is not None:
        np.testing.assert_array_equal(b.energy.soc_wh, a.energy.soc_wh)
    for p in b.global_params.values():
        assert torch.isfinite(p).all()


def test_scenarios_exercise_every_counter(world):
    """The matrix is not vacuous: across FedAvg's and AutoFLSat's
    scenarios every fault, deadline, energy and policy counter fires."""
    seen = dict.fromkeys(COUNTERS, 0)
    for name in ("storms_seu_resets", "deadline_discard_retries",
                 "drain_attack_median_retries", "drained_batteries",
                 "oracle"):
        for engine in ("fedavg", "autoflsat"):
            _, _, _, rb = run_both(world, engine, **SCENARIOS[name])
            for c in COUNTERS:
                seen[c] += sum(getattr(r, c) for r in rb)
    assert all(seen.values()), seen


@pytest.mark.parametrize("engine,faults", [
    ("fedavg", dict(poison=dict(satellites=(0, 3), scale=3.0),
                    corrupt_prob=0.5)),
    ("fedprox", dict(corrupt_prob=0.8)),
    ("fedbuff", dict(poison=dict(satellites=(1,), scale=2.0),
                     corrupt_prob=0.5)),
    ("autoflsat", dict(poison=dict(satellites=(2,), scale=3.0),
                       corrupt_prob=0.5))])
def test_params_after_payload_faults_match_reference(world, engine, faults):
    """quant_bits = 0, one round: corrupted and poisoned updates reach the
    global model as in the reference, leaf by leaf at 1e-5."""
    a, ra, b, rb = run_both(world, engine, quant_bits=0, max_rounds=1,
                            buffer_size=4, faults=faults)
    assert_records_match(ra, rb)
    assert rb[0].corrupted_updates > 0
    assert sorted(b.global_params) == sorted(a.global_params)
    for name, want in a.global_params.items():
        np.testing.assert_allclose(b.global_params[name].numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_carried_stragglers_fold_as_in_reference(world):
    """A binding deadline with ``carry``: the stragglers banked and
    folded are the reference's (count, delivery time, round, satellite),
    and the folded global parameters agree at 1e-5."""
    sc = dict(quant_bits=0, round_deadline_s=3000.0, quorum=2,
              late_policy="carry", max_rounds=4, faults=dict(drop_prob=0.4))
    a, ra, b, rb = run_both(world, "fedavg", **sc)
    assert_records_match(ra, rb)
    assert sum(r.stragglers_carried for r in rb) > 0
    assert [c[2:] for c in b._carried] == [c[2:] for c in a._carried]
    for name, want in a.global_params.items():
        np.testing.assert_allclose(b.global_params[name].numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_flystack_threads_experiment_seed_into_faults():
    """``FaultConfig(seed=None)`` inherits ``SimConfig.seed`` (as in the
    reference's tests/test_faults.py), without mutating the caller's
    config, and the run matches the reference's."""
    from repro.sim import flystack as jfs
    from repro_torch.sim import flystack as tfs

    def sim(mod, fs, flmod, seed=None):
        fl = flmod.FLConfig(model="mlp", clients_per_round=2, epochs=1,
                            batch_size=8, max_rounds=2, max_local_epochs=4,
                            faults=fs.FaultConfig(mean_up_s=4000.0,
                                                  mean_down_s=4000.0,
                                                  drop_prob=0.3, seed=seed))
        return mod.SimConfig(algorithm="fedavg", n_clusters=1,
                             sats_per_cluster=2, n_ground_stations=2,
                             dataset="femnist", model="mlp",
                             horizon_days=0.5, n_per_client=16, fl=fl,
                             seed=7)

    base = sim(tfs, TF, TS)
    port = tfs.FLySTacK(base, device="cpu", random_source=JaxRandom)
    inherited = port.run().records
    explicit = tfs.FLySTacK(sim(tfs, TF, TS, seed=7), plan=port.plan,
                            device="cpu", random_source=JaxRandom).run()
    key = [(r.t_end, r.accuracy, r.dropped_contacts, r.skipped_faulted)
           for r in inherited]
    assert key == [(r.t_end, r.accuracy, r.dropped_contacts,
                    r.skipped_faulted) for r in explicit.records]
    assert base.fl.faults.seed is None
    ref = jfs.FLySTacK(sim(jfs, JF, JS)).run().records
    assert_records_match(ref, inherited)


def test_energy_aware_entry_point_matches_reference():
    """``repro_torch.energy_aware.run`` (the counterpart of
    examples/energy_aware.py) against the same two experiments on the
    JAX package: every non-accuracy field equal (the port draws with its
    own source here, so accuracy is not compared), and the battery floor
    masks satellites."""
    from repro.sim import flystack as jfs
    from repro_torch import energy_aware
    got = energy_aware.run("cpu")
    plan = jax_plan(2, 3, 2, horizon_s=86_400, dt_s=60.0)
    fleet = JEN.mixed_fleet((JH.FLYCUBE, JH.SMALLSAT_SBAND), K)
    for label, energy in (("unlimited power", None),
                          ("battery-gated", JEN.EnergyConfig(
                              battery_capacity_wh=10.0, min_soc=0.4,
                              initial_soc=energy_aware.ENERGY.initial_soc))):
        fl = JS.FLConfig(model="mlp", clients_per_round=4, epochs=2,
                         batch_size=16, max_rounds=4, max_local_epochs=6,
                         energy=energy)
        cfg = jfs.SimConfig(algorithm="fedavg", n_clusters=2,
                            sats_per_cluster=3, n_ground_stations=2,
                            horizon_days=1.0, dataset="femnist",
                            n_per_client=32, fl=fl, fleet=fleet)
        want = jfs.FLySTacK(cfg, plan=plan).run().records
        for a, b in zip(want, got[label].records):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            assert {f: v for f, v in da.items() if f != "accuracy"} == \
                {f: v for f, v in db.items() if f != "accuracy"}
        assert len(want) == len(got[label].records) == 4
    assert got["battery-gated"].total_skipped_low_power() > 0


def test_constellation_train_entry_point():
    """``repro_torch.constellation_train``: the example's experiment
    (AutoFLSat, 10 satellites a plane, 3 ground stations, 3 days, 48
    samples a client, auto epochs 3 capped at 10, 10-bit QuAFL), its
    Table 2 power report as the example computes it with the reference's
    helpers, and one small round through ``main`` on the CPU."""
    from repro_torch import constellation_train as ct
    cfg = ct.sim_config()
    assert (cfg.algorithm, cfg.n_clusters, cfg.sats_per_cluster,
            cfg.n_ground_stations, cfg.horizon_days, cfg.dataset,
            cfg.n_per_client, cfg.epochs_mode) == \
        ("autoflsat", 4, 10, 3, 3.0, "eurosat", 48, "auto")
    assert (cfg.fl.epochs, cfg.fl.max_rounds, cfg.fl.lr,
            cfg.fl.max_local_epochs, cfg.fl.quant_bits) == (3, 12, 0.05, 10,
                                                             10)
    recs = [TS.RoundRecord(r, 1000.0 * r, 1000.0 * r + 900.0, 900.0, 10.0,
                           c, tr, 0.1, [0]) for r, c, tr in
            ((0, 30.0, 200.0), (1, 45.0, 150.0), (2, 12.0, 400.0))]
    res = type("R", (), {"records": recs})()
    total = recs[-1].t_end - recs[0].t_start
    train_frac = sum(r.train_s for r in recs) / total
    tx_frac = sum(r.comm_s for r in recs) / total
    duty = {"training": max(train_frac - 0.2 * tx_frac, 0.0),
            "training_tx": min(0.2 * tx_frac, 1.0),
            "radio_tx": 0.8 * tx_frac}
    assert ct.power_report(res) == (JH.oap_added_mw(duty),
                                    JH.power_feasible(duty,
                                                      JH.SMALLSAT_SBAND))
    ct.main(["--device", "cpu", "--clusters", "1", "--rounds", "1",
             "--dataset", "femnist"])


def test_two_attackers_diverge_as_in_reference(monkeypatch):
    """chip_smoke.py's poisoned trimmed-mean run at the quickstart
    configuration (FedAvg, 2 x 5 satellites, FEMNIST CNN, 10-bit QuAFL,
    8 rounds, drops at 0.4, no retries) with two compromised satellites,
    2 and 7, instead of its one: the trimmed mean keeps a poisoned row,
    the global model grows without bound and turns NaN, in the reference
    as in the port, in the same round. Records as in the engine matrix;
    the finiteness of the global model after every round is equal."""
    from repro.sim import flystack as jfs
    from repro_torch.sim import flystack as tfs

    def finite_after_each_round(cls, seen):
        run_round = cls.run_round

        def counted(self, r, t):
            rec = run_round(self, r, t)
            seen.append(all(bool(np.isfinite(np.asarray(p)).all())
                            for p in self.global_params.values()))
            return rec
        monkeypatch.setattr(cls, "run_round", counted)

    def sim(mod, flmod, fmod):
        fl = flmod.FLConfig(
            clients_per_round=5, epochs=2, max_rounds=8, lr=0.05,
            max_local_epochs=10, quant_bits=10, aggregator="trimmed_mean",
            max_retries=0, faults=fmod.FaultConfig(
                poison=fmod.PoisonAttack(satellites=(2, 7), scale=3.0),
                drop_prob=0.4, seed=5))
        return mod.SimConfig(algorithm="fedavg", n_clusters=2,
                             sats_per_cluster=5, n_ground_stations=3,
                             horizon_days=2.0, dataset="femnist",
                             n_per_client=32, fl=fl)

    kw = dict(horizon_s=2 * 86_400, dt_s=30.0, with_isl_pairs=True)
    ref_finite, port_finite = [], []
    finite_after_each_round(JS.FedAvgSat, ref_finite)
    finite_after_each_round(TS.FedAvgSat, port_finite)
    ref = jfs.FLySTacK(sim(jfs, JS, JF), hw=JH.SMALLSAT_SBAND,
                       plan=jax_plan(2, 5, 3, **kw)).run().records
    port = tfs.FLySTacK(sim(tfs, TS, TF), hw=TH.SMALLSAT_SBAND,
                        plan=build_contact_plan(2, 5, 3, device="cpu", **kw),
                        device="cpu", random_source=JaxRandom).run().records
    assert_records_match(ref, port)
    assert sum(r.corrupted_updates for r in port) > 0
    assert port_finite == ref_finite
    assert len(ref_finite) == 8 and ref_finite[0] and not ref_finite[-1]
