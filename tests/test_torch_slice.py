"""The port's first slice end to end against the JAX package: FedAvgSat,
FedAvgSch and AutoFLSat with 10-bit QuAFL through ``repro_torch.sim.
flystack`` and ``repro.sim.flystack``, on the same constellation, with the
reference's random draws injected through the port's random seam.

Timing, selection and byte fields of every ``RoundRecord`` must be equal
bitwise; accuracy may differ by a couple of test samples (see ACC_TOL)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.contact_plan import build_contact_plan as jax_plan
from repro.core.spaceify import FLConfig as JaxFLConfig
from repro.sim import flystack as jfs
from repro.sim.hardware import SMALLSAT_SBAND as JAX_SBAND
from repro_torch.core.contact_plan import build_contact_plan
from repro_torch.core.spaceify import FLConfig
from repro_torch.sim import flystack as tfs
from repro_torch.sim.hardware import SMALLSAT_SBAND

torch.set_num_threads(1)

C, SPC, GS = 2, 5, 3

# Accuracy is a count over the 512 test samples. The port trains the same
# model on the same data, keys and minibatch order, but its convolutions
# and reductions round in another order than XLA's (|dlogit| ~1e-6 after
# training); a test sample whose top two logits are that close can flip,
# so a round's accuracy may move by a couple of samples.
ACC_TOL = 2 / 512


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxRandom:
    """The port's random seam backed by ``jax.random``: replays the key
    stream of the JAX package for one seed, draw site by draw site."""

    def __init__(self, seed):
        key = jax.random.PRNGKey(seed)
        # engine: spaceify.py ``self.key, init_key = split(PRNGKey(seed))``
        self.key, self.init_key = jax.random.split(key)
        # dataset: synthetic.py ``km, kl, kx, kt, ky = split(key, 5)``
        km, self.kl, self.kx, self.kt, self.ky = jax.random.split(key, 5)
        self.kf, self.kp = jax.random.split(km)

    def class_prototypes(self, n_classes, channels):
        shape = (n_classes, 4, channels)
        return (_t(jax.random.normal(self.kf, shape)),
                _t(jax.random.uniform(self.kp, shape)))

    def label_mix(self, n_clients, n_classes, alpha):
        kp, _ = jax.random.split(self.kl)
        return _t(jax.random.dirichlet(kp, jnp.full((n_classes,), alpha),
                                       (n_clients,)))

    def client_labels(self, probs, n_per_client):
        _, ks = jax.random.split(self.kl)
        keys = jax.random.split(ks, probs.shape[0])
        n_classes = probs.shape[1]
        draw = jax.vmap(lambda k, p: jax.random.choice(
            k, n_classes, (n_per_client,), p=p))
        return _t(draw(keys, jnp.asarray(probs.numpy())).astype(jnp.int32))

    def train_noise(self, shape):
        return _t(jax.random.normal(self.kx, tuple(shape)))

    def test_labels(self, n_test, n_classes):
        return _t(jax.random.randint(self.ky, (n_test,), 0, n_classes,
                                     dtype=jnp.int32))

    def test_noise(self, shape):
        return _t(jax.random.normal(self.kt, tuple(shape)))

    def init_normals(self, shapes):
        ks = jax.random.split(self.init_key, len(shapes))
        return [_t(jax.random.normal(k, tuple(s))) for k, s in zip(ks, shapes)]

    def round_keys(self, m):
        ks = jax.random.split(self.key, m + 1)
        self.key = ks[0]
        return [ks[i] for i in range(1, m + 1)]

    def event_key(self):
        # FedBuff: ``self.key, sub = split(self.key)`` per client return
        self.key, sub = jax.random.split(self.key)
        return sub

    def permutations(self, key, n, n_epochs):
        out, k = [], key
        for _ in range(n_epochs):
            k, sub = jax.random.split(k)
            out.append(np.asarray(jax.random.permutation(sub, n)))
        return torch.from_numpy(np.stack(out).astype(np.int64)) if out \
            else torch.empty((0, n), dtype=torch.int64)


@pytest.fixture(scope="module")
def plans():
    kw = dict(horizon_s=86_400.0, dt_s=30.0, with_isl_pairs=True)
    return (jax_plan(C, SPC, GS, **kw),
            build_contact_plan(C, SPC, GS, device="cpu", **kw))


def _run_both(plans, algorithm, quant_bits, max_rounds):
    fl = dict(clients_per_round=5, epochs=2, max_rounds=max_rounds, lr=0.05,
              max_local_epochs=10, quant_bits=quant_bits, batch_size=16)
    sim = dict(algorithm=algorithm, n_clusters=C, sats_per_cluster=SPC,
               n_ground_stations=GS, horizon_days=1.0, dataset="femnist",
               n_per_client=16)
    ref = jfs.FLySTacK(jfs.SimConfig(fl=JaxFLConfig(**fl), **sim),
                       hw=JAX_SBAND, plan=plans[0])
    port = tfs.FLySTacK(tfs.SimConfig(fl=FLConfig(**fl), **sim),
                        hw=SMALLSAT_SBAND, plan=plans[1], device="cpu",
                        random_source=JaxRandom)
    return ref, ref.run(), port, port.run()


_EXACT = ("round", "t_start", "t_end", "duration_s", "idle_s", "comm_s",
          "train_s", "participants", "epochs", "comm_s_by_sat")


@pytest.mark.parametrize("algorithm", ["fedavg", "fedavg_sch",
                                       "fedavg_intrasl", "autoflsat"])
def test_slice_matches_reference(plans, algorithm):
    ref, ref_res, port, port_res = _run_both(plans, algorithm, 10, 2)
    assert len(port_res.records) == len(ref_res.records) == 2
    for a, b in zip(ref_res.records, port_res.records):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for f in da:
            if f == "accuracy":
                assert abs(da[f] - db[f]) <= ACC_TOL + 1e-12, (f, da[f], db[f])
            else:
                assert da[f] == db[f], (f, da[f], db[f])
    s_ref, s_port = ref_res.summary(), port_res.summary()
    for k in s_ref:
        if "acc" not in k:
            assert s_ref[k] == s_port[k], k


def test_fedavg_unquantized_params_match_reference(plans):
    """quant_bits=0, one FedAvg round: the global parameters agree leaf by
    leaf at rtol/atol 1e-5 (float32 training, rounding order aside)."""
    fl = dict(clients_per_round=5, epochs=2, max_rounds=1, lr=0.05,
              max_local_epochs=10, quant_bits=0, batch_size=16)
    sim = dict(algorithm="fedavg", n_clusters=C, sats_per_cluster=SPC,
               n_ground_stations=GS, horizon_days=1.0, dataset="femnist",
               n_per_client=16)
    ref = jfs.FLySTacK(jfs.SimConfig(fl=JaxFLConfig(**fl), **sim),
                       hw=JAX_SBAND, plan=plans[0])
    ref_algo = jfs.ALGORITHMS["fedavg"][0](plans[0], JAX_SBAND, ref.dataset,
                                           JaxFLConfig(**fl))
    ref_recs = ref_algo.run()
    port = tfs.FLySTacK(tfs.SimConfig(fl=FLConfig(**fl), **sim),
                        hw=SMALLSAT_SBAND, plan=plans[1], device="cpu",
                        random_source=JaxRandom)
    port_recs = port.run().records
    assert [r.participants for r in ref_recs] == \
        [r.participants for r in port_recs]
    got = port.algo.global_params
    assert sorted(got) == sorted(ref_algo.global_params)
    for name, want in ref_algo.global_params.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_dataset_matches_reference_given_its_draws():
    from repro.data.synthetic import make_federated_dataset as jax_ds
    from repro_torch.data.synthetic import make_federated_dataset
    want = jax_ds("femnist", 10, 16, seed=3)
    got = make_federated_dataset("femnist", 10, 16, seed=3, device="cpu",
                                 random_source=JaxRandom)
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.y_test.numpy(), np.asarray(want.y_test))
    # class prototypes are sums of float32 sines of linspace grids, which
    # torch and XLA round differently in the last bit
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)
    np.testing.assert_allclose(got.x_test.numpy(), np.asarray(want.x_test),
                               atol=1e-5)
    assert got.n_classes == want.n_classes == 62


def test_default_source_dataset_is_seeded_and_skewed():
    from repro_torch.data.synthetic import make_federated_dataset
    a = make_federated_dataset("femnist", 10, 64, seed=1, device="cpu")
    b = make_federated_dataset("femnist", 10, 64, seed=1, device="cpu")
    c = make_federated_dataset("femnist", 10, 64, seed=2, device="cpu")
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert not torch.equal(a.y, c.y)
    assert a.x.shape == (10, 64, 28, 28, 1) and a.y.dtype == torch.int64
    assert a.x_test.shape == (512, 28, 28, 1)
    assert int(a.y.min()) >= 0 and int(a.y.max()) < 62
    # Dirichlet(0.5) skew: each client holds few of the 62 classes
    n_cls = [len(torch.unique(row)) for row in a.y]
    assert max(n_cls) < 40


def test_port_refuses_what_it_does_not_have(plans):
    """Every engine of ``ALGORITHMS`` constructs under every aggregator and
    with the optional layers on (energy, faults, a finite deadline,
    max_retries); the reference's configuration errors raise its
    ``ValueError``s (an energy-drain attack without energy, a bad
    late_policy, max_retries < 0, round_deadline_s <= 0, quorum < 1), and
    so does a kernel route other than 'auto'."""
    from repro_torch.core.aggregation import ROBUST_AGGREGATORS
    from repro_torch.core.spaceify import ALGORITHMS, FedAvgSat
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.sim.energy import EnergyConfig
    from repro_torch.sim.faults import EnergyDrainAttack, FaultConfig
    ds = make_federated_dataset("femnist", 10, 16, device="cpu")
    for alg, (cls, over) in ALGORITHMS.items():
        for agg in (None, "mean", *ROBUST_AGGREGATORS):
            eng = cls(plans[1], SMALLSAT_SBAND, ds,
                      dataclasses.replace(FLConfig(batch_size=16,
                                                   aggregator=agg), **over))
            assert eng.name == alg.split("_")[0]
            assert (eng.aggregator is None) == (agg in (None, "mean"))
        eng = cls(plans[1], SMALLSAT_SBAND, ds, dataclasses.replace(
            FLConfig(batch_size=16, energy=EnergyConfig(),
                     faults=FaultConfig(attack=EnergyDrainAttack()),
                     round_deadline_s=3600.0, max_retries=2), **over))
        assert eng.energy is not None and eng.faults is not None
        assert eng._deadline_on
    for bad, match in ((dict(faults=FaultConfig(attack=EnergyDrainAttack())),
                        "requires FLConfig.energy"),
                       (dict(late_policy="queue"), "late_policy"),
                       (dict(max_retries=-1), "max_retries"),
                       (dict(round_deadline_s=0.0), "round_deadline_s"),
                       (dict(round_deadline_s=-5.0), "round_deadline_s"),
                       (dict(quorum=0), "quorum")):
        for cls, over in ALGORITHMS.values():
            with pytest.raises(ValueError, match=match):
                cls(plans[1], SMALLSAT_SBAND, ds,
                    dataclasses.replace(FLConfig(batch_size=16, **bad),
                                        **over))
    with pytest.raises(ValueError, match="auto"):
        FedAvgSat(plans[1], SMALLSAT_SBAND, ds,
                  FLConfig(batch_size=16, quant_kernel="pallas"))
    with pytest.raises(ValueError, match="unknown aggregator"):
        FedAvgSat(plans[1], SMALLSAT_SBAND, ds,
                  FLConfig(batch_size=16, aggregator="huber"))
    assert len(ALGORITHMS) == 8


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.data.synthetic import make_federated_dataset
    with pytest.raises(RuntimeError, match="cuda"):
        make_federated_dataset("femnist", 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tfs.FLySTacK(tfs.SimConfig(n_clusters=1, sats_per_cluster=2,
                                   horizon_days=0.01))
