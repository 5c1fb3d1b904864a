"""The port's FedProxSat (four variants) and FedBuffSat end to end against
the JAX package, through ``repro_torch.sim.flystack`` and
``repro.sim.flystack`` on the same constellation, with the reference's
random draws injected through the port's random seam (``JaxRandom`` of
``tests/test_torch_slice.py``, whose ``event_key`` replays FedBuff's
per-return key split).

Timing, selection, byte and ``clipped_updates`` fields of every
``RoundRecord`` must be equal bitwise; accuracy may differ by a couple of
test samples (ACC_TOL, see ``tests/test_torch_slice.py``)."""
import dataclasses

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
from test_torch_slice import ACC_TOL, JaxRandom

torch.set_num_threads(1)

C, SPC, GS = 2, 5, 3
SIM = dict(n_clusters=C, sats_per_cluster=SPC, n_ground_stations=GS,
           horizon_days=1.0, dataset="femnist", n_per_client=16)


def fl_kwargs(quant_bits, max_rounds, **extra):
    return dict(clients_per_round=5, epochs=2, max_rounds=max_rounds,
                lr=0.05, max_local_epochs=10, quant_bits=quant_bits,
                batch_size=16, **extra)


@pytest.fixture(scope="module")
def plans():
    kw = dict(horizon_s=86_400.0, dt_s=30.0, with_isl_pairs=True)
    return (jax_plan(C, SPC, GS, **kw),
            build_contact_plan(C, SPC, GS, device="cpu", **kw))


def run_both(plans, algorithm, fl):
    """Run ``algorithm`` with FLConfig kwargs ``fl`` on both packages;
    returns (reference SimResult, port FLySTacK, port SimResult)."""
    ref = jfs.FLySTacK(jfs.SimConfig(algorithm=algorithm,
                                     fl=JaxFLConfig(**fl), **SIM),
                       hw=JAX_SBAND, plan=plans[0])
    port = tfs.FLySTacK(tfs.SimConfig(algorithm=algorithm,
                                      fl=FLConfig(**fl), **SIM),
                        hw=SMALLSAT_SBAND, plan=plans[1], device="cpu",
                        random_source=JaxRandom)
    return ref.run(), port, port.run()


def assert_records_match(ref_res, port_res, n_rounds):
    assert len(port_res.records) == len(ref_res.records) == n_rounds
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


@pytest.mark.parametrize("algorithm", ["fedprox", "fedprox_sch",
                                       "fedprox_schv2", "fedprox_intrasl",
                                       "fedbuff"])
def test_engine_matches_reference(plans, algorithm):
    """Two rounds (two buffer flushes for FedBuff) with 10-bit QuAFL."""
    ref_res, _, port_res = run_both(plans, algorithm, fl_kwargs(10, 2))
    assert_records_match(ref_res, port_res, 2)


@pytest.mark.parametrize("algorithm", ["fedprox", "fedbuff"])
def test_unquantized_params_match_reference(plans, algorithm):
    """quant_bits=0, one round (one flush): the global parameters agree
    leaf by leaf at rtol/atol 1e-5 (float32 training, rounding order
    aside). The reference engine is built directly to keep its handle."""
    fl = fl_kwargs(0, 1)
    ref = jfs.FLySTacK(jfs.SimConfig(algorithm=algorithm,
                                     fl=JaxFLConfig(**fl), **SIM),
                       hw=JAX_SBAND, plan=plans[0])
    cls, over = jfs.ALGORITHMS[algorithm]
    ref_algo = cls(plans[0], JAX_SBAND, ref.dataset,
                   dataclasses.replace(JaxFLConfig(**fl), **over))
    ref_recs = ref_algo.run()
    port = tfs.FLySTacK(tfs.SimConfig(algorithm=algorithm,
                                      fl=FLConfig(**fl), **SIM),
                        hw=SMALLSAT_SBAND, plan=plans[1], device="cpu",
                        random_source=JaxRandom)
    port_recs = port.run().records
    assert len(ref_recs) == len(port_recs) == 1
    assert ref_recs[0].t_end == port_recs[0].t_end
    assert ref_recs[0].participants == port_recs[0].participants
    got = port.algo.global_params
    assert sorted(got) == sorted(ref_algo.global_params)
    for name, want in ref_algo.global_params.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
