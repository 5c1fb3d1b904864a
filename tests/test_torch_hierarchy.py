"""AutoFLSat's hierarchical trainer in the port, against the JAX package,
on the CPU.

The cases of ``tests/test_hierarchy.py`` on the port; one tier-1 step
against the reference's ``vmap``'d step on different cluster batches
(the reference's state carried across with
``convert.train_state_from_numpy``); the tier-2 syncs (plain, weighted,
quantized at 8 and 10 bits) on the same state, bitwise; the policy
weights and the orbit-derived H over mixed FLyCube / S-band fleets,
exactly; the ``[hfl]`` lines of both ``launch.train`` mains; and the QuAFL
byte count and round-trip error the trainer bills the sync with.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import hierarchy as JH
from repro.core import quantize as JQ
from repro.data.tokens import synthetic_lm_batches as jax_batches
from repro.optim.optimizers import AdamWConfig as JAdamW
from repro.train import steps as JS
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.core import hierarchy as H
from repro_torch.core import quantize as TQ
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.optim.optimizers import AdamWConfig, tree_leaves, tree_map
from repro_torch.train import steps as ST

torch.set_num_threads(1)

SMALL = dict(compute_dtype="float32", vocab=256, n_layers=2, d_model=128,
             n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
CFG = dataclasses.replace(torch_smoke("qwen3-14b"), **SMALL)
JCFG = dataclasses.replace(jax_smoke("qwen3-14b"), **SMALL)
NC = 2


def _batches(n, key=0):
    return list(synthetic_lm_batches(CFG.vocab, batch=4, seq=32,
                                     n_batches=n, seed=key, device="cpu"))


def _state(seed=0, n=NC):
    return H.init_hfl_state(CFG, n, torch.Generator().manual_seed(seed),
                            device="cpu")


# ---------------------------------------------------------------------------
# the cases of tests/test_hierarchy.py
# ---------------------------------------------------------------------------


def test_identical_batches_keep_clusters_identical():
    state = _state()
    plain = tree_map(torch.clone, H.cluster_slice(state, 0))
    b = _batches(1)[0]
    state, metrics = H.make_hfl_local_step(CFG)(state, [b, b])
    p = state.params["tok_embed"]
    assert torch.equal(p[0], p[1])
    plain2, m2 = ST.make_train_step(CFG)(plain, b)
    # the tier-1 step on one cluster is make_train_step on that cluster
    for a, c in zip(tree_leaves(plain2), tree_leaves(H.cluster_slice(
            state, 0))):
        assert torch.equal(a, c)
    assert torch.equal(metrics["loss"][0], m2["loss"])


def test_divergence_and_sync():
    state = _state()
    b1, b2 = _batches(2)
    state, _ = H.make_hfl_local_step(CFG)(state, [b1, b2])
    p = state.params["tok_embed"]
    assert not torch.allclose(p[0], p[1], atol=1e-6)     # diverged
    mean = 0.5 * (p[0] + p[1])
    state = H.make_cluster_sync(CFG)(state)
    p = state.params["tok_embed"]
    assert torch.equal(p[0], p[1])
    assert torch.allclose(p[0], mean, atol=1e-6)
    # the synced clusters own their storage: they diverge again
    state, _ = H.make_hfl_local_step(CFG)(state, [b2, b1])
    assert not torch.allclose(p[0], p[1], atol=1e-6)


@pytest.mark.parametrize("bits,tol", [(8, 2e-2), (12, 2e-3)])
def test_quantized_sync_error_shrinks_with_bits(bits, tol):
    state = _state()
    b1, b2 = _batches(2)
    state, _ = H.make_hfl_local_step(CFG)(state, [b1, b2])
    # the sync updates the state in place: each gets its own copy
    exact = H.make_cluster_sync(CFG)(tree_map(torch.clone, state))
    quant = H.make_cluster_sync(CFG, quant_bits=bits)(
        tree_map(torch.clone, state))
    for a, b in zip(tree_leaves(exact.params), tree_leaves(quant.params)):
        scale = float(a.abs().max()) + 1e-9
        assert float((a - b).abs().max()) / scale < tol


def test_hfl_training_converges():
    state = _state(seed=1)
    local = H.make_hfl_local_step(CFG, AdamWConfig(lr=3e-3, warmup_steps=1))
    sync = H.make_cluster_sync(CFG)
    losses = []
    bs = _batches(12, key=5)
    for i in range(12):
        # non-IID: each cluster sees its own stream
        state, m = local(state, [bs[i], bs[(i + 7) % 12]])
        losses.append(float(m["loss"].mean()))
        if (i + 1) % 3 == 0:
            state = sync(state)
    assert losses[-1] < losses[0]


def _plans(n_clusters, spc, n_gs, horizon_s):
    from repro.core.contact_plan import build_contact_plan as jplan
    from repro_torch.core.contact_plan import build_contact_plan as tplan
    kw = dict(horizon_s=horizon_s, dt_s=60.0, with_isl_pairs=True)
    return (jplan(n_clusters, spc, n_gs, **kw),
            tplan(n_clusters, spc, n_gs, device="cpu", **kw))


def test_sync_interval_from_orbits():
    from repro.sim.hardware import SMALLSAT_SBAND as JS_BAND
    from repro_torch.sim.hardware import SMALLSAT_SBAND
    jplan, tplan = _plans(2, 3, 1, 0.5 * 86400)
    h = H.sync_interval_from_orbits(tplan, SMALLSAT_SBAND, model_bytes=1e6,
                                    step_time_s=1.0)
    assert 1 <= h <= 500
    assert h == JH.sync_interval_from_orbits(jplan, JS_BAND, model_bytes=1e6,
                                             step_time_s=1.0)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _ref_hfl_state(n=NC, seed=0):
    return JH.init_hfl_state(jax.random.PRNGKey(seed), JCFG, n)


def _carry(jstate):
    return train_state_from_numpy(
        *jax.tree.map(np.asarray, (jstate.params, jstate.opt)), device="cpu")


def test_init_hfl_state_layout_matches_reference():
    jstate = _ref_hfl_state()
    tstate = _state()
    want = jax.tree_util.tree_leaves(jstate)
    got = tree_leaves(tstate)
    assert [tuple(w.shape) for w in want] == [tuple(g.shape) for g in got]
    assert [np.asarray(w).dtype for w in want] == [g.numpy().dtype
                                                   for g in got]
    for g in tree_leaves(tstate.params):                # same init a cluster
        assert torch.equal(g[0], g[1])
    abstract = H.abstract_hfl_state(CFG, NC)
    assert all(a.device.type == "meta" and a.shape == g.shape
               and a.dtype == g.dtype
               for a, g in zip(tree_leaves(abstract), got))


def test_local_step_matches_reference_vmap():
    """One tier-1 step on different cluster batches: each cluster's loss
    and grad norm within rtol 1e-5, moments within relative L2 1e-4 a
    leaf, params outside 1e-5 at most in 1e-4 of the coordinates (the
    AdamW sign flips of tests/test_torch_train.py)."""
    opt = dict(lr=1e-3, warmup_steps=2)
    jstate = _ref_hfl_state()
    tstate = _carry(jstate)
    jb = [next(jax_batches(JCFG.vocab, 4, 32, 1, seed=s)) for s in (0, 17)]
    jstate, jm = jax.jit(JH.make_hfl_local_step(JCFG, JAdamW(**opt)))(
        jstate, jax.tree.map(lambda *xs: jnp.stack(xs), *jb))
    tb = [{k: torch.tensor(np.asarray(v)) for k, v in b.items()} for b in jb]
    tstate, tm = H.make_hfl_local_step(CFG, AdamWConfig(**opt))(tstate, tb)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5)
    for w, g in zip(jax.tree_util.tree_leaves((jstate.opt["m"],
                                               jstate.opt["v"])),
                    tree_leaves((tstate.opt["m"], tstate.opt["v"]))):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-4 * np.linalg.norm(w)
    np.testing.assert_array_equal(tstate.opt["step"].numpy(),
                                  np.asarray(jstate.opt["step"]))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jstate.params)]
    got = tree_leaves(tstate.params)
    off = sum(int(np.sum(np.abs(g.numpy() - w) > 1e-5))
              for w, g in zip(want, got))
    assert off <= 1e-4 * sum(w.size for w in want)


def _diverged(n_clusters):
    """A reference hierarchical state whose clusters all differ: every
    leaf perturbed cluster by cluster (moments kept non-negative)."""
    jstate = _ref_hfl_state(n_clusters)
    rng = np.random.default_rng(6)

    def bump(x, pos=False):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        d = rng.standard_normal(x.shape).astype(np.float32) * 0.05
        return np.abs(x + d) if pos else x + d
    params = jax.tree.map(bump, jstate.params)
    opt = {"m": jax.tree.map(bump, jstate.opt["m"]),
           "v": jax.tree.map(lambda x: bump(x, True), jstate.opt["v"]),
           "step": np.asarray(jstate.opt["step"])}
    return params, opt


@pytest.mark.parametrize("n_clusters", [2, 3])
@pytest.mark.parametrize("bits", [0, 8, 10])
@pytest.mark.parametrize("weighted", [False, True])
def test_cluster_sync_bitwise_equal_to_reference(n_clusters, bits,
                                                 weighted):
    """Against the reference's sync as written, op by op. Under
    ``jax.jit`` XLA rewrites its divisions into multiplies by a reciprocal
    (1 ulp off, and at 10 bits a value near a half step then rounds to
    the other level), so the jitted reference is not the bar."""
    params, opt = _diverged(n_clusters)
    w = (np.array([0.5, 1.5, 1.0][:n_clusters]) if weighted else None)
    jsync = JH.make_cluster_sync(JCFG, quant_bits=bits, cluster_weights=w)
    jout = jsync(JS.TrainState(
        params=jax.tree.map(jnp.asarray, params),
        opt=jax.tree.map(jnp.asarray, opt)))
    tout = H.make_cluster_sync(CFG, quant_bits=bits, cluster_weights=w)(
        train_state_from_numpy(params, opt, device="cpu"))
    for want, got in zip(jax.tree_util.tree_leaves(jout), tree_leaves(tout)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if got.dim():
            assert all(torch.equal(got[0], got[c])
                       for c in range(1, n_clusters))


def _fleets():
    from repro.sim import hardware as JHW
    from repro_torch.sim import hardware as THW
    spc = 10
    mixed = [i % 2 for i in range(2 * spc)]           # 5 + 5 a cluster
    split = [0] * spc + [1] * spc                     # a FLyCube cluster
    out = []
    for kinds in (mixed, split):
        out.append(tuple(
            m.FleetProfile.from_profiles(
                [(m.FLYCUBE, m.SMALLSAT_SBAND)[k] for k in kinds])
            for m in (JHW, THW)))
    return out


@pytest.fixture(scope="module")
def plans():
    return _plans(2, 10, 3, 86400.0)


@pytest.mark.parametrize("fleet", [0, 1])
@pytest.mark.parametrize("deadline", [float("inf"), 120.0])
def test_policy_weights_and_orbit_h_match_reference(plans, fleet, deadline):
    jplan, tplan = plans
    jf, tf = _fleets()[fleet]
    for model_bytes in (1e6, 3.2e8):
        assert H.sync_interval_from_orbits(tplan, tf, model_bytes, 1.0) == \
            JH.sync_interval_from_orbits(jplan, jf, model_bytes, 1.0)
    for policy in ("deadline_aware", "scheduled"):
        want = JH.policy_cluster_weights(jplan, jf, policy, epochs=12,
                                         round_deadline_s=deadline)
        got = H.policy_cluster_weights(tplan, tf, policy, epochs=12,
                                       round_deadline_s=deadline)
        np.testing.assert_array_equal(got, want)
    if fleet == 1:          # a slow cluster weighs less under deadline_aware
        w = H.policy_cluster_weights(tplan, tf, "deadline_aware", epochs=12,
                                     round_deadline_s=deadline)
        assert w[0] < w[1]


def test_train_mains_print_the_same_hfl_lines(capsys, monkeypatch):
    from repro.launch import train as jax_train
    from repro_torch.launch import train as torch_train
    args = ["--reduced", "--hfl", "--sync-every", "orbit", "--fleet",
            "flycube,smallsat_sband", "--policy", "deadline_aware",
            "--power-check", "--steps", "2"]
    torch_train.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    jax_train.main()
    want = capsys.readouterr().out.splitlines()
    hfl = lambda lines: [ln for ln in lines if ln.startswith("[hfl]")]
    assert len(hfl(want)) == 4
    assert hfl(got) == hfl(want)
    import json
    keys = lambda lines: sorted(json.loads(lines[-1]))
    assert keys(got) == keys(want)


def test_train_main_refuses_the_cpu_fallback():
    from repro_torch.launch import train as torch_train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("bits", [0, 8, 10])
def test_transmit_bytes_and_roundtrip_error_match_reference(bits):
    jstate = _ref_hfl_state()
    params = jax.tree.map(np.asarray, jstate.params)
    tparams = lm_params_from_numpy(params, device="cpu")
    assert TQ.transmit_bytes(tparams, bits) == \
        JQ.transmit_bytes(jstate.params, bits)
    flat = {"a": params["tok_embed"], "b": params["final_norm"]["scale"]}
    assert TQ.transmit_bytes(lm_params_from_numpy(flat, "cpu"), bits) == \
        JQ.transmit_bytes(flat, bits)
    if bits:
        for tree in (params, flat):
            got = TQ.roundtrip_error(lm_params_from_numpy(tree, "cpu"), bits)
            want = JQ.roundtrip_error(jax.tree.map(jnp.asarray, tree), bits)
            assert got == pytest.approx(want, rel=1e-6)
