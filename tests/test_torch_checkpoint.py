"""The port's checkpoints against the JAX package's, on the CPU.

Either package restores what the other writes, leaf for leaf (a
``TrainState`` and a hierarchical state with its clusters axis), under the
same ``.npz`` keys; and the port keeps the reference's durability rules:
atomic writes, per-leaf CRC32, legacy files without CRCs, the ``.npz``
suffix rule, shape and missing-leaf checks (the cases of
``tests/test_checkpoint.py``).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.configs import get_smoke_config as jax_smoke
from repro.core import hierarchy as JH
from repro.train import steps as JS
from repro_torch.checkpoint import checkpoint as TC
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import hierarchy as TH
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train import steps as TS

SMALL = dict(compute_dtype="float32", n_layers=2, d_model=64, n_heads=2,
             n_kv_heads=2, head_dim=32, d_ff=128, vocab=128)


def _cfgs(arch="qwen3-14b"):
    over = SMALL if arch == "qwen3-14b" else dict(compute_dtype="float32")
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(torch_smoke(arch), **over))


def _jax_state(cfg, n_clusters=0):
    if n_clusters:
        return JH.init_hfl_state(jax.random.PRNGKey(0), cfg, n_clusters)
    return JS.init_train_state(jax.random.PRNGKey(0), cfg)


def _perturbed(state):
    """The state with distinct values in every leaf (moments and step
    included), so a leaf restored under a wrong key shows."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    rng = np.random.default_rng(4)
    out = [np.asarray(x) + rng.integers(1, 9, np.shape(x)).astype(
        np.asarray(x).dtype) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x)
                                                  for x in out])


@pytest.mark.parametrize("arch,n_clusters", [("qwen3-14b", 0),
                                             ("mamba2-1.3b", 0),
                                             ("qwen3-14b", 2)])
def test_reference_writes_port_restores(tmp_path, arch, n_clusters):
    jcfg, tcfg = _cfgs(arch)
    state = _perturbed(_jax_state(jcfg, n_clusters))
    path = JC.save_pytree(tmp_path / "ref", state, extra_meta={"step": 7})
    template = (TH.abstract_hfl_state(tcfg, n_clusters) if n_clusters
                else TS.init_train_state(tcfg, torch.Generator(), "cpu"))
    back = TC.restore_pytree(path, template, device="cpu")
    assert isinstance(back, TS.TrainState)
    want = jax.tree_util.tree_leaves(state)
    got = tree_leaves(back)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert back.opt["step"].dtype == torch.int32
    assert int(TC.load_meta(path)["step"]) == 7


@pytest.mark.parametrize("n_clusters", [0, 2])
def test_port_writes_reference_restores(tmp_path, n_clusters):
    jcfg, _ = _cfgs()
    state = _perturbed(_jax_state(jcfg, n_clusters))
    tstate = train_state_from_numpy(
        *jax.tree.map(np.asarray, (state.params, state.opt)), device="cpu")
    path = TC.save_pytree(tmp_path / "port.npz", tstate,
                          extra_meta={"steps": 3})
    ref_path = JC.save_pytree(tmp_path / "ref.npz", state,
                              extra_meta={"steps": 3})
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)     # same keys, CRCs too
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    back = JC.restore_pytree(path, jax.eval_shape(lambda: state))
    for w, g in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_restore_on_the_card_raises_without_one(tmp_path):
    path = TC.save_pytree(tmp_path / "c", {"w": torch.zeros(2)})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TC.restore_pytree(path, {"w": torch.zeros(2)})


def test_shape_mismatch_rejected(tmp_path):
    p = TC.save_pytree(tmp_path / "ckpt.npz", {"w": torch.zeros((3, 3))})
    with pytest.raises(ValueError):
        TC.restore_pytree(p, {"w": torch.zeros((4, 3))}, device="cpu")


def test_missing_leaf_rejected(tmp_path):
    p = TC.save_pytree(tmp_path / "ckpt.npz", {"a": torch.zeros((2,))})
    with pytest.raises(KeyError):
        TC.restore_pytree(p, {"a": torch.zeros((2,)), "b": torch.zeros((2,))},
                          device="cpu")


def test_save_is_atomic_and_leaves_no_temp_files(tmp_path):
    p = tmp_path / "ckpt.npz"
    TC.save_pytree(p, {"w": torch.ones((4,))})
    TC.save_pytree(p, {"w": torch.full((4,), 2.0)})   # overwrite in place
    assert sorted(f.name for f in tmp_path.iterdir()) == ["ckpt.npz"]
    back = TC.restore_pytree(p, {"w": torch.zeros((4,))}, device="cpu")
    np.testing.assert_array_equal(back["w"].numpy(), 2.0)


def test_suffix_appended_like_np_savez(tmp_path):
    out = TC.save_pytree(tmp_path / "ckpt", {"w": torch.zeros((2,))})
    assert out.name == "ckpt.npz" and out.exists()
    assert JC.save_pytree(tmp_path / "ref", {"w": jnp.zeros((2,))}).name \
        == "ref.npz"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_crc_mismatch_raises(tmp_path, writer):
    p = tmp_path / "ckpt.npz"
    if writer == "port":
        TC.save_pytree(p, {"w": torch.arange(8, dtype=torch.float32)})
    else:
        JC.save_pytree(p, {"w": jnp.arange(8, dtype=jnp.float32)})
    data = dict(np.load(p, allow_pickle=False))
    assert "__meta__/crc/w" in data                # CRCs are stored
    bad = data["w"].copy()
    bad[3] += 1.0                                  # the silent corruption
    data["w"] = bad
    np.savez(p, **data)                            # re-pack, stale CRC
    with pytest.raises(TC.ChecksumError):
        TC.restore_pytree(p, {"w": torch.zeros((8,))}, device="cpu")


def test_legacy_checkpoint_without_crc_restores(tmp_path):
    p = tmp_path / "ckpt.npz"
    np.savez(p, w=np.ones((3,), np.float32))
    back = TC.restore_pytree(p, {"w": torch.zeros((3,))}, device="cpu")
    np.testing.assert_array_equal(back["w"].numpy(), 1.0)


@pytest.mark.parametrize("world", ["gloo", "fake"])
def test_restore_onto_a_one_rank_mesh(tmp_path, world):
    """``restore_pytree(..., mesh=, placements=)`` (the reference's
    ``shardings=``): every leaf a DTensor with the HFL placements on a
    one-rank (pod, data, model) mesh, its local shard equal to the plain
    restore."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import named
    _, cfg = _cfgs()
    state = TH.init_hfl_state(cfg, 2, torch.Generator().manual_seed(0),
                              device="cpu")
    path = TC.save_pytree(tmp_path / "hfl", state)
    template = TH.abstract_hfl_state(cfg, 2)
    plain = TC.restore_pytree(path, template, device="cpu")
    with (_gloo_world() if world == "gloo" else fake_world(1)):
        mesh = make_local_mesh(1, 1, pod=1, device_type="cpu")
        pls = named(mesh, TH.hfl_state_specs(cfg, mesh))
        back = TC.restore_pytree(path, template, device="cpu", mesh=mesh,
                                 placements=pls)
        leaves = tree_leaves(back)
        assert len(leaves) == len(tree_leaves(plain))
        for a, b in zip(leaves, tree_leaves(plain)):
            assert a.device_mesh is mesh
            assert torch.equal(a.to_local(), b)
        # the mesh dims have size 1: every placement replicates
        assert {p.is_replicate() for a in leaves for p in a.placements} \
            == {True}


@contextlib.contextmanager
def _gloo_world():
    """This process as the one rank of a gloo process group."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
