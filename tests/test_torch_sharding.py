"""The port's sharding rules against the JAX package's, spec for spec: the
parameter, batch, cache, decode, train-state and HFL spec trees of every
architecture on both production meshes, with ``REPRO_SHARD_HD`` unset and
set; DTensor placements that map back to the same specs; and the
invariants of ``tests/test_sharding_rules.py`` on the port's trees."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import InputShape as JInputShape
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core import hierarchy as JH
from repro.launch import specs as JS
from repro.sharding import partition as JPT
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, \
    get_config, get_smoke_config
from repro_torch.core import hierarchy as H
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import AbstractMesh, abstract_production_mesh
from repro_torch.sharding import partition as PT


def _jax_meshes():
    # as tests/test_sharding_rules.py: one host device repeated to 512
    devs = np.array(jax.devices() * 512)[:512]
    return {"single": jax.sharding.Mesh(devs[:256].reshape(16, 16),
                                        ("data", "model")),
            "multi": jax.sharding.Mesh(devs.reshape(2, 16, 16),
                                       ("pod", "data", "model"))}


JAX_MESHES = _jax_meshes()
MESHES = {"single": abstract_production_mesh(multi_pod=False),
          "multi": abstract_production_mesh(multi_pod=True)}


def _jkey(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jflat(tree):
    """{path: spec tuple} of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(_jkey(k) for k in path): tuple(s) for path, s in flat}


def _pflat(tree):
    """{path: spec tuple} of a port spec tree."""
    out = {}
    PT.map_with_path(lambda path, s: out.__setitem__(
        "/".join(str(k) for k in path), tuple(s)), tree)
    return out


@pytest.fixture(params=[False, True], ids=["hd_unset", "hd_set"])
def shard_hd(request, monkeypatch):
    if request.param:
        monkeypatch.setenv("REPRO_SHARD_HD", "1")
    else:
        monkeypatch.delenv("REPRO_SHARD_HD", raising=False)
    return request.param


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_state_and_hfl_specs_equal_reference(arch, mesh_kind,
                                                   shard_hd):
    jm, pm = JAX_MESHES[mesh_kind], MESHES[mesh_kind]
    jcfg, cfg = jget_config(arch), get_config(arch)
    want = _jflat(JPT.param_specs(jcfg, jm))
    assert _pflat(PT.param_specs(cfg, pm)) == want
    assert _jflat(JPT.param_specs(jcfg, jm, expert_parallel=True)) == \
        _pflat(PT.param_specs(cfg, pm, expert_parallel=True))
    assert _pflat(PT.train_state_specs(cfg, pm)) == \
        _jflat(JPT.train_state_specs(jcfg, jm))
    assert _pflat(H.hfl_state_specs(cfg, pm)) == \
        _jflat(JH.hfl_state_specs(jcfg, jm))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_cache_and_hfl_batch_specs_equal_reference(arch, mesh_kind,
                                                         shard_hd):
    jm, pm = JAX_MESHES[mesh_kind], MESHES[mesh_kind]
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in ("train_4k", "prefill_32k"):
        jb = JS.input_specs(jcfg, J_SHAPES[name])["batch"]
        pb = S.input_specs(cfg, INPUT_SHAPES[name])["batch"]
        assert _pflat(PT.batch_specs(cfg, pm, pb)) == \
            _jflat(JPT.batch_specs(jcfg, jm, jb))
        jh = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            (2, s.shape[0] // 2) + s.shape[1:], s.dtype), jb)
        ph = {k: S.S((2, v.shape[0] // 2) + tuple(v.shape[1:]), v.dtype)
              for k, v in pb.items()}
        assert _pflat(H.hfl_batch_specs(cfg, pm, ph)) == \
            _jflat(JH.hfl_batch_specs(jcfg, jm, jh))
    # decode: each smoke config's cache at a batch the DP axes divide and
    # at batch 1 (the long-context rule shards the KV seq axis)
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    for b in (32, 1):
        jd = JS.decode_specs(jcfg, JInputShape("d", 256, b, "decode"))
        pd = S.decode_specs(cfg, InputShape("d", 256, b, "decode"))
        assert _pflat(PT.cache_specs(cfg, pm, pd["cache"])) == \
            _jflat(JPT.cache_specs(jcfg, jm, jd["cache"]))
        assert _pflat(PT.decode_arg_specs(cfg, pm, pd)) == \
            _jflat(JPT.decode_arg_specs(jcfg, jm, jd))


def _spec_of(mesh, placements, ndim):
    """The P that ``placements`` on ``mesh`` express (inverse of
    ``PT.placements``)."""
    entries = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return PT.P(*(None if not e else tuple(e) for e in entries))


def _at(tree, path):
    for k in path:
        tree = getattr(tree, k) if hasattr(tree, "_fields") else tree[k]
    return tree


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_named_placements_map_back_to_the_spec(arch, mesh_kind):
    mesh = MESHES[mesh_kind]
    cfg = get_config(arch)
    specs = H.hfl_state_specs(cfg, mesh) if mesh_kind == "multi" \
        else PT.train_state_specs(cfg, mesh)
    named = PT.named(mesh, specs)
    n = []

    def check(path, spec):
        pl = _at(named, path)
        assert len(pl) == len(mesh.mesh_dim_names)
        assert tuple(_spec_of(mesh, pl, 8)) == \
            tuple(spec) + (None,) * (8 - len(spec)), (path, spec, pl)
        n.append(path)
    PT.map_with_path(check, specs)
    assert len(n) > 10


def test_tuple_entry_out_of_mesh_order_raises():
    mesh = MESHES["multi"]
    assert PT.placements(mesh, PT.P(("pod", "data"), None)) == \
        PT.placements(mesh, PT.P(("pod", "data")))
    with pytest.raises(ValueError, match="mesh order"):
        PT.placements(mesh, PT.P(("data", "pod"), None))
    with pytest.raises(ValueError, match="shards two"):
        PT.placements(mesh, PT.P("data", "data"))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_structure_and_divide(arch, mesh_kind):
    cfg = get_config(arch)
    mesh = MESHES[mesh_kind]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    from repro_torch.models import model as M
    leaves, specs = {}, {}
    PT.map_with_path(lambda p, t: leaves.__setitem__(p, t),
                     M.abstract_params(cfg))
    PT.map_with_path(lambda p, s: specs.__setitem__(p, s),
                     PT.param_specs(cfg, mesh))
    assert leaves.keys() == specs.keys()
    for path, leaf in leaves.items():
        spec = specs[path]
        assert len(spec) <= leaf.dim(), (path, spec, leaf.shape)
        for dim, ax in zip(leaf.shape, tuple(spec)):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
            assert dim % n == 0, (path, spec, leaf.shape)


@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-small"])
def test_hd_dim_never_sharded(arch, monkeypatch):
    """40/12 heads are indivisible by 16: heads replicate, and hd never
    shards (a sharded contraction all-reduces full score tensors)."""
    monkeypatch.delenv("REPRO_SHARD_HD", raising=False)
    specs = PT.param_specs(get_config(arch), MESHES["single"])
    seen = []

    def check(path, spec):
        names = PT._path_names(path)
        if names[-1] in ("wq", "wk", "wv"):
            assert spec[-1] is None, (names, spec)     # hd dim
            assert spec[-2] is None, (names, spec)     # heads indivisible
            seen.append(names)
    PT.map_with_path(check, specs)
    assert seen


def test_batch_specs_shard_over_dp_axes():
    cfg = get_config("qwen2-72b")
    batch = {"tokens": S.S((256, 128), torch.int32)}
    assert PT.batch_specs(cfg, MESHES["single"], batch)["tokens"] == \
        PT.P(("data",), None)
    assert PT.batch_specs(cfg, MESHES["multi"], batch)["tokens"] == \
        PT.P(("pod", "data"), None)
    assert tuple(PT.P(("data",), None)) == tuple(JP(("data",), None))


def test_mesh_dims_of_size_one_replicate():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((1, 4, 1), ("pod", "data", "model"))
    assert PT.placements(mesh, PT.P("pod", ("data", "model"))) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="shards two"):
        PT.placements(mesh, PT.P("pod", "pod"))


def test_abstract_mesh_checks_its_names():
    assert AbstractMesh((2, 16, 16), ("pod", "data", "model")).size() == 512
    with pytest.raises(ValueError):
        AbstractMesh((2, 16), ("pod", "data", "model"))
