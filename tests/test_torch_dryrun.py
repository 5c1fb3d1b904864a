"""The port's dry run (``repro_torch.launch.dryrun``) and its op-trace
analyzer against the JAX package's ``launch/dryrun.py`` and
``launch/hlo_analysis.py``: analyzer units mirroring
``tests/test_dryrun_small.py``, the reference's three small-mesh cases on
a (4, 2) fake mesh, the hierarchical mode's collectives by mesh dim, the
one-rank dry run against the same step on real CPU tensors, the model
FLOPs and skip rules, abstract params and input specs, and the kernel
wrappers' refusal of tensors without storage."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import dryrun as JD
from repro.launch import specs as JS
from repro.launch.hlo_analysis import CollectiveStat as JCollectiveStat
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, \
    get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as K4
from repro_torch.kernels import swa_attention as K5
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.op_analysis import COLLECTIVE_KINDS, \
    CollectiveStat, OpAnalyzer
from repro_torch.models import model as M
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.sharding.partition import map_with_path
from repro_torch.train import steps as ST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# analyzer units
# ---------------------------------------------------------------------------


def test_analyzer_bills_each_matmul():
    a = torch.ones(4, 4)
    with OpAnalyzer("cpu") as an:
        for _ in range(5):
            a = a @ a
    # 2 * 4 * 4 * 4 = 128 flops a product, 5 products (the reference's
    # while loop of 5 trips; here the loop is Python, so it is unrolled)
    st = an.stats()
    assert st.matmul_flops == pytest.approx(640.0)
    assert st.flops == pytest.approx(640.0)
    assert st.bytes == 5 * 64 and st.n_collectives == 0
    # a convolution: 2 x output elements x (C_in x kernel) = 2 x 144 x 27
    with OpAnalyzer("cpu") as an:
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                                   torch.ones(4, 3, 3, 3))
    assert an.stats().matmul_flops == 2 * 4 * 6 * 6 * 27


def test_analyzer_counts_peak_of_live_storages():
    x = torch.ones(100)                                # 400 B, tracked
    with OpAnalyzer("cpu") as an:
        an.track([x])
        y = x + 1                                      # 800 B live
        v = y.view(10, 10)                             # a view: free
        del y
        z = v * 2                                      # 1200 B live
        del v, z
        w = x * 3                                      # 800 B live
    st = an.stats()
    assert st.peak_bytes == 1200
    assert st.flops == 300                             # three pointwise ops
    assert st.bytes == 1200                            # views bill nothing
    del w


def test_analyzer_collectives_link_bytes_and_mesh_dims():
    with D.fake_world(4):
        mesh = make_local_mesh(2, 2, device_type="cpu")
        with OpAnalyzer("meta", mesh) as an:
            funcol.all_gather_single(torch.empty(4, 8, device="meta"), 0,
                                     (mesh, 0))
        st = an.stats()
        # all-gather out 8*8*4 B = 256 B over a group of 2: ring 256 / 2
        assert st.collective_bytes == {"all-gather": 256.0}
        assert st.collective_link_bytes == pytest.approx(128.0)
        assert st.collectives_by_dim == {"data": 1}
        mesh = make_local_mesh(4, 1, device_type="cpu")
        with OpAnalyzer("meta", mesh) as an:
            funcol.all_reduce(torch.empty(8, device="meta"), "sum",
                              (mesh, 0))
        st = an.stats()
        # all-reduce 32 B over a group of 4: 2 * 32 * 3 / 4 = 48
        assert st.n_collectives == 1
        assert st.collective_link_bytes == pytest.approx(48.0)


@pytest.mark.parametrize("kind", COLLECTIVE_KINDS)
def test_link_bytes_equal_reference_ring_model(kind):
    for n in range(1, 17):
        for b in (0, 1, 48, 4096, 123457):
            assert CollectiveStat(kind, b, n).link_bytes == \
                JCollectiveStat(kind, b, n).link_bytes, (kind, n, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_should_skip_equal_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in INPUT_SHAPES:
        assert D.model_flops(cfg, INPUT_SHAPES[name]) == \
            JD.model_flops(jcfg, J_SHAPES[name])
        assert D.should_skip(cfg, INPUT_SHAPES[name]) == \
            JD.should_skip(jcfg, J_SHAPES[name])


# ---------------------------------------------------------------------------
# abstract params and input specs
# ---------------------------------------------------------------------------


def _shapes(tree, jax_tree=False):
    out = {}
    if jax_tree:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, leaf in flat:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[key] = (tuple(leaf.shape), str(leaf.dtype))
        return out
    map_with_path(lambda path, t: out.__setitem__(
        "/".join(str(k) for k in path),
        (tuple(t.shape), str(t.dtype).replace("torch.", ""))), tree)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_input_specs_equal_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    params = M.abstract_params(cfg)
    assert all(t.is_meta for t in tree_leaves(params))
    assert _shapes(params) == _shapes(JM.abstract_params(jcfg), True)
    for name in INPUT_SHAPES:
        assert _shapes(S.input_specs(cfg, INPUT_SHAPES[name])) == \
            _shapes(JS.input_specs(jcfg, J_SHAPES[name]), True), name


def test_concrete_inputs_labels_are_tokens_rolled():
    cfg = get_smoke_config("phi-3-vision-4.2b")
    shape = InputShape("t", 16, 3, "train")
    b = S.concrete_inputs(cfg, shape, torch.Generator().manual_seed(0),
                          device="cpu")["batch"]
    assert b["tokens"].dtype == torch.int32
    assert b["tokens"].shape == (3, 16)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < cfg.vocab
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, dims=1))
    assert b["patches"].shape == (3, cfg.vision.n_img_tokens,
                                  cfg.vision.d_vision)
    again = S.concrete_inputs(cfg, shape, torch.Generator().manual_seed(0),
                              device="cpu")["batch"]
    assert all(torch.equal(again[k], b[k]) for k in b)
    dec = S.concrete_inputs(cfg, InputShape("d", 16, 3, "decode"),
                            torch.Generator().manual_seed(0), device="cpu")
    assert dec["tokens"].shape == (3, 1) and not dec["pos"].any()


# ---------------------------------------------------------------------------
# kernel wrappers and tensors without storage
# ---------------------------------------------------------------------------


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel build or load was attempted")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("where", ["fake_cuda", "meta"])
def test_kernel_wrappers_refuse_tensors_without_storage(where, no_build):
    def args():
        dev = "cuda" if where == "fake_cuda" else "meta"
        x = torch.empty(1, 2, 8, 4, 16, device=dev)
        dt = torch.empty(1, 2, 8, 4, device=dev)
        bc = torch.empty(1, 2, 8, 1, 16, device=dev)
        q = torch.empty(1, 8, 4, 16, device=dev)
        kv = torch.empty(1, 8, 2, 16, device=dev)
        return (x, dt, torch.empty(4, device=dev), bc, bc), (q, kv, kv)
    before = (K4.launches, K5.launches)
    ctx = FakeTensorMode() if where == "fake_cuda" else \
        torch.autograd.grad_mode.no_grad()
    with ctx:
        k4, k5 = args()
        with pytest.raises(ValueError, match="no storage"):
            K4.ssd_chunk(*k4)
        with pytest.raises(ValueError, match="no storage"):
            K5.swa_attention(*k5, window=4)
    assert (K4.launches, K5.launches) == before


def test_kernel_routes_are_recorded_as_errors_in_the_dry_run():
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              ssm_impl="pallas")
    rec = D.run_one("mamba2-1.3b", InputShape("t", 64, 4, "prefill"),
                    "local", cfg=cfg, mesh_shape=(2, 2), device="cpu")
    assert rec["status"] == "error"
    assert "no storage" in rec["error"]


# ---------------------------------------------------------------------------
# dry runs
# ---------------------------------------------------------------------------

SCRIPT = r"""
import json, sys
from repro_torch.configs import get_smoke_config, InputShape
from repro_torch.launch import dryrun as D
out = {}
for name, mesh in (("mesh", (4, 2)), ("one", (1, 1))):
    rec = D.run_one("%(arch)s", InputShape("t", 128, 8, "%(kind)s"), "local",
                    cfg=get_smoke_config("%(arch)s"), mesh_shape=mesh,
                    device="cpu")
    out[name] = {k: v for k, v in rec.items() if k != "traceback"}
print(json.dumps(out))
"""

# the reference's own small-mesh case (tests/test_dryrun_small.py), with
# its HLO's dot FLOPs apart (the analysis again with dots billed 0) and
# the compiled program's peak (arguments + temporaries + outputs not
# aliased to an argument)
REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, jax
from repro.configs import get_smoke_config, InputShape
from repro.launch import hlo_analysis as HA
from repro.launch.dryrun import build_step_and_args

mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = get_smoke_config("%(arch)s")
fn, args = build_step_and_args(cfg, InputShape("t", 128, 8, "%(kind)s"), mesh)
compiled = fn.lower(*args).compile()
txt = compiled.as_text()
flops = HA.analyze_module(txt).flops
HA._dot_flops = lambda *a, **k: 0.0
mem = compiled.memory_analysis()
print(json.dumps({
    "dot_flops": flops - HA.analyze_module(txt).flops,
    "peak": mem.argument_size_in_bytes + mem.temp_size_in_bytes
            + mem.output_size_in_bytes - mem.alias_size_in_bytes}))
"""


def _last_json(script, env):
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,kind", [
    ("qwen3-14b", "train"),
    ("mixtral-8x22b", "decode"),
    ("mamba2-1.3b", "decode"),
])
def test_small_mesh_dry_run(arch, kind):
    """The reference's three small-mesh cases on a (4, 2) fake mesh, in a
    process of their own, held against the same step traced on one rank
    and against the reference's compiled program on 8 forced host
    devices (which runs here in seconds). The mesh is a ``cpu`` one: on a
    torch built without CUDA, DTensor's shape inference for some ops
    (``_softmax_backward_data``) cannot make its fake tensors of a
    ``cuda`` mesh; ``chip_smoke.py`` traces ``cuda`` on the card."""
    env = dict(os.environ, PYTHONPATH=f"{REPO}/src")
    case = {"arch": arch, "kind": kind}
    port = _last_json(SCRIPT % case, env)
    ref = _last_json(REF_SCRIPT % case, dict(env, JAX_PLATFORMS="cpu"))
    r, one = port["mesh"], port["one"]
    assert r["status"] == "ok", r.get("error")
    assert one["status"] == "ok", one.get("error")
    assert r["n_devices"] == 8
    assert r["op_flops_per_dev"] > 0
    assert r["n_collectives"] > 0          # sharded program must communicate
    assert r["mem_peak_bytes_per_dev"] >= 0
    # a rank does its eighth of the step's matmul work, at most 20% more
    # (the one-rank trace is the whole step)
    share = one["op_matmul_flops_per_dev"] / 8
    mm = r["op_matmul_flops_per_dev"]
    assert share <= mm <= 1.2 * share, (mm, share)
    # no more than the reference's partitioner gives a device: matmul
    # FLOPs within 5% of its HLO's dots (qwen3's train step is 24% under
    # them: XLA repeats part of the work), peak within 25% of its
    # compiled program's (the port's peak lies 3-15% under to 15% over)
    assert mm <= 1.05 * ref["dot_flops"], (mm, ref["dot_flops"])
    assert r["mem_peak_bytes_per_dev"] <= 1.25 * ref["peak"], \
        (r["mem_peak_bytes_per_dev"], ref["peak"])


def test_hfl_local_step_emits_no_pod_collective():
    cfg = get_smoke_config("qwen3-14b")
    rec = D.run_one("qwen3-14b", InputShape("t", 64, 8, "train"), "local",
                    cfg=cfg, mesh_shape=(2, 2, 2), device="cpu", hfl=True,
                    quant_bits=10)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_collectives"] > 0
    assert rec["collectives_by_dim"].get("pod", 0) == 0
    assert rec["sync_collectives_by_dim"].get("pod", 0) >= 1
    assert sum(rec["sync_collective_bytes_per_dev"].values()) > 0


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x22b"])
def test_one_rank_dry_run_equals_the_real_step(arch):
    """On a (1, 1) mesh the dry run's per-rank program is the step itself:
    its matmul FLOPs equal the analyzer's count of the same step on real
    CPU tensors, and its peak of live bytes is within 1%."""
    cfg = get_smoke_config(arch)
    shape = InputShape("t", 64, 4, "train")
    rec = D.run_one(arch, shape, "local", cfg=cfg, mesh_shape=(1, 1),
                    device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    state = ST.init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    batch = S.concrete_inputs(cfg, shape, torch.Generator().manual_seed(1),
                              device="cpu")["batch"]
    an = OpAnalyzer("cpu")
    an.track(tree_leaves((state, batch)))
    with an:
        out = ST.make_train_step(cfg)(state, batch)
    del out
    st = an.stats()
    assert rec["op_matmul_flops_per_dev"] == st.matmul_flops > 0
    assert abs(rec["mem_peak_bytes_per_dev"] - st.peak_bytes) \
        <= 0.01 * st.peak_bytes
    assert rec["n_collectives"] == 0


def test_main_writes_records(tmp_path, capsys):
    rc = D.main(["--arch", "qwen3-14b", "--shape", "long_500k", "--mesh",
                 "both", "--out", str(tmp_path)])
    assert rc == 0
    recs = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in recs] == [
        "qwen3-14b__long_500k__multi.json",
        "qwen3-14b__long_500k__single.json"]
    r = json.loads(recs[0].read_text())
    assert r["status"] == "skipped" and "sub-quadratic" in r["reason"]
    assert "done: ok=0 skipped=2 error=0" in capsys.readouterr().out
