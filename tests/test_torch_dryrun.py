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
sys.path.insert(0, os.path.join(REPO, "tools"))

import dryrun_small as DS  # noqa: E402

with open(os.path.join(REPO, "tests", "dryrun_reference.json")) as f:
    YARDSTICK = json.load(f)

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
# the kernel ops on tensors without storage, and their billing
# ---------------------------------------------------------------------------


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel build or load was attempted")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("where", ["fake_cuda", "meta"])
def test_kernel_ops_give_shapes_without_storage(where, no_build):
    """Meta tensors, and fake ``cuda`` ones, get the outputs' shapes and
    types from the ops' fake implementations: nothing is built or
    launched, and the analyzer bills each op by its formula."""
    def args():
        dev = "cuda" if where == "fake_cuda" else "meta"
        x = torch.empty(1, 2, 8, 4, 16, device=dev)
        dt = torch.empty(1, 2, 8, 4, device=dev)
        bc = torch.empty(1, 2, 8, 1, 12, device=dev)
        q = torch.empty(1, 8, 4, 16, device=dev, dtype=torch.bfloat16)
        kv = torch.empty(1, 8, 2, 16, device=dev, dtype=torch.bfloat16)
        return (x, dt, torch.empty(4, device=dev), bc, bc), (q, kv, kv)
    before = (K4.launches, K5.launches)
    ctx = FakeTensorMode() if where == "fake_cuda" else \
        torch.autograd.grad_mode.no_grad()
    with ctx:
        k4, k5 = args()
        y, st = K4.ssd_chunk(*k4)
        o = K5.swa_attention(*k5, window=4)
    assert y.shape == (1, 2, 8, 4, 16) and st.shape == (1, 2, 4, 16, 12)
    assert y.dtype == st.dtype == torch.float32
    assert o.shape == (1, 8, 4, 16) and o.dtype == torch.bfloat16
    assert {t.device.type for t in (y, st, o)} == \
        {"cuda" if where == "fake_cuda" else "meta"}
    assert (K4.launches, K5.launches) == before
    if where == "meta":
        with OpAnalyzer("meta") as an:
            K4.ssd_chunk(*k4)
            K5.swa_attention(*k5, window=4)
        st = an.stats()
        assert st.kernel_calls == {"repro_torch::ssd_chunk": 1,
                                   "repro_torch::swa_attention": 1}
        assert st.kernel_flops["repro_torch::ssd_chunk"] == \
            K4.chunk_flops(k4[0], k4[3])
        # one 8-row block: q·kᵀ and p·v over 1 x 4 heads, 2·8·8·16 each
        assert st.kernel_flops["repro_torch::swa_attention"] == \
            4 * 4 * 8 * 8 * 16


@pytest.mark.parametrize("b,nc,c,h,p,g,n", [
    (2, 3, 16, 4, 8, 1, 12), (1, 2, 32, 6, 16, 2, 8), (4, 4, 256, 64, 64,
                                                        1, 128)])
def test_k4_billing_equals_plain_products(b, nc, c, h, p, g, n):
    """K4 is billed the matmul FLOPs that the analyzer counts for
    ``ssd_chunk_plain``'s products at the same shape."""
    def m(*shape):
        return torch.empty(*shape, device="meta")
    args = (m(b, nc, c, h, p), m(b, nc, c, h), m(h), m(b, nc, c, g, n),
            m(b, nc, c, g, n))
    with OpAnalyzer("meta") as an:
        K4.ssd_chunk_plain(*args)
    assert K4.chunk_flops(args[0], args[3]) == an.stats().matmul_flops > 0


def _reference_visits(l, window, causal, block):
    """(q block, k block) pairs whose ``_compute`` the JAX package's K5
    kernel runs: its kernel body driven over the grid with ``pl`` swapped
    for a stand-in whose ``when`` records the guard of ``_compute``."""
    import types
    from repro.kernels import swa_attention as JK5
    bq = min(block, l)
    n = l // bq
    ids = {}
    seen = []

    def when(cond):
        def deco(body):
            if body.__name__ == "_compute" and bool(cond):
                seen.append((ids[1], ids[2]))
        return deco
    stub = types.SimpleNamespace(program_id=lambda a: ids[a], when=when)
    real = JK5.pl
    JK5.pl = stub
    try:
        for qi in range(n):
            for ki in range(n):
                ids.update({0: 0, 1: qi, 2: ki})
                JK5._swa_fwd_kernel(None, None, None, None, None, None, None,
                                    bq=bq, bk=bq, window=window,
                                    causal=causal, n_kv=n)
    finally:
        JK5.pl = real
    return len(seen)


@pytest.mark.parametrize("l,window,causal", [
    (1024, 0, True), (1024, 300, True), (2048, 128, True), (512, 0, False),
    (768, 200, False), (128, 0, True), (64, 16, True)])
def test_k5_block_count_equals_reference_grid(l, window, causal):
    """The dry run bills K5 by the block pairs that the reference kernel's
    ``pl.when`` computes, not the l x l square."""
    got = K5.visited_blocks(l, window, causal)
    assert got == _reference_visits(l, window, causal, K5.REF_BLOCK)
    n = -(-l // min(K5.REF_BLOCK, l))
    if causal or window:
        assert got < n * n or n == 1


@pytest.mark.parametrize("arch,impl", [
    ("mamba2-1.3b", {"ssm_impl": "pallas"}),
    ("mixtral-8x22b", {"attn_impl": "flash"})])
def test_kernel_routes_trace_in_the_dry_run(arch, impl):
    """The kernel routes trace on a (2, 2) fake mesh: the one-rank trace
    bills each K4 call what ``ssd_chunk_plain``'s products cost at its
    shape (K5 by its block pairs), and a rank does 1 to 1.2 times its
    quarter of the one-rank step's matmul FLOPs."""
    cfg = dataclasses.replace(get_smoke_config(arch), **impl)
    shape = InputShape("t", 64, 4, "prefill")
    one = D.run_one(arch, shape, "local", cfg=cfg, mesh_shape=(1, 1),
                    device="cpu")
    rec = D.run_one(arch, shape, "local", cfg=cfg, mesh_shape=(2, 2),
                    device="cpu")
    assert one["status"] == "ok", one.get("traceback")
    assert rec["status"] == "ok", rec.get("traceback")
    name = ("repro_torch::ssd_chunk" if "ssm_impl" in impl
            else "repro_torch::swa_attention")
    layers = cfg.n_layers
    assert one["op_kernel_calls"] == {name: layers}
    assert rec["op_kernel_calls"] == {name: layers}
    if "ssm_impl" in impl:
        s = cfg.ssm
        h, c = s.n_heads(cfg.d_model), min(s.chunk, shape.seq_len)
        def m(*t):
            return torch.empty(*t, device="meta")
        b, nc = shape.global_batch, shape.seq_len // c
        args = (m(b, nc, c, h, s.head_dim), m(b, nc, c, h), m(h),
                m(b, nc, c, s.n_groups, s.d_state),
                m(b, nc, c, s.n_groups, s.d_state))
        with OpAnalyzer("meta") as an:
            K4.ssd_chunk_plain(*args)
        want = layers * an.stats().matmul_flops
    else:
        q = torch.empty(shape.global_batch, shape.seq_len, cfg.n_heads,
                        cfg.hd(), device="meta")
        want = layers * K5.band_flops(q, None, cfg.sliding_window, True)
    assert one["op_kernel_flops_per_dev"][name] == want > 0
    share = one["op_matmul_flops_per_dev"] / 4
    assert share <= rec["op_matmul_flops_per_dev"] <= 1.2 * share


# ---------------------------------------------------------------------------
# dry runs
# ---------------------------------------------------------------------------

# the reference's own small-mesh case (tests/test_dryrun_small.py), with
# its HLO's dot FLOPs apart (the analysis again with dots billed 0), its
# ring-model link bytes and the compiled program's peak (arguments +
# temporaries + outputs not aliased to an argument)
REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, jax
from repro.configs import get_smoke_config, InputShape
from repro.launch import hlo_analysis as HA
from repro.launch.dryrun import build_step_and_args

shape = %(mesh)r
mesh = jax.make_mesh(shape, ("pod", "data", "model")[-len(shape):],
                     axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
cfg = dataclasses.replace(get_smoke_config("%(arch)s"), **%(over)r)
fn, args = build_step_and_args(cfg, InputShape("t", %(seq)d, %(batch)d,
                                               "%(kind)s"), mesh)
compiled = fn.lower(*args).compile()
txt = compiled.as_text()
ms = HA.analyze_module(txt)
HA._dot_flops = lambda *a, **k: 0.0
mem = compiled.memory_analysis()
print(json.dumps({
    "dot_flops": ms.flops - HA.analyze_module(txt).flops,
    "link": ms.collective_link_bytes,
    "peak": mem.argument_size_in_bytes + mem.temp_size_in_bytes
            + mem.output_size_in_bytes - mem.alias_size_in_bytes}))
"""


def _last_json(script, env):
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", [pytest.param(c, id=c["id"])
                                  for c in DS.CASES])
def test_small_mesh_dry_run(case):
    """Small-mesh cases on 8 fake ranks, each in a process of its own,
    held against the same step traced on one rank and against the
    reference's compiled program on 8 forced host devices (which runs here
    in seconds). The first three are the reference's own
    (``tests/test_dryrun_small.py``); the others each show a fault of
    the production sweep at a small size. The mesh is a ``cpu`` one: on a
    torch built without CUDA, DTensor's shape inference for some ops
    (``_softmax_backward_data``) cannot make its fake tensors of a
    ``cuda`` mesh; ``chip_smoke.py`` traces ``cuda`` on the card.

    The cases and the port's side of them are ``tools/dryrun_small.py``'s;
    the reference's figures computed here must equal those committed in
    ``tests/dryrun_reference.json``, which phase 12 reads on the card.

    The bars, and the readings they were set from (this CPU, torch 2.13,
    per rank, port over the share or the reference):
      * matmul FLOPs from 1 to 1.2 times the rank's share of the one-rank
        trace: 1.000 to 1.113 now; the long-cache decode and the
        4097-vocab decode read 1.296 and 1.565 before the cache write and
        the lm head were placed as XLA places them; the one-sequence
        decodes of qwen3, mamba2, jamba and mixtral read 2.000, 3.605,
        1.605 and 1.188 while every weight was gathered over ``data``,
        which cannot split one sequence (1.000, 1.113, 1.032 and 1.000
        with the weights kept on their shards);
      * matmul FLOPs at most 1.05 times the reference's HLO dots: 0.536 to
        0.999 now (qwen3's train step, the 4097 vocab and the one-sequence
        decodes lie under them: XLA repeats part of the work); the
        one-sequence decodes read 1.457, 1.737, 1.128 and 1.055 before;
      * peak at most 1.25 times the compiled program's: 0.33 to 0.998 now
        (0.48 for the 4097 vocab, which read 1.757); the 24-layer mamba2
        prefill, the 32-layer mamba2 decode and the mixtral train step
        read 1.795, 1.356 and 1.561 while the conv tail was a view of
        xbc, the decode restacked its cache and AdamW built new trees
        (0.478, 0.594 and 0.882 with the buffers reused; the mixtral
        step also with the all-to-all of ``card_alltoall``, whose
        all-gather fallback held 1.659); mamba2's one-sequence decode
        read 1.769 with its ``in_proj`` gathered (0.998 now);
      * link bytes at most 1.25 times the reference's ring-model bytes:
        0.16 to 0.96 now; the long-cache decode read 13.3 and the 4097
        vocab 1.76 before; the one-sequence decodes read 71.8, 72.5, 36.0
        and 8.5 with the weights gathered, the scores gathered whole over
        their key shards and the embedding table's shard moved by an
        all-to-all before the token lookup (0.60, 0.91, 0.62 and 0.52
        now);
      * the qwen2 train step on (2, 2, 2) reads 1.000 of the share, 0.949
        of the dots, peak 0.698 and link bytes 0.69; before the strided
        products were placed on their shards it did not trace within this
        test's 300 s limit (over 15 minutes, DTensor's planner)."""
    env = dict(os.environ, PYTHONPATH=f"{REPO}/src")
    proc = DS.spawn(case["id"], "cpu", env)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    port = json.loads(out.strip().splitlines()[-1])
    ref = _last_json(REF_SCRIPT % case, dict(env, JAX_PLATFORMS="cpu"))
    # the figures chip_smoke.py's phase 12 holds the card to
    assert ref == YARDSTICK["small"][case["id"]], (case["id"], ref)
    r, one = port["mesh"], port["one"]
    assert r["status"] == "ok", r.get("error")
    assert one["status"] == "ok", one.get("error")
    assert r["n_devices"] == 8
    assert r["op_flops_per_dev"] > 0
    assert r["n_collectives"] > 0          # sharded program must communicate
    assert r["mem_peak_bytes_per_dev"] >= 0
    share = one["op_matmul_flops_per_dev"] / 8
    mm = r["op_matmul_flops_per_dev"]
    assert share <= mm <= 1.2 * share, (mm, share)
    assert mm <= 1.05 * ref["dot_flops"], (mm, ref["dot_flops"])
    assert r["mem_peak_bytes_per_dev"] <= 1.25 * ref["peak"], \
        (r["mem_peak_bytes_per_dev"], ref["peak"])
    assert r["collective_link_bytes_per_dev"] <= 1.25 * ref["link"], \
        (r["collective_link_bytes_per_dev"], ref["link"])


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
