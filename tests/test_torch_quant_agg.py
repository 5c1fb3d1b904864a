"""Port parity: kernels K1 (``quant_agg_stacked``) and K3 (``quant_agg``),
QuAFL quantization and the plain aggregation half of ``repro_torch``
against the JAX package.

On the CPU each wrapper takes its plain version, which is held here
against the Pallas kernel (interpret mode) and the jnp oracle at the
reference's own bar (``tests/test_quant_agg_stacked.py``,
``tests/test_kernels.py``). The CUDA kernels themselves are held against
the plain versions on the card by ``tests/test_torch_kernels.py`` and
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as JA
from repro.core import quantize as JQ
from repro.kernels import ops, ref
from repro_torch.convert import params_from_numpy as _to_torch
from repro_torch.core import aggregation as TA
from repro_torch.core import quantize as TQ
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import quant_agg as K1

torch.set_num_threads(1)


def params_from_numpy(tree):
    """The reference's parameters as CPU tensors (the port's default
    device is the card)."""
    return _to_torch(tree, device="cpu")


def _inputs(n, k, seed):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal(n).astype(np.float32)
    q = rng.integers(-127, 127, (k, n)).astype(np.int32)
    sw = rng.uniform(0.0, 0.1, k).astype(np.float32)
    return acc, q, sw


@pytest.mark.parametrize("mode", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("n,k", [(7, 1), (2048, 3), (2049, 4), (100_003, 2)])
def test_plain_k1_matches_reference(n, k, mode):
    acc, q, sw = _inputs(n, k, n + k)
    want = np.asarray(ops.quantized_stacked_accumulate(
        jnp.asarray(acc), jnp.asarray(q), jnp.asarray(sw), mode=mode))
    got = K1.quant_agg_stacked(torch.from_numpy(acc), torch.from_numpy(q),
                               torch.from_numpy(sw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_k1_cpu_route_is_plain_and_counts_nothing():
    acc, q, sw = _inputs(517, 3, 0)
    args = (torch.from_numpy(acc).reshape(11, 47),
            torch.from_numpy(q).reshape(3, 11, 47), torch.from_numpy(sw))
    before = K1.launches
    got = K1.quant_agg_stacked(*args)
    assert K1.launches == before
    assert torch.equal(got, K1.quant_agg_stacked_plain(*args))
    assert got.shape == (11, 47)


def test_k1_wrapper_checks_inputs():
    acc, q, sw = (torch.from_numpy(a) for a in _inputs(64, 2, 1))
    with pytest.raises(TypeError):
        K1.quant_agg_stacked(acc, q.to(torch.int64), sw)
    with pytest.raises(ValueError):
        K1.quant_agg_stacked(acc, q[:, :32], sw)
    with pytest.raises(ValueError):
        K1.quant_agg_stacked(acc, q, sw[:1])
    with pytest.raises(ValueError):
        K1.quant_agg_stacked(acc[::2], q[:, ::2], sw)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("shape", [(4, 33), (5, 3, 3, 16, 32), (2, 62)])
def test_quantize_stacked_bitwise(shape, bits):
    x = np.random.default_rng(bits).standard_normal(shape).astype(np.float32)
    qj, sj = JQ.quantize_stacked(jnp.asarray(x), bits)
    qt, st = TQ.quantize_stacked(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int32


def test_quantize_roundtrip_and_bytes_bitwise():
    rng = np.random.default_rng(3)
    p = {"a": rng.standard_normal((65, 3)).astype(np.float32),
         "b": np.linspace(-2.0, 2.0, 31).astype(np.float32)}
    want = JQ.quantize_roundtrip({k: jnp.asarray(v) for k, v in p.items()},
                                 10)
    got = TQ.quantize_roundtrip(params_from_numpy(p), 10)
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stacked = {"w": rng.standard_normal((3, 40)).astype(np.float32)}
    want = JQ.quantize_roundtrip_stacked({"w": jnp.asarray(stacked["w"])}, 10)
    got = TQ.quantize_roundtrip_stacked(params_from_numpy(stacked), 10)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    for bits in (0, 8, 10):
        assert TQ.transmit_bytes(params_from_numpy(p), bits) == \
            JQ.transmit_bytes({k: jnp.asarray(v) for k, v in p.items()}, bits)


@pytest.mark.parametrize("shape", [(3, 37), (2, 8, 260), (5, 1000)])
def test_quantized_weighted_average_matches_reference(shape):
    x = np.random.default_rng(shape[-1]).standard_normal(shape) \
        .astype(np.float32)
    w = np.arange(1, shape[0] + 1, dtype=np.float64)
    want = JA.quantized_weighted_average({"w": jnp.asarray(x)}, w, 10,
                                         mode="jnp")
    got = TA.quantized_weighted_average({"w": torch.from_numpy(x)}, w, 10)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-5, atol=1e-6)


def test_nan_scale_pad_row_stays_inert():
    """A zero-weight pad row with a non-finite scale adds exactly nothing."""
    real = np.random.default_rng(2).standard_normal((2, 40)) \
        .astype(np.float32)
    junk = np.full((1, 40), np.nan, np.float32)
    w = np.array([1.0, 1.0, 0.0])
    got = TA.quantized_weighted_average(
        {"w": torch.from_numpy(np.concatenate([real, junk]))}, w, 8)
    want = TA.quantized_weighted_average({"w": torch.from_numpy(real)},
                                         w[:2], 8)
    assert torch.isfinite(got["w"]).all()
    np.testing.assert_allclose(got["w"].numpy(), want["w"].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_weighted_average_pad_width_invariant():
    """Appending zero-weight rows (even non-finite ones) leaves the result
    bitwise unchanged, and it matches the reference bitwise."""
    rng = np.random.default_rng(4)
    real = rng.standard_normal((3, 5, 7)).astype(np.float32)
    w = np.array([32.0, 16.0, 32.0])
    base = TA.weighted_average({"w": torch.from_numpy(real)}, w)["w"]
    for pad in (1, 4):
        junk = np.full((pad, 5, 7), np.inf, np.float32)
        got = TA.weighted_average(
            {"w": torch.from_numpy(np.concatenate([real, junk]))},
            np.concatenate([w, np.zeros(pad)]))["w"]
        np.testing.assert_array_equal(got.numpy(), base.numpy())
    want = JA.weighted_average({"w": jnp.asarray(real)}, w)["w"]
    np.testing.assert_array_equal(base.numpy(), np.asarray(want))


def test_segment_means_and_buffered_deltas_match_reference():
    rng = np.random.default_rng(5)
    x = {"a": rng.standard_normal((10, 6)).astype(np.float32),
         "b": rng.standard_normal((10, 2, 3)).astype(np.float32)}
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = params_from_numpy(x)
    want, got = JA.segment_mean(jx, 2), TA.segment_mean(tx, 2)
    wts = np.array([1, 0, 1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    want_w = JA.segment_weighted_mean(jx, jnp.asarray(wts), 2)
    got_w = TA.segment_weighted_mean(tx, wts, 2)
    g = {k: v[0] for k, v in x.items()}
    dw = np.array([0.5, 1.0, 0.25, 1.0, 0.7, 1.0, 0.2, 0.3, 1.0, 0.9],
                  np.float32)
    base = {k: 0.5 * v for k, v in x.items()}
    want_d = JA.apply_buffered_deltas(
        {k: jnp.asarray(v) for k, v in g.items()}, jx,
        {k: jnp.asarray(v) for k, v in base.items()}, jnp.asarray(dw))
    got_d = TA.apply_buffered_deltas(params_from_numpy(g), tx,
                                     params_from_numpy(base), dw)
    for k in x:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_w[k].numpy(), np.asarray(want_w[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_d[k].numpy(), np.asarray(want_d[k]),
                                   rtol=1e-6, atol=1e-6)
    assert TA.pytree_bytes(tx, 10) == JA.pytree_bytes(jx, 10)


@pytest.mark.parametrize("n", [7, 2048, 2049, 100_003])
def test_plain_k3_matches_reference(n):
    """K3's plain version against the jnp oracle and the Pallas kernel
    (interpret mode) at the reference's bar (``tests/test_kernels.py``),
    with Python scalars and with 0-d tensors as scale and weight."""
    rng = np.random.default_rng(n)
    acc = rng.standard_normal(n).astype(np.float32)
    q = rng.integers(-127, 127, n).astype(np.int32)
    want = np.asarray(ref.quant_agg_ref(jnp.asarray(acc), jnp.asarray(q),
                                        0.01, 0.25))
    pallas = np.asarray(ops.quantized_weighted_accumulate(
        jnp.asarray(acc), jnp.asarray(q), 0.01, 0.25, interpret=True))
    ta, tq = torch.from_numpy(acc), torch.from_numpy(q)
    before = K1.single_launches
    for scale, weight in ((0.01, 0.25),
                          (torch.tensor(0.01), torch.tensor(0.25))):
        got = TOPS.quantized_weighted_accumulate(ta, tq, scale, weight)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6, atol=1e-6)
    assert K1.single_launches == before


def test_k3_wrapper_checks_inputs():
    acc, q, _ = (torch.from_numpy(a) for a in _inputs(64, 1, 3))
    q = q[0].contiguous()
    with pytest.raises(TypeError):
        K1.quant_agg(acc, q.to(torch.int64), 0.1, 1.0)
    with pytest.raises(ValueError):
        K1.quant_agg(acc, q[:32], 0.1, 1.0)
    with pytest.raises(ValueError):
        K1.quant_agg(acc[::2], q[::2], 0.1, 1.0)
    with pytest.raises(ValueError):
        K1.quant_agg(acc, q, torch.ones(2), 1.0)
    assert K1.quant_agg(acc, q, 0.1, 1.0).shape == acc.shape


def test_quantize_pytree_bitwise():
    rng = np.random.default_rng(8)
    p = {"a": rng.standard_normal((65, 3)).astype(np.float32),
         "b": np.linspace(-2.0, 2.0, 31).astype(np.float32)}
    qj, sj = JQ.quantize_pytree({k: jnp.asarray(v) for k, v in p.items()}, 8)
    qt, st = TQ.quantize_pytree(params_from_numpy(p), 8)
    dj, dt = JQ.dequantize_pytree(qj, sj), TQ.dequantize_pytree(qt, st)
    for k in p:
        np.testing.assert_array_equal(qt[k].numpy(), np.asarray(qj[k]))
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
        np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]))
        assert qt[k].dtype == torch.int32 and st[k].dim() == 0


def test_quantized_inplace_aggregate_matches_reference():
    """The streamed in-place aggregation (K3 per leaf and model) against
    the JAX one on the case of ``tests/test_kernels.py``: three 8-bit
    models, equal weights."""
    rng = np.random.default_rng(0)
    models = [{"w": rng.standard_normal(300).astype(np.float32),
               "b": rng.standard_normal((4, 5)).astype(np.float32)}
              for _ in range(3)]
    jq, js = zip(*(JQ.quantize_pytree({k: jnp.asarray(v)
                                       for k, v in m.items()}, 8)
                   for m in models))
    want = ops.quantized_inplace_aggregate(list(jq), list(js),
                                           [1.0, 1.0, 1.0], interpret=True)
    tq, ts = zip(*(TQ.quantize_pytree(params_from_numpy(m), 8)
                   for m in models))
    got = TOPS.quantized_inplace_aggregate(list(tq), list(ts),
                                           [1.0, 1.0, 1.0])
    deq = [TQ.dequantize_pytree(q, s) for q, s in zip(tq, ts)]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[k].numpy(),
                                   (sum(d[k] for d in deq) / 3).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_inplace_aggregate_matches_reference():
    rng = np.random.default_rng(9)
    ups = [({"w": rng.standard_normal((6, 7)).astype(np.float32)}, w)
           for w in (1.0, 3.0, 0.5)]
    want = JA.inplace_aggregate(({"w": jnp.asarray(p["w"])}, w)
                                for p, w in ups)
    got = TA.inplace_aggregate((params_from_numpy(p), w) for p, w in ups)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="no updates"):
        TA.inplace_aggregate([])


def _model_stream(n_models, seed, bits=10):
    """Quantized models of ten leaves (odd sizes, a 0-d leaf, sizes that
    are and are not multiples of 4) with their 0-d tensor scales, and
    unequal weights."""
    rng = np.random.default_rng(seed)
    shapes = [(144,), (16,), (3, 3, 1, 16), (62,), (7,), (), (5, 13),
              (4608,), (2049,), (32,)]
    models = [{f"l{i}": rng.standard_normal(s).astype(np.float32)
               for i, s in enumerate(shapes)} for _ in range(n_models)]
    weights = [float(w) for w in rng.uniform(1.0, 32.0, n_models)]
    return models, weights


@pytest.mark.parametrize("scale_kind", ["tensor", "float"])
@pytest.mark.parametrize("mode", ["pallas_interpret", "jnp"])
def test_plain_model_step_matches_reference(mode, scale_kind):
    """The in-place aggregation (one K3 step per model over all its
    leaves; the plain version here) against the JAX one in interpret mode
    and against a stream of the jnp oracle, with the quantizer's 0-d
    tensor scales and with Python float scales."""
    models, weights = _model_stream(4, 11)
    jq, js = zip(*(JQ.quantize_pytree({k: jnp.asarray(v)
                                       for k, v in m.items()}, 10)
                   for m in models))
    if mode == "pallas_interpret":
        want = ops.quantized_inplace_aggregate(list(jq), list(js), weights,
                                               interpret=True)
    else:
        tot = sum(weights)
        want = {k: jnp.zeros(jq[0][k].shape, jnp.float32) for k in jq[0]}
        for qm, sc, w in zip(jq, js, weights):
            want = {k: ref.quant_agg_ref(a, qm[k], sc[k], w / tot)
                    for k, a in want.items()}
    tq, ts = zip(*(TQ.quantize_pytree(params_from_numpy(m), 10)
                   for m in models))
    if scale_kind == "float":
        ts = [{k: float(v) for k, v in s.items()} for s in ts]
    got = TOPS.quantized_inplace_aggregate(list(tq), list(ts), weights)
    for k in want:
        assert got[k].shape == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def test_inplace_aggregate_leaves_inputs_alone_and_counts_nothing():
    """The caller's codes and scales are not modified, the accumulators
    are fresh float32 tensors, and the CPU route makes no launch."""
    models, weights = _model_stream(3, 12)
    tq, ts = zip(*(TQ.quantize_pytree(params_from_numpy(m), 8)
                   for m in models))
    q_before = [{k: v.clone() for k, v in m.items()} for m in tq]
    s_before = [{k: v.clone() for k, v in m.items()} for m in ts]
    before = K1.single_launches
    got = TOPS.quantized_inplace_aggregate(list(tq), list(ts), weights)
    assert K1.single_launches == before
    for m, mb in zip(tq, q_before):
        assert all(torch.equal(m[k], mb[k]) for k in m)
    for s, sb in zip(ts, s_before):
        assert all(torch.equal(s[k], sb[k]) for k in s)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.shape == tq[0][k].shape
        assert not any(v.data_ptr() == m[k].data_ptr() for m in tq)


def test_leaf_tables_pack_in_order_and_split_past_capacity():
    """K3's launch tables: leaves in the given order, empty leaves left
    out, sizes and the 16-byte flag per leaf, device scales by address and
    other scales as host floats, a split every TABLE_CAPACITY leaves."""
    cap = K1.TABLE_CAPACITY
    buf = torch.zeros(4 * 4096, dtype=torch.float32)
    qbuf = torch.zeros(4 * 4096, dtype=torch.int32)
    accs, qs, scales, want = [], [], [], []
    off = 0
    for i in range(2 * cap):
        n = (0, 8, 7, 64, 12)[i % 5]
        shift = 1 if i % 7 == 3 else 0       # a leaf off its 16-byte grid
        off += shift
        accs.append(buf[off:off + n])
        qs.append(qbuf[off:off + n])
        scales.append(torch.tensor(0.5 + i) if i % 2 else 0.25 * i)
        if n:
            want.append((i, n, int(n % 4 == 0 and off % 4 == 0)))
        off = (off + n + 3) // 4 * 4
    assert K1._leaves(accs, qs, scales) == []      # checked, not packed
    tables = K1._leaves(accs, qs, scales, pack=True)
    assert [count for _, count in tables] == [cap, len(want) - cap]
    assert [len(table) for table, _ in tables] == [
        count * K1._LEAF.size for _, count in tables]
    flat = [rec for table, _ in tables
            for rec in K1._LEAF.iter_unpack(table)]
    assert len(flat) == len(want)
    for (acc, q, out, sp, host, vec, n), (i, n_want, vec_want) in zip(
            flat, want):
        assert n == n_want and vec == vec_want
        assert acc == accs[i].data_ptr() == out
        assert q == qs[i].data_ptr()
        if i % 2:        # a CPU tensor scale beside CPU leaves: by address
            assert sp == scales[i].data_ptr()
        else:
            assert sp == 0 and host == np.float32(scales[i])
    assert any(v == 0 for *_, v in want) and any(v == 1 for *_, v in want)


def test_k3_weight_is_read_on_the_host():
    """The card's route takes the weight as a host float: a number or a
    CPU tensor. A weight on another device is refused, not read back."""
    assert K1._host_weight(0.25) == 0.25
    assert K1._host_weight(torch.tensor(0.5)) == 0.5
    with pytest.raises(TypeError, match="weight"):
        K1._host_weight(torch.empty((), device="meta"))


def test_inplace_step_past_capacity_matches_per_leaf_steps():
    """One in-place step over more leaves than a table holds equals the
    per-leaf ``quant_agg`` calls bitwise, and leaves the inputs alone."""
    rng = np.random.default_rng(13)
    n_leaves = K1.TABLE_CAPACITY + 5
    sizes = rng.integers(1, 300, n_leaves)
    accs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for n in sizes]
    qs = [torch.from_numpy(rng.integers(-511, 512, n).astype(np.int32))
          for n in sizes]
    scales = [torch.tensor(float(s), dtype=torch.float32)
              for s in rng.uniform(1e-3, 4e-3, n_leaves)]
    want = [K1.quant_agg(a, q, s, 0.3) for a, q, s in zip(accs, qs, scales)]
    q_before = [q.clone() for q in qs]
    K1.quant_agg_inplace(accs, qs, scales, 0.3)
    for a, w in zip(accs, want):
        assert torch.equal(a, w)
    assert all(torch.equal(q, qb) for q, qb in zip(qs, q_before))
    with pytest.raises(ValueError):
        K1.quant_agg_inplace(accs, qs[:-1], scales, 0.3)


def test_stacked_leaf_tables_pack_in_order_and_split_past_capacity():
    """K1's launch tables: leaves in the given order, empty leaves left
    out, the acc, q, sw and out pointers, n and the 16-byte flag per leaf
    (set only for n a multiple of 4 with acc, q and out on the 16-byte
    grid), a split every TABLE_CAPACITY leaves."""
    cap, k = K1.TABLE_CAPACITY, 3
    buf = torch.zeros(4 * 4096, dtype=torch.float32)
    qbuf = torch.zeros(k * 4 * 4096, dtype=torch.int32)
    sw = torch.rand(2 * cap, k)
    accs, qs, outs, want = [], [], [], []
    off = 0
    for i in range(2 * cap):
        n = (0, 8, 7, 64, 12)[i % 5]
        shift = 1 if i % 7 == 3 else 0       # a leaf off its 16-byte grid
        off += shift
        accs.append(buf[off:off + n])
        outs.append(buf[off:off + n] if i % 2 else torch.empty(n))
        qs.append(qbuf[k * off:k * (off + n)].view(k, n))
        if n:
            want.append((i, n, int(n % 4 == 0 and off % 4 == 0)))
        off = (off + n + 3) // 4 * 4
    sws = list(sw)
    assert K1._stacked_leaves(accs, qs, sws) == []   # checked, not packed
    tables = K1._stacked_leaves(accs, qs, sws, outs, pack=True)
    assert [count for _, count in tables] == [cap, len(want) - cap]
    assert [len(table) for table, _ in tables] == [
        count * K1._STACKED_LEAF.size for _, count in tables]
    flat = [rec for table, _ in tables
            for rec in K1._STACKED_LEAF.iter_unpack(table)]
    assert len(flat) == len(want)
    for (acc, q, s, out, n, vec, pad), (i, n_want, vec_want) in zip(
            flat, want):
        assert n == n_want and vec == vec_want and pad == 0
        assert acc == accs[i].data_ptr() and q == qs[i].data_ptr()
        assert s == sws[i].data_ptr() and out == outs[i].data_ptr()
    assert any(v == 0 for *_, v in want) and any(v == 1 for *_, v in want)
    inplace = K1._stacked_leaves(accs[:2], qs[:2], sws[:2], pack=True)
    (acc, _, _, out, *_), = K1._STACKED_LEAF.iter_unpack(inplace[0][0])
    assert acc == out == accs[1].data_ptr()


def test_stacked_leaves_check_the_table():
    """One K for every leaf, sw of length K, one device, contiguity."""
    accs = [torch.zeros(5), torch.zeros(2, 3)]
    qs = [torch.zeros(3, 5, dtype=torch.int32),
          torch.zeros(3, 2, 3, dtype=torch.int32)]
    sws = [torch.ones(3), torch.ones(3)]
    K1._stacked_leaves(accs, qs, sws)
    with pytest.raises(ValueError):          # a second K
        K1._stacked_leaves(accs, [qs[0], qs[1][:2]], sws)
    with pytest.raises(ValueError):
        K1._stacked_leaves(accs, qs, [sws[0], sws[1][:2]])
    with pytest.raises(ValueError):
        K1._stacked_leaves(accs, qs, sws[:1])
    with pytest.raises(TypeError):
        K1._stacked_leaves(accs, qs, [sws[0], sws[1].double()])
    with pytest.raises(ValueError):
        K1.quant_agg_stacked_inplace([accs[0], torch.zeros(3, 2).t()],
                                     [qs[0], qs[1].transpose(1, 2)], sws)


def test_stacked_inplace_past_capacity_matches_per_leaf_calls():
    """One in-place K1 step over more leaves than a table holds (sizes not
    a multiple of 4, a pad row with sw = 0) equals the per-leaf
    ``quant_agg_stacked`` calls bitwise and makes no launch on the CPU."""
    rng = np.random.default_rng(14)
    n_leaves, k = K1.TABLE_CAPACITY + 8, 5
    sizes = rng.integers(1, 300, n_leaves)
    accs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for n in sizes]
    qs = [torch.from_numpy(rng.integers(-511, 512, (k, n)).astype(np.int32))
          for n in sizes]
    sw = torch.from_numpy(rng.uniform(0, 2e-3, (n_leaves, k))
                          .astype(np.float32))
    sw[:, -1] = 0.0
    want = [K1.quant_agg_stacked(a, q, s) for a, q, s in zip(accs, qs, sw)]
    before = K1.launches
    TOPS.quantized_stacked_accumulate_inplace(accs, qs, list(sw))
    assert K1.launches == before
    for a, w in zip(accs, want):
        assert torch.equal(a, w)


def test_quantized_weighted_average_cnn_leaves_match_reference():
    """The one-launch aggregation over the CNN's eight leaves (a padded
    cohort: two zero-weight rows, one of them NaN) against the JAX package,
    and bitwise equal to one ``quant_agg_stacked`` call per leaf on fresh
    zero accumulators, as the aggregation was formed before its leaves
    shared one table."""
    rng = np.random.default_rng(15)
    shapes = [(3, 3, 1, 16), (16,), (3, 3, 16, 32), (32,), (1568, 128),
              (128,), (128, 62), (62,)]
    x = {f"l{i}": (rng.standard_normal((6,) + s) * 0.05).astype(np.float32)
         for i, s in enumerate(shapes)}
    for v in x.values():
        v[-1] = np.nan
    w = np.array([32.0, 16.0, 32.0, 8.0, 0.0, 0.0])
    want = JA.quantized_weighted_average(
        {k: jnp.asarray(v) for k, v in x.items()}, w, 10, mode="jnp")
    tx = params_from_numpy(x)
    got = TA.quantized_weighted_average(tx, w, 10)
    wt = torch.as_tensor(w, dtype=torch.float32)
    wt = wt / torch.clamp_min(wt.sum(), 1e-9)
    for k, v in tx.items():
        assert torch.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
        q, scale = TQ.quantize_stacked(v, 10)
        per_leaf = K1.quant_agg_stacked(
            torch.zeros(v.shape[1:]), q, torch.where(wt > 0, wt * scale, 0.0))
        assert torch.equal(got[k], per_leaf)
