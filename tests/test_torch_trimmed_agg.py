"""Port parity: kernel K2 (``trimmed_agg_stacked``), the fused sort +
rank-weighted combine behind the trimmed-mean and median aggregators.

On the CPU the wrapper takes its plain version, which is held here against
the jnp oracle ``ref.trimmed_agg_stacked_ref`` and the Pallas kernel in
interpret mode at the reference's own bar, rtol 1e-5 / atol 1e-6
(``tests/test_trimmed_agg_stacked.py``). The CUDA kernel itself is held
against the plain version on the card by ``tests/test_torch_kernels.py``
and ``chip_smoke.py``."""
import re
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import trimmed_agg as K2

torch.set_num_threads(1)


def _rank_weights(k, rw_vals):
    rw = np.zeros((k,), np.float32)
    for r, v in rw_vals:
        rw[r] += v
    return rw


def _combine(x, rw):
    return K2.trimmed_agg_stacked(torch.from_numpy(np.asarray(x)),
                                  torch.from_numpy(np.asarray(rw))).numpy()


@pytest.mark.parametrize("n,k", [(7, 1), (2048, 3), (2049, 5), (100_003, 4)])
def test_plain_k2_matches_reference(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((k, n)).astype(np.float32)
    rw = rng.dirichlet(np.ones(k)).astype(np.float32)
    got = _combine(x, rw)
    oracle = np.asarray(ref.trimmed_agg_stacked_ref(jnp.asarray(x),
                                                    jnp.asarray(rw)))
    pallas = np.asarray(ops.trimmed_stacked_combine(
        jnp.asarray(x), jnp.asarray(rw), mode="pallas_interpret"))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [3, 4])
def test_median_rank_weights_match_numpy_median(k):
    x = np.random.default_rng(k).standard_normal((k, 513)).astype(np.float32)
    rw = _rank_weights(k, [((k - 1) // 2, 0.5), (k // 2, 0.5)])
    np.testing.assert_allclose(_combine(x, rw), np.median(x, axis=0),
                               rtol=1e-6, atol=1e-6)


def test_inf_pad_rows_sort_last_and_stay_inert():
    real = np.random.default_rng(5).standard_normal((3, 257)) \
        .astype(np.float32)
    x = np.concatenate([real, np.full((2, 257), np.inf, np.float32)])
    got = _combine(x, _rank_weights(5, [(1, 1.0)]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.median(real, axis=0),
                               rtol=1e-6, atol=1e-6)


def test_k1_is_the_identity():
    x = np.random.default_rng(7).standard_normal((1, 2048)) \
        .astype(np.float32)
    np.testing.assert_array_equal(_combine(x, np.ones(1, np.float32)), x[0])


def test_nan_row_sorts_last():
    """A NaN ranks after +inf, as in the oracle's jnp.sort: the median of
    (1, NaN, 3) over three rows is 3, and the top rank holds the NaN."""
    x = np.array([[1.0, 5.0], [np.nan, 2.0], [3.0, np.inf]], np.float32)
    got = _combine(x, _rank_weights(3, [(1, 1.0)]))
    np.testing.assert_array_equal(got, [3.0, 5.0])
    top = _combine(x, _rank_weights(3, [(2, 1.0)]))
    assert np.isnan(top[0]) and top[1] == np.inf
    want = np.asarray(ref.trimmed_agg_stacked_ref(
        jnp.asarray(x), jnp.asarray(_rank_weights(3, [(2, 1.0)]))))
    np.testing.assert_array_equal(top, want)


def test_cpu_route_is_plain_counts_nothing_and_checks_inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 11, 47)).astype(np.float32))
    rw = torch.tensor([0.0, 1.0, 0.0])
    before = K2.launches
    got = K2.trimmed_agg_stacked(x, rw)
    assert K2.launches == before
    assert torch.equal(got, K2.trimmed_agg_stacked_plain(x, rw))
    assert got.shape == (11, 47)
    with pytest.raises(TypeError):
        K2.trimmed_agg_stacked(x.to(torch.float64), rw)
    with pytest.raises(TypeError):
        K2.trimmed_agg_stacked(x, rw.to(torch.int32))
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x, rw[:2])
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x[:0], rw[:0])
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x[:, :, ::2], rw)
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x, rw.to("meta"))
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked(x.to("meta"), rw.to("meta"))


# -- the leaf table, the mask and the sorting network --------------------

CU = (Path(K2.__file__).resolve().parent / "csrc" / "trimmed_agg.cu") \
    .read_text()


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def _cu_struct_codes(name):
    """The ``struct`` codes of the fields of ``struct name`` in the .cu
    source, one letter a value: a pointer 'Q', int64_t 'q', int 'i',
    uint32_t 'I', float 'f' (an array of N floats N letters)."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", CU, re.S).group(1)
    codes = ""
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.fullmatch(r"(.+?)\s*\b(\w+)(?:\[(\w+)\])?", decl)
        ctype, count = m.group(1), m.group(3)
        code = "Q" if "*" in ctype else {"int64_t": "q", "int": "i",
                                         "uint32_t": "I",
                                         "float": "f"}[ctype]
        codes += code * (_cu_constant(count) if count else 1)
    return codes


def _expand(fmt):
    return "".join(c * int(n or 1)
                   for n, c in re.findall(r"(\d*)([a-zA-Z])", fmt))


def test_records_are_laid_out_as_the_cu_structs():
    """``_LEAF`` and ``_PARAMS`` pack the fields of ``RankLeaf`` and
    ``RankParams`` in order, with no padding that the compiler would add
    (every field at its natural alignment), and the capacities match the
    kernel's."""
    assert _expand(K2._LEAF.format) == _cu_struct_codes("RankLeaf")
    assert _expand(K2._PARAMS.format) == _cu_struct_codes("RankParams")
    for st in (K2._LEAF, K2._PARAMS):
        assert st.format.startswith("=") and st.size % 8 == 0
    off = 0
    for c in _expand(K2._PARAMS.format):          # natural alignment
        size = struct.calcsize(c)
        assert off % size == 0
        off += size
    assert K2.TABLE_CAPACITY == _cu_constant("kMaxLeaves")
    assert K2.RANK_CAPACITY == _cu_constant("kMaxRanks")


def _network(kb):
    body = re.search(rf"struct Net<{kb}> \{{\s*static constexpr int size = "
                     r"(\d+);.*?= \{(.*?)\};", CU, re.S)
    pairs = [(int(a), int(b))
             for a, b in re.findall(r"\{(\d+), (\d+)\}", body.group(2))]
    assert len(pairs) == int(body.group(1))
    return pairs


def _sorts_every_01_input(net, n):
    """The 0-1 principle: a comparator network sorts every input iff it
    sorts every 0/1 input. Up to 16 wires all 2^n inputs are tried. Above,
    the network must open with a prefix that stays inside wires 0-15 and
    16 up and sorts each of them (checked the same way), after which every
    0/1 input leaves two sorted runs: the rest must sort each of the
    17 * (n - 15) such inputs."""
    if n <= 16:
        v = ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1) \
            .astype(np.uint8)
    else:
        split = next(i for i, (a, b) in enumerate(net) if a < 16 <= b)
        for base, width in ((0, 16), (16, n - 16)):
            part = [(a - base, b - base) for a, b in net[:split]
                    if base <= a < base + width]
            if not _sorts_every_01_input(part, width):
                return False
        net = net[split:]
        v = np.array([[0] * i + [1] * (16 - i) + [0] * j + [1] * (n - 16 - j)
                      for i in range(17) for j in range(n - 15)], np.uint8)
    for a, b in net:
        assert a < b
        v[:, a], v[:, b] = np.minimum(v[:, a], v[:, b]), \
            np.maximum(v[:, a], v[:, b])
    return bool((np.diff(v.astype(np.int8), axis=1) >= 0).all())


@pytest.mark.parametrize("kb,size", [(4, 5), (8, 19), (16, 63), (32, 191)])
def test_sorting_network_sorts_every_01_input(kb, size):
    """The comparator lists the kernel sorts with, read from its source:
    Batcher's odd-even merge networks, each sorting every 0/1 input of its
    bucket. A wrong pair, a dropped one or a wrong order fails here."""
    net = _network(kb)
    assert len(net) == size
    assert all(0 <= a < b < kb for a, b in net)
    assert _sorts_every_01_input(net, kb)
    broken = net[:size // 2] + net[size // 2 + 1:]
    assert not _sorts_every_01_input(broken, kb)


@pytest.mark.parametrize("k", range(1, 33))
def test_pruned_network_sorts_k_keys(k):
    """The kernel's instance for K rows runs its bucket's network less
    every comparator that touches a slot past K; that pruned network
    sorts every 0/1 input of K wires."""
    kb = next(b for b in (4, 8, 16, 32) if k <= b)
    net = [(a, b) for a, b in _network(kb) if b < k]
    assert _sorts_every_01_input(net, k)
    # the counts behind chip_smoke.py's operation bound (K2_COMPARATORS)
    assert len(net) == {5: 9, 10: 32, 32: 191}.get(k, len(net))


def test_leaf_tables_pack_in_order_and_split_past_capacity():
    """K2's launch tables: leaves in the given order, empty leaves left
    out, the x and out pointers, n and the 16-byte flag per leaf (set only
    for n a multiple of 4 with x and out on the 16-byte grid), a split
    every TABLE_CAPACITY leaves; K shared."""
    cap, k = K2.TABLE_CAPACITY, 3
    buf = torch.zeros(k * 4 * 4096, dtype=torch.float32)
    xs, outs, want = [], [], []
    off = 0
    for i in range(2 * cap):
        n = (0, 8, 7, 64, 12)[i % 5]
        off += 1 if i % 7 == 3 else 0        # a leaf off its 16-byte grid
        xs.append(buf[off:off + k * n].view(k, n))
        outs.append(torch.empty(n + 1)[i % 2:i % 2 + n])
        if n:
            want.append((i, n, int(n % 4 == 0 and off % 4 == 0
                                   and i % 2 == 0)))
        off = (off + k * n + 3) // 4 * 4
    assert K2._leaves(xs) == (k, [])          # checked, not packed
    kk, tables = K2._leaves(xs, outs)
    assert kk == k
    assert [count for _, count in tables] == [cap, len(want) - cap]
    assert [len(table) for table, _ in tables] == [
        count * K2._LEAF.size for _, count in tables]
    flat = [rec for table, _ in tables
            for rec in K2._LEAF.iter_unpack(table)]
    assert len(flat) == len(want)
    for (x, out, n, vec, pad), (i, n_want, vec_want) in zip(flat, want):
        assert n == n_want and vec == vec_want and pad == 0
        assert x == xs[i].data_ptr() and out == outs[i].data_ptr()
    assert any(v == 0 for *_, v in want) and any(v == 1 for *_, v in want)


@pytest.mark.parametrize("k", [5, 32, 40])
def test_shared_parameter_packs_weights_and_mask(k):
    """Up to RANK_CAPACITY rows the rank weights travel by value and the
    mask as bits; above, both are copied beside the leaves and go by
    address. Weights already on the leaves' device go by address."""
    rng = np.random.default_rng(k)
    rw = rng.dirichlet(np.ones(k)).astype(np.float32)
    mask = rng.random(k) < 0.7
    cpu = torch.device("cpu")
    params, keep = K2._rank_params(K2._checked_weights(rw, k, cpu), mask,
                                   k, cpu)
    rec = K2._PARAMS.unpack(params)
    by_value, (rw_ptr, mask_ptr, bits, masked, kk, pad) = \
        rec[:K2.RANK_CAPACITY], rec[K2.RANK_CAPACITY:]
    assert (masked, kk, pad) == (1, k, 0)
    if k <= K2.RANK_CAPACITY:
        assert not keep and rw_ptr == 0 and mask_ptr == 0
        np.testing.assert_array_equal(np.float32(by_value[:k]), rw)
        assert not any(by_value[k:])
        assert bits == sum(1 << j for j in range(k) if mask[j])
    else:
        assert not any(by_value) and bits == 0
        assert rw_ptr == keep[0].data_ptr() and mask_ptr == keep[1].data_ptr()
        np.testing.assert_array_equal(keep[0].numpy(), rw)
        np.testing.assert_array_equal(keep[1].numpy(), mask.astype(np.uint8))
    on_device = torch.from_numpy(rw)
    params, keep = K2._rank_params(on_device, None, k, cpu)
    rec = K2._PARAMS.unpack(params)[K2.RANK_CAPACITY:]
    assert rec == (on_device.data_ptr(), 0, 0, 0, k, 0) and not keep


def _bad(case):
    """(x, rank weights, the error) that the single-leaf check raises."""
    x, rw = torch.zeros(3, 4, 5), torch.ones(3)
    return {"x float64": (x.double(), rw, TypeError),
            "rw int32": (x, rw.int(), TypeError),
            "rw of another K": (x, rw[:2], ValueError),
            "K = 0": (x[:0], rw[:0], ValueError),
            "not contiguous": (x[:, :, ::2], rw, ValueError),
            "rw on another device": (x, rw.to("meta"), ValueError),
            "no route": (x.to("meta"), rw.to("meta"), ValueError)}[case]


@pytest.mark.parametrize("case", [
    "x float64", "rw int32", "rw of another K", "K = 0", "not contiguous",
    "rw on another device", "no route"])
def test_table_refuses_what_one_leaf_refuses(case):
    """Every input the single-leaf check refuses (dtype, shape, K >= 1,
    contiguity, one device) the table refuses too, with the same error,
    as its only leaf and behind a good one."""
    x, rw, err = _bad(case)
    with pytest.raises(err):
        K2.trimmed_agg_stacked(x, rw)
    with pytest.raises(err):
        K2.trimmed_agg_stacked_leaves([x], rw)
    with pytest.raises(err):
        K2.trimmed_agg_stacked_leaves([torch.zeros(3, 2), x], rw)


def test_table_checks_one_k_one_device_and_the_mask():
    """One K for every leaf, one device, a mask of K host booleans, rank
    weights of length K; the table accepts leaves of any shapes."""
    rw = np.full(3, 1 / 3, np.float32)
    xs = [torch.zeros(3, 5), torch.zeros(3, 2, 3)]
    assert [o.shape for o in K2.trimmed_agg_stacked_leaves(xs, rw)] == [
        (5,), (2, 3)]
    assert K2.trimmed_agg_stacked_leaves([], rw) == []
    with pytest.raises(ValueError):                  # a second K
        K2.trimmed_agg_stacked_leaves([xs[0], torch.zeros(2, 5)], rw)
    with pytest.raises(ValueError):                  # a second device
        K2.trimmed_agg_stacked_leaves([xs[0], xs[1].to("meta")], rw)
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked_leaves(xs, rw, [True, False])
    with pytest.raises(TypeError):
        K2.trimmed_agg_stacked_leaves(xs, rw, torch.ones(3, dtype=torch.bool,
                                                         device="meta"))
    with pytest.raises(ValueError):
        K2.trimmed_agg_stacked_leaves(xs, rw[:2])
    with pytest.raises(TypeError):
        K2.trimmed_agg_stacked_leaves(xs, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError):                  # a scalar leaf
        K2.trimmed_agg_stacked_leaves([torch.zeros(())], rw[:1])


def _same(a, b):
    """Bitwise equal, NaN for NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a.view(torch.int32)),
        torch.where(nb, 0, b.view(torch.int32))))


@pytest.mark.parametrize("garbage", [np.nan, 7.0, -np.inf, np.inf])
@pytest.mark.parametrize("k,m", [(5, 3), (10, 8), (33, 30), (40, 39)])
def test_masked_cpu_route_is_plain_on_where_bitwise(k, m, garbage):
    """The CPU route of the masked table equals the plain version on
    where(valid, x, inf) bitwise, leaf by leaf, whatever the pad rows
    hold, with a NaN in a valid row; it launches nothing, and more leaves
    than a table holds give the same as one call per leaf."""
    rng = np.random.default_rng(k * 100 + m)
    shapes = [(7,), (3, 4), (1,), (2, 2, 5)] * 9       # 36 leaves
    xs = [torch.from_numpy(rng.standard_normal((k,) + s)
                           .astype(np.float32)) for s in shapes]
    pads = rng.permutation(k)[m:]
    valid = np.ones(k, bool)
    valid[pads] = False
    for x in xs:
        x[pads] = garbage
        x.view(k, -1)[np.flatnonzero(valid)[0], 0] = np.nan
    rw = _rank_weights(k, [((m - 1) // 2, 0.5), (m // 2, 0.5)])
    before = K2.launches
    got = K2.trimmed_agg_stacked_leaves(xs, rw, valid)
    assert K2.launches == before
    vt = torch.from_numpy(valid)
    for x, g in zip(xs, got):
        vb = vt.reshape((-1,) + (1,) * (x.dim() - 1))
        want = K2.trimmed_agg_stacked_plain(torch.where(vb, x, torch.inf),
                                            torch.from_numpy(rw))
        assert g.shape == x.shape[1:] and _same(g, want)
        assert _same(g, K2.trimmed_agg_stacked_leaves([x], rw, valid)[0])
    med = np.median(xs[0].reshape(k, -1)[vt].numpy(), axis=0)
    finite = np.isfinite(med)
    np.testing.assert_allclose(got[0].reshape(-1).numpy()[finite],
                               med[finite], rtol=1e-6, atol=1e-6)
