"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports neither JAX nor the JAX package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_kernels.py

Without a CUDA device each test skips with its reason (a CUDA kernel has
no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.core.aggregation import quantized_weighted_average
from repro_torch.kernels import quant_agg as K1
from repro_torch.kernels import ssd_scan as K4
from repro_torch.kernels import swa_attention as K5
from repro_torch.kernels import trimmed_agg as K2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(7, 1), (2049, 4), (200_704, 5), (62, 2),
                                 (100_003, 10)])
def test_quant_agg_stacked_kernel_matches_plain(n, k):
    _need_cuda()
    # 10-bit codes with weight*scale products of the main path's size
    # (|sw * q| <= 1); the plain version sums k in another order, so the
    # reference's allclose bar applies, not bitwise equality
    rng = np.random.default_rng(n + k)
    acc = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    q = torch.from_numpy(rng.integers(-511, 512, (k, n)).astype(np.int32)) \
        .cuda()
    sw = torch.from_numpy(rng.uniform(0, 2e-3, k).astype(np.float32)).cuda()
    before = K1.launches
    got = K1.quant_agg_stacked(acc, q, sw)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    torch.testing.assert_close(got, K1.quant_agg_stacked_plain(acc, q, sw),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_quantized_weighted_average_card_matches_cpu():
    """The whole QuAFL aggregation of a padded cohort (K1 on the card, one
    launch for all leaves; its plain version on the CPU) agrees;
    quantization is bitwise."""
    _need_cuda()
    rng = np.random.default_rng(0)
    leaves = {"dense": (5, 1568, 128), "bo": (5, 62),
              "conv1": (5, 3, 3, 1, 16)}
    x = {k: rng.standard_normal(s).astype(np.float32) * 0.05
         for k, s in leaves.items()}
    w = np.array([32.0, 32.0, 32.0, 0.0, 0.0])
    cpu = quantized_weighted_average({k: torch.from_numpy(v)
                                      for k, v in x.items()}, w, 10)
    before = K1.launches
    card = quantized_weighted_average({k: torch.from_numpy(v).cuda()
                                       for k, v in x.items()}, w, 10)
    assert K1.launches == before + 1         # one table for every leaf
    for k in leaves:
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [8, 40])
def test_quant_agg_stacked_table_bitwise_per_leaf(n_leaves):
    """One K1 table call over 8 leaves (the CNN's sizes) and over 40 (two
    tables: 32 + 8) equals the same leaves as tables of one bitwise and
    the plain version within 1e-5; leaves off the 16-byte grid, sizes not
    a multiple of 4 and a pad row with sw = 0 among them."""
    _need_cuda()
    rng = np.random.default_rng(n_leaves)
    k = 5
    sizes = ([144, 16, 4608, 32, 200_704, 128, 7936, 62] if n_leaves == 8
             else [int(n) for n in rng.integers(1, 5000, n_leaves)])
    buf = torch.from_numpy(rng.standard_normal(sum(sizes) + n_leaves)
                           .astype(np.float32)).cuda()
    accs, off = [], 0
    for i, n in enumerate(sizes):
        off += i % 3 == 1                    # some leaves off the grid
        accs.append(buf[off:off + n])
        off += n
    qs = [torch.from_numpy(rng.integers(-511, 512, (k, n)).astype(np.int32))
          .cuda() for n in sizes]
    sw = torch.from_numpy(rng.uniform(0, 2e-3, (n_leaves, k))
                          .astype(np.float32)).cuda()
    sw[:, -1] = 0.0                          # the pad row
    for q in qs:
        q[-1] = 511
    want = [K1.quant_agg_stacked(a, q, s) for a, q, s in zip(accs, qs, sw)]
    plain = [K1.quant_agg_stacked_plain(a, q, s)
             for a, q, s in zip(accs, qs, sw)]
    before = K1.launches
    K1.quant_agg_stacked_inplace(accs, qs, list(sw))
    torch.cuda.synchronize()
    assert K1.launches == before + -(-n_leaves // K1.TABLE_CAPACITY)
    for a, w, pl in zip(accs, want, plain):
        assert torch.equal(a, w)
        torch.testing.assert_close(a, pl, rtol=1e-5, atol=1e-5)


def _rank_weights(k, kind, m=None):
    """Rank weights of the trimmed mean (trim 0.2) or the median over the
    first m of k ranks (the valid rows; the rest are +inf pads)."""
    m = k if m is None else m
    rw = np.zeros(k, np.float32)
    if kind == "median":
        rw[(m - 1) // 2] += 0.5
        rw[m // 2] += 0.5
    else:
        lo = min(int(0.2 * m), max((m - 1) // 2, 0))
        rw[lo:m - lo] = 1.0 / (m - 2 * lo)
    return rw


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["trimmed_mean", "median"])
@pytest.mark.parametrize("n,k", [(7, 1), (2049, 2), (100_003, 4), (4608, 5),
                                 (200_704, 10), (2049, 33), (7, 100)])
def test_trimmed_agg_stacked_kernel_matches_plain(n, k, kind):
    """K2 on the card against its plain version, with +inf pad rows at
    zero-weight ranks (k > 2) and one NaN coordinate, which sorts last."""
    _need_cuda()
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((k, n)).astype(np.float32)
    m = k - 2 if k > 2 else k
    x[m:] = np.inf
    x[0, n // 2] = np.nan
    rw = _rank_weights(k, kind, m)
    xt, rwt = torch.from_numpy(x).cuda(), torch.from_numpy(rw).cuda()
    before = K2.launches
    got = K2.trimmed_agg_stacked(xt, rwt)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    want = K2.trimmed_agg_stacked_plain(xt, rwt)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    assert torch.isfinite(got).sum() >= n - 1


def _same(a, b):
    """Bitwise equal, NaN for NaN (whatever the NaN's payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a.view(torch.int32)),
        torch.where(nb, 0, b.view(torch.int32))))


def _masked_cohort(rng, sizes, k, m, garbage):
    """(K, n) leaves of one cohort as views of one buffer (some off the
    16-byte grid), the last k - m rows pads holding ``garbage`` and one
    NaN coordinate in a valid row; and the host mask of the m valid
    rows."""
    buf = torch.from_numpy((0.05 * rng.standard_normal(
        k * sum(sizes) + len(sizes))).astype(np.float32)).cuda()
    xs, off = [], 0
    for i, n in enumerate(sizes):
        off += i % 3 == 1                    # some leaves off the grid
        x = buf[off:off + k * n].view(k, n)
        x[m:] = garbage
        x[0, n // 2] = np.nan
        xs.append(x)
        off += k * n
    return xs, np.arange(k) < m


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_leaves", [8, 40])
def test_trimmed_agg_table_bitwise_per_leaf(n_leaves, masked):
    """One K2 table call over 8 leaves (the CNN's sizes) and over 40 (two
    tables: 32 + 8) equals the same leaves as tables of one, bitwise and
    NaN for NaN, and the plain version on where(valid, x, inf) within
    1e-5 / 1e-6. Masked: the pad rows hold NaN, never read; unmasked
    they hold +inf, as the caller set them."""
    _need_cuda()
    rng = np.random.default_rng(n_leaves + masked)
    k, m = 5, 3
    sizes = ([144, 16, 4608, 32, 200_704, 128, 7936, 62] if n_leaves == 8
             else [int(n) for n in rng.integers(1, 5000, n_leaves)])
    xs, valid = _masked_cohort(rng, sizes, k, m,
                               np.nan if masked else np.inf)
    mask = valid if masked else None
    rw = _rank_weights(k, "trimmed_mean", m)
    per_leaf = [K2.trimmed_agg_stacked_leaves([x], rw, mask)[0] for x in xs]
    before = K2.launches
    got = K2.trimmed_agg_stacked_leaves(xs, rw, mask)
    torch.cuda.synchronize()
    assert K2.launches == before + -(-n_leaves // K2.TABLE_CAPACITY)
    vb = torch.from_numpy(valid).cuda()[:, None]
    rwt = torch.from_numpy(rw).cuda()
    for x, g, w in zip(xs, got, per_leaf):
        assert _same(g, w)
        plain = K2.trimmed_agg_stacked_plain(torch.where(vb, x, torch.inf),
                                             rwt)
        torch.testing.assert_close(g, plain, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
        # the valid row's NaN sorts after the pads, to a rank of weight 0;
        # the coordinate takes a pad's +inf: no pad's garbage gets through
        assert int(torch.isfinite(g).sum()) == g.numel() - 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["trimmed_mean", "median"])
def test_robust_aggregation_is_one_k2_launch(kind):
    """A trimmed-mean or median aggregation of a padded cohort of the
    CNN's 8 leaves, and a median FedBuff flush, each make one K2 launch
    (the aggregation's two pad rows counted once as masked); both agree with the CPU route within 1e-5 / 1e-6."""
    from repro_torch.core import aggregation as TA
    _need_cuda()
    rng = np.random.default_rng(5)
    shapes = {"c1": (3, 3, 1, 16), "b1": (16,), "c2": (3, 3, 16, 32),
              "b2": (32,), "d1": (1568, 128), "bd": (128,), "o": (128, 62),
              "bo": (62,)}
    cohort = {n: (0.05 * rng.standard_normal((5,) + s)).astype(np.float32)
              for n, s in shapes.items()}
    for v in cohort.values():
        v[3:] = np.nan                        # pad rows, weight 0
    w = np.array([32.0, 16.0, 32.0, 0.0, 0.0])
    agg = TA.make_robust_aggregator(kind)
    card_in = {n: torch.from_numpy(v).cuda() for n, v in cohort.items()}
    zeros = {n: torch.zeros(s) for n, s in shapes.items()}
    before, masked = K2.launches, K2.masked_rows
    card, n_card = agg.aggregate(card_in, w,
                                 {n: z.cuda() for n, z in zeros.items()})
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert K2.masked_rows == masked + 2       # the two pad rows, once
    cpu, n_cpu = agg.aggregate({n: torch.from_numpy(v)
                                for n, v in cohort.items()}, w, zeros)
    assert n_card == n_cpu
    for n in shapes:
        torch.testing.assert_close(card[n].cpu(), cpu[n], rtol=1e-5,
                                   atol=1e-6)
    base = {n: torch.from_numpy(v[:3].copy()) for n, v in cohort.items()}
    new = {n: b + 0.01 for n, b in base.items()}
    wts = np.array([0.5, 1.0, 2.0], np.float32)
    before = K2.launches
    flushed, _ = TA.robust_apply_buffered_deltas(
        {n: z.cuda() for n, z in zeros.items()},
        {n: v.cuda() for n, v in new.items()},
        {n: v.cuda() for n, v in base.items()}, wts, agg)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    want, _ = TA.robust_apply_buffered_deltas(zeros, new, base, wts, agg)
    for n in shapes:
        torch.testing.assert_close(flushed[n].cpu(), want[n], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(33, 30), (40, 37)])
def test_trimmed_agg_any_k_through_the_table(k, m):
    """K > 32 takes the rank walk through the same table: three leaves in
    one launch, the rank weights and the mask copied to the card, equal
    to the tables of one bitwise and to the plain version on where(valid,
    x, inf) within 1e-5 / 1e-6."""
    _need_cuda()
    rng = np.random.default_rng(k)
    xs, valid = _masked_cohort(rng, [7, 2049, 4608], k, m, 3.0)
    for kind in ("trimmed_mean", "median"):
        rw = _rank_weights(k, kind, m)
        per_leaf = [K2.trimmed_agg_stacked_leaves([x], rw, valid)[0]
                    for x in xs]
        before = K2.launches
        got = K2.trimmed_agg_stacked_leaves(xs, rw, valid)
        torch.cuda.synchronize()
        assert K2.launches == before + 1
        vb = torch.from_numpy(valid).cuda()[:, None]
        for x, g, w in zip(xs, got, per_leaf):
            assert _same(g, w)
            plain = K2.trimmed_agg_stacked_plain(
                torch.where(vb, x, torch.inf), torch.from_numpy(rw).cuda())
            torch.testing.assert_close(g, plain, rtol=1e-5, atol=1e-6,
                                       equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 2049, 200_704, 100_003])
def test_quant_agg_kernel_matches_plain(n):
    """K3 on the card against its plain version, with a Python weight and
    a 0-d CUDA tensor as scale."""
    _need_cuda()
    rng = np.random.default_rng(n)
    acc = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    q = torch.from_numpy(rng.integers(-511, 512, n).astype(np.int32)).cuda()
    scale = torch.tensor(3e-3, device="cuda")
    before = K1.single_launches
    got = K1.quant_agg(acc, q, scale, 0.25)
    torch.cuda.synchronize()
    assert K1.single_launches == before + 1
    torch.testing.assert_close(got, K1.quant_agg_plain(acc, q, scale, 0.25),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_quant_agg_inplace_kernel_bitwise_per_leaf():
    """One in-place K3 step over 40 leaves (two tables: 32 + 8) equals the
    per-leaf K3 calls bitwise, with 0-d CUDA scales and Python float
    scales, leaves off the 16-byte grid and sizes not a multiple of 4."""
    _need_cuda()
    rng = np.random.default_rng(40)
    sizes = [int(n) for n in rng.integers(1, 5000, 40)] + [200_704]
    buf = torch.from_numpy(rng.standard_normal(sum(sizes) + 41)
                           .astype(np.float32)).cuda()
    accs, off = [], 0
    for i, n in enumerate(sizes):
        off += i % 3 == 1                    # some leaves off the grid
        accs.append(buf[off:off + n])
        off += n
    qs = [torch.from_numpy(rng.integers(-511, 512, n).astype(np.int32))
          .cuda() for n in sizes]
    scales = [torch.tensor(float(s), device="cuda") if i % 2 else float(s)
              for i, s in enumerate(rng.uniform(1e-3, 4e-3, len(sizes)))]
    want = [K1.quant_agg(a, q, s, 0.2) for a, q, s in zip(accs, qs, scales)]
    before = K1.single_launches
    K1.quant_agg_inplace(accs, qs, scales, 0.2)
    torch.cuda.synchronize()
    assert K1.single_launches == before + 2
    for a, w in zip(accs, want):
        assert torch.equal(a, w)


def _ssd_inputs(b, nc, c, h, p, g, n, seed, strided=False):
    """K4's inputs on the card, drawn as tests/test_kernels.py draws them
    (dt post-softplus, A < 0). ``strided``: x and B are views into wider
    rows, as the model's projections hand them over."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()
    x = t(rng.standard_normal((b, nc, c, h, p + 8 * strided)))[..., :p]
    dt = t(np.log1p(np.exp(rng.standard_normal((b, nc, c, h)))))
    A = t(-np.exp(rng.standard_normal(h) * 0.3))
    B = t(rng.standard_normal((b, nc, c, g, n + 4 * strided)) * 0.5)[..., :n]
    C = t(rng.standard_normal((b, nc, c, g, n)) * 0.5)
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,c,h,p,g,n,strided", [
    (1, 4, 16, 2, 16, 1, 16, False),     # tests/test_kernels.py's cases
    (2, 4, 32, 4, 32, 2, 32, False),
    (1, 3, 32, 2, 64, 1, 128, False),
    (2, 2, 32, 4, 32, 4, 32, False),     # B, C pre-repeated (g = h)
    (1, 2, 100, 4, 64, 2, 32, True),     # ragged chunk, strided views
    (1, 2, 256, 8, 64, 1, 128, True),    # mamba2-1.3b's chunk, p and n
    (1, 2, 24, 4, 18, 1, 12, True),      # p, n not multiples of 8; rows
                                         # of x off the 16-byte grid
    (1, 2, 64, 2, 96, 1, 32, False),     # p > 64
    (1, 2, 64, 2, 32, 1, 160, False),    # n > 128: the CUDA-core instance
])
def test_ssd_chunk_kernel_matches_plain(b, nc, c, h, p, g, n, strided):
    """K4 on the card against its plain version (float32; sums taken in
    another order and, on the tensor cores, products split in three TF32
    terms, so the CPU parity bar of 2e-4 applies), through the instance
    ``route`` names."""
    _need_cuda()
    args = _ssd_inputs(b, nc, c, h, p, g, n, c + h, strided)
    before, tc_before = K4.launches, K4.tc_launches
    y, st = K4.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert K4.launches == before + 1
    assert K4.tc_launches == tc_before + (K4.route(c, p, n) == "tensor_core")
    y_want, st_want = K4.ssd_chunk_plain(*args)
    torch.testing.assert_close(y, y_want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, st_want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_ssd_chunk_kernel_no_overflow_above_the_diagonal():
    """A = -60 makes exp(cs_i - cs_j) overflow for j > i: the kernel
    evaluates it for j <= i only, so every output stays finite."""
    _need_cuda()
    x, dt, A, B, C = _ssd_inputs(1, 2, 64, 2, 16, 1, 16, 3)
    A = torch.full_like(A, -60.0)
    tc_before = K4.tc_launches
    y, st = K4.ssd_chunk(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert K4.tc_launches == tc_before + 1
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_want, st_want = K4.ssd_chunk_plain(x, dt, A, B, C)
    torch.testing.assert_close(y, y_want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, st_want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("l,window,causal,h,kh,hd", [
    (128, 0, True, 4, 2, 32),            # tests/test_kernels.py's cases
    (128, 48, True, 4, 2, 32),
    (256, 64, True, 4, 2, 32),
    (128, 16, True, 4, 2, 32),
    (100, 0, True, 4, 2, 64),            # ragged last tiles
    (1000, 300, True, 6, 2, 128),
    (128, 48, False, 4, 1, 32),          # window, not causal
    (64, 0, False, 2, 2, 32),
    (8192, 4096, True, 6, 1, 128),       # mixtral-8x22b: one kv group
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_kernel_matches_plain(l, window, causal, h, kh, hd,
                                            dtype):
    """K5 on the card against its plain version; the reference's bars
    (2e-5 float32, 2e-2 bfloat16: the output is rounded to bfloat16)."""
    _need_cuda()
    rng = np.random.default_rng(l + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, l, n, hd)).astype(np.float32)).cuda().to(dtype)
        for n in (h, kh, kh))
    before = K5.launches
    got = K5.swa_attention(q, k, v, window, causal)
    torch.cuda.synchronize()
    assert K5.launches == before + 1 and got.dtype == dtype
    want = K5.swa_attention_plain(q, k, v, window, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("l,window,causal,h,kh,hd,offset", [
    (128, 0, True, 4, 2, 32, False),     # tests/test_kernels.py's cases
    (128, 48, True, 4, 2, 32, False),
    (256, 64, True, 4, 2, 32, False),
    (128, 16, True, 4, 2, 32, False),
    (100, 0, True, 4, 2, 64, False),     # ragged last tiles
    (1000, 300, True, 6, 2, 128, False),
    (128, 48, False, 4, 1, 32, False),   # window, not causal
    (64, 0, False, 2, 2, 32, False),
    (300, 0, True, 4, 2, 16, False),     # hd 16 and 96: zero-padded columns
    (300, 50, True, 4, 2, 96, False),
    (200, 64, True, 4, 2, 64, True),     # inputs off the 16-byte grid
    (8192, 4096, True, 6, 1, 128, False),  # mixtral-8x22b: one kv group
])
def test_swa_attention_tensor_core_matches_plain(l, window, causal, h, kh,
                                                 hd, offset):
    """K5's tensor-core instance (bfloat16) on the card against the plain
    version at the bfloat16 bars (2e-2 a value, 1e-2 in relative L2),
    counted as such; inputs TMA cannot read in place are copied first."""
    _need_cuda()
    rng = np.random.default_rng(l + window + hd)

    def draw(n):
        a = torch.from_numpy(rng.standard_normal(
            (1, l, n, hd)).astype(np.float32)).cuda().to(torch.bfloat16)
        if not offset:
            return a
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
        flat[1:] = a.flatten()
        return flat[1:].view(a.shape)
    q, k, v = draw(h), draw(kh), draw(kh)
    assert K5.route(q.dtype, hd) == "tensor_core"
    assert K5.tma_ready(q) != offset
    before, tc_before = K5.launches, K5.tc_launches
    got = K5.swa_attention(q, k, v, window, causal)
    torch.cuda.synchronize()
    assert K5.launches == before + 1 and K5.tc_launches == tc_before + 1
    want = K5.swa_attention_plain(q, k, v, window, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_l2(got, want) <= 1e-2


def _rel_l2(got, want):
    """||got - want|| / ||want|| over the whole output, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("l,window,causal,h,kh,hd", [
    (200, 64, True, 4, 2, 40),           # hd not a multiple of 16
    (300, 100, True, 4, 2, 256),         # hd above 128
    (128, 48, False, 4, 1, 8),
])
def test_swa_attention_cuda_core_takes_other_bf16_shapes(l, window, causal,
                                                         h, kh, hd):
    """bfloat16 shapes the tensor-core instance refuses run K5's CUDA-core
    instance (no tensor-core launch) and hold the bfloat16 bars (2e-2 a
    value, 1e-2 in relative L2)."""
    _need_cuda()
    rng = np.random.default_rng(l + window + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, l, n, hd)).astype(np.float32)).cuda().to(torch.bfloat16)
        for n in (h, kh, kh))
    assert K5.route(q.dtype, hd) == "cuda_core"
    before, tc_before = K5.launches, K5.tc_launches
    got = K5.swa_attention(q, k, v, window, causal)
    torch.cuda.synchronize()
    assert K5.launches == before + 1 and K5.tc_launches == tc_before
    want = K5.swa_attention_plain(q, k, v, window, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_l2(got, want) <= 1e-2
