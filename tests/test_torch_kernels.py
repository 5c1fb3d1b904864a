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
    """The whole QuAFL aggregation of a padded cohort (K1 on the card,
    its plain version on the CPU) agrees; quantization is bitwise."""
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
    assert K1.launches == before + len(leaves)
    for k in leaves:
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-5,
                                   atol=1e-6)


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
    ws = torch.stack([torch.tensor(0.25, device="cuda"), scale])
    torch.testing.assert_close(got, K1.quant_agg_plain(acc, q, ws),
                               rtol=1e-5, atol=1e-6)
