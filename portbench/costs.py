"""The benchmark's yardstick for work: operations and bytes counted from
shapes, and the peaks they are held against. A model's whole count is
with its reference (``portbench/reference/<family>.py``: ``prefill_flops``,
``train_flops``), built from the kernel counts here.

Peaks are the published rates of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense, at the full 700 W power limit). Every count here is of the
work the algorithm needs, never of what a kernel happens to recompute:
remat's recomputation in training is not counted, and a causal product
counts the pairs j <= i only.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def k4_cost(b, nc, c, h, p, g, n):
    """(operations, bytes) of one call of the SSD intra-chunk stage (K4)
    on x (b, nc, c, h, p), B and C (b, nc, c, g, n): per (batch, chunk,
    head) C·B, the decay-and-dt scaling and W·x over the c(c+1)/2 pairs
    j <= i, and the chunk state xᵀ(B scaled); each float32 input read
    once and each output written once."""
    pairs = c * (c + 1) // 2
    ops = b * nc * h * (pairs * (2 * n + 2 * p + 3) + c * (2 * p * n + n + 2))
    nbytes = 4 * (2 * b * nc * c * h * p + b * nc * c * h + h
                  + 2 * b * nc * c * g * n + b * nc * h * p * n)
    return ops, nbytes


def k4_least_s(b, nc, c, h, p, g, n):
    """K4's least time a call: its tensor-core instance does each product
    three times in TF32 (3xTF32), so operations count thrice at the TF32
    peak; bytes at the HBM rate; the larger bounds it."""
    ops, nbytes = k4_cost(b, nc, c, h, p, g, n)
    return max(3 * ops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def visible_pairs(length, window):
    """(query, key) pairs a causal query row sees over a sequence, each
    row the last ``window`` keys up to itself (all of them when
    ``window`` is 0)."""
    if not window or window >= length:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


def k5_cost(b, length, h, kh, hd, window, itemsize):
    """(operations, bytes) of one sliding-window attention call (K5): 2 hd
    multiply-adds per visible pair for q·k and as many for p·v; q, k, v
    read once and the output written once."""
    ops = 4 * hd * b * h * visible_pairs(length, window)
    nbytes = itemsize * (2 * b * length * h + 2 * b * length * kh) * hd
    return ops, nbytes


def k5_least_s(b, length, h, kh, hd, window, itemsize=2):
    ops, nbytes = k5_cost(b, length, h, kh, hd, window, itemsize)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def ssd_forward_flops(b, length, h, p, g, n, chunk):
    """Operations of the chunked SSD forward of one layer: K4's stage plus
    the carried state's contribution to every position (C·state, 2 p n a
    position and head) and the chunk-to-chunk recurrence."""
    nc = length // chunk
    intra, _ = k4_cost(b, nc, chunk, h, p, g, n)
    return intra + b * length * h * 2 * p * n + b * nc * h * 2 * p * n
