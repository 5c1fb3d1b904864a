"""Whole prefill's share of the card's bf16 peak: the model operations of
the traced window's calls (``prefill_flops`` of the configuration's
reference, ``portbench/reference/``) over the
window's seconds, the host's time between calls included."""
from portbench.costs import PEAK_BF16_FLOPS


def read(ctx):
    c = ctx["counts"]
    if not c.get("calls"):
        return None
    return 100.0 * c["flops"] / c["wall_s"] / PEAK_BF16_FLOPS
