"""Whole training step's share of the card's bf16 peak: the model
operations of the traced window's tier-1 steps (6 a parameter a token,
plus the SSD's in-chunk and carried-state terms, recomputation not
counted; ``portbench.costs``) over the window's seconds."""
from portbench.costs import PEAK_BF16_FLOPS


def read(ctx):
    c = ctx["counts"]
    if not c.get("steps"):
        return None
    return 100.0 * c["flops"] / c["wall_s"] / PEAK_BF16_FLOPS
