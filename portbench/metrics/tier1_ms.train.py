"""Device milliseconds of one tier-1 step (every cluster's train step),
from CUDA events recorded around each call in the stream; the mean over
the traced window's steps."""


def read(ctx):
    ms = ctx["spans"].get("portbench::tier1") or []
    return sum(ms) / len(ms) if ms else None
