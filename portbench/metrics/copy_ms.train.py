"""Device milliseconds of ``aten::copy_`` (self time: casts, strided
copies, the in-place writes of AdamW and the sync) per tier-1 step, from
the profiler."""


def read(ctx):
    s = ctx["trace"]["ops"].get("aten::copy_")
    steps = ctx["counts"].get("steps")
    return 1e3 * s / steps if s and steps else None
