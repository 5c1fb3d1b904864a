"""Share of the traced window in which no operation ran on the device
(the union of the profiler's device intervals against the window)."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
