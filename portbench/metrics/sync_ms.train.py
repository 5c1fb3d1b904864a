"""Device milliseconds of one tier-2 sync (the QuAFL average of the
clusters' parameters and moments), from CUDA events recorded around each
call in the stream; the mean over the traced window's syncs."""


def read(ctx):
    ms = ctx["spans"].get("portbench::sync") or []
    return sum(ms) / len(ms) if ms else None
