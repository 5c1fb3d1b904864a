"""K5's share of its roofline: its least time over the traced window's
calls (one launch a layer; the larger of its operations at the bf16 peak
and its bytes at the HBM rate, ``portbench.costs.k5_least_s``) over its
device time there."""
from portbench.costs import k5_least_s

NAMES = ("swa_tc_kernel", "swa_fwd_kernel")


def read(ctx):
    busy = sum(s for k, s in ctx["trace"]["kernels"].items()
               if any(n in k for n in NAMES))
    c, cfg = ctx["counts"], ctx["config"]
    if busy <= 0 or not c.get("calls"):
        return None
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    least = k5_least_s(c["batch"], c["prompt_len"], cfg["n_heads"],
                       cfg["n_kv_heads"], hd, cfg["sliding_window"])
    return 100.0 * least * cfg["n_layers"] * c["calls"] / busy
