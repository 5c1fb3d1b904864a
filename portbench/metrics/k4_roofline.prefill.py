"""K4's share of its roofline: its least time over the traced window's
calls (one launch a layer; 3xTF32 operations at the TF32 peak or bytes at
the HBM rate, ``portbench.costs.k4_least_s``) over its device time
there."""
from portbench.costs import k4_least_s

NAMES = ("ssd_chunk_tc_kernel", "ssd_chunk_kernel")


def read(ctx):
    busy = sum(s for k, s in ctx["trace"]["kernels"].items()
               if any(n in k for n in NAMES))
    c, cfg = ctx["counts"], ctx["config"]
    if busy <= 0 or not c.get("calls"):
        return None
    s = cfg["ssm"]
    chunk = min(s["chunk"], c["prompt_len"])
    h = s["expand"] * cfg["d_model"] // s["head_dim"]
    least = k4_least_s(c["batch"], c["prompt_len"] // chunk, chunk, h,
                       s["head_dim"], s["n_groups"], s["d_state"])
    return 100.0 * least * cfg["n_layers"] * c["calls"] / busy
