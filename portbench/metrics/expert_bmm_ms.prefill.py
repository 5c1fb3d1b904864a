"""Device milliseconds of ``aten::bmm`` per prefill call: the experts'
batched products (K5 computes the attention, so no other bmm runs)."""


def read(ctx):
    s = ctx["trace"]["ops"].get("aten::bmm")
    calls = ctx["counts"].get("calls")
    return 1e3 * s / calls if s and calls else None
