"""What K4 and K5 share as ``torch.library`` custom ops (namespace
``repro_torch``).

Each op has three implementations: on ``cuda`` it launches the kernel (or
raises), on ``cpu`` it runs the kernel's plain version, and its fake
implementation gives ``meta`` and fake tensors outputs of the right shapes
and types without a launch, which is how the dry run traces the kernel
routes. Neither kernel has a backward (nor has the reference's
``pallas_call``); the gradient of an op is that of its plain version,
recomputed from the saved inputs. A DTensor sharding rule is registered
by :func:`register_sharding` when DTensors are about to meet the ops
(``launch/dryrun.py`` does so on import): ``torch.distributed.tensor`` is
not imported for every user of the kernels.
"""
from __future__ import annotations

import torch


def plain_backward(op, plain, n_tensors):
    """Register, for ``op``, the gradient of ``plain`` over its first
    ``n_tensors`` arguments (the tensors), recomputed in the backward."""
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_tensors])
        ctx.rest = inputs[n_tensors:]

    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = plain(*ins, *ctx.rest)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  ins, [g for _, g in pairs],
                                  allow_unused=True)
        return tuple(got) + (None,) * len(ctx.rest)

    op.register_autograd(backward, setup_context=setup_context)


_REGISTERED = set()


def register_sharding(op, rule):
    """Register ``rule`` as ``op``'s DTensor sharding rule, once (see
    ``torch.distributed.tensor.experimental.register_sharding``: a list of
    (output placements, input placements) for one mesh dim; DTensor expands
    it over the mesh and drops the uneven ones, so a dim that a mesh dim
    does not divide is gathered first)."""
    if op in _REGISTERED:
        return
    from torch.distributed.tensor.experimental import \
        register_sharding as reg
    reg(op)(rule)
    _REGISTERED.add(op)
