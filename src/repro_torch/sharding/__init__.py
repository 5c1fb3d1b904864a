"""Sharding rules of the LM stack over a ``(pod,) data, model`` mesh.
Port of the JAX package's ``sharding/``."""
from repro_torch.sharding.partition import (
    P,
    batch_specs,
    cache_specs,
    decode_arg_specs,
    named,
    param_specs,
    train_state_specs,
)

__all__ = ["P", "batch_specs", "cache_specs", "decode_arg_specs", "named",
           "param_specs", "train_state_specs"]
