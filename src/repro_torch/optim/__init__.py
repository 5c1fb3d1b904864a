from repro_torch.optim.optimizers import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    sgd_init,
    sgd_update,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "sgd_init", "sgd_update"]
