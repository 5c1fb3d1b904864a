from repro_torch.checkpoint.checkpoint import (ChecksumError, load_meta,
                                               restore_pytree, save_pytree)

__all__ = ["ChecksumError", "load_meta", "save_pytree", "restore_pytree"]
