"""PyTorch/CUDA port of the satellite-FL reproduction (``src/repro``).

Same subpackage layout as the JAX package (``orbit/``, ``core/``,
``sim/``, ``data/``, ``models/``, ``kernels/``, ``optim/``, ``train/``,
``checkpoint/``, ``launch/``), so each module here has one reference
module there. The port imports ``torch`` and ``numpy`` only.
Entry points take ``device=`` and default to ``"cuda"``; asking for the
card where there is none raises instead of running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
