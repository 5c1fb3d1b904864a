"""Production meshes and the card's roofline constants. Port of the JAX
package's ``launch/mesh.py``.

The sharding rules read only a mesh's axis names and sizes, so
:class:`AbstractMesh` (names and sizes, no devices, no process group)
lets the production shapes, (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")``, be reasoned about anywhere.
``make_production_mesh`` and ``make_local_mesh`` return a
``DeviceMesh`` over the current process group, real or fake
(``launch/dryrun.py`` runs 256 or 512 fake ranks in one process); the
caller initialises that group first. Importing this module touches no
device and no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
# (a card set below it runs slower under load; print its power limit
# beside any share of these). Targets for the roofline, not read at run
# time from the card.
PEAK_FLOPS_BF16 = 989e12        # bfloat16 / float16 tensor cores, per card
PEAK_FLOPS_TF32 = 495e12        # TF32 tensor cores, per card
PEAK_FLOPS_FP32 = 67e12         # float32 outside the tensor cores, per card
HBM_BW = 3.35e12                # HBM3 bytes/s per card
ICI_BW = 450e9                  # NVLink 4 bytes/s per card, one direction


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with ``DeviceMesh``'s attribute
    names (``mesh_dim_names``, ``shape``) so that the sharding rules take
    either."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} and names "
                             f"{self.mesh_dim_names} differ in length")

    def size(self) -> int:
        return math.prod(self.shape)


def _production_shape(multi_pod: bool):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _local_shape(data: int, model: int, pod: int):
    if pod:
        return (pod, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    return AbstractMesh(*_production_shape(multi_pod))


def _device_mesh(device_type, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production ``DeviceMesh``; the process group must hold 256
    (single pod) or 512 (multi pod) ranks."""
    return _device_mesh(device_type, *_production_shape(multi_pod))


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    device_type="cuda"):
    """A small ``DeviceMesh`` over however many ranks the group holds."""
    return _device_mesh(device_type, *_local_shape(data, model, pod))
