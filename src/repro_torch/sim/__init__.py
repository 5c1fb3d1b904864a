from repro_torch.sim.events import Event, EventQueue, EventStats, WorldTimeline
from repro_torch.sim.hardware import (FLYCUBE, SMALLSAT_SBAND, FleetProfile,
                                      HardwareProfile, PowerModes)

# NOTE: repro_torch.sim.flystack is imported directly (not here) to avoid a
# circular import with repro_torch.core.spaceify, as in the reference.

__all__ = ["FLYCUBE", "SMALLSAT_SBAND", "FleetProfile", "HardwareProfile",
           "PowerModes", "Event", "EventQueue", "EventStats", "WorldTimeline"]
