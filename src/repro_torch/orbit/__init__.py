from repro_torch.orbit.constellation import WalkerStar, satellite_elements
from repro_torch.orbit.eclipse import (PackedEclipse, eclipse_fraction,
                                       eclipse_series, sun_direction_eci)
from repro_torch.orbit.groundstations import IGS_STATIONS, gs_ecef
from repro_torch.orbit.propagate import ecef_positions, eci_positions
from repro_torch.orbit.visibility import (access_window_arrays,
                                          access_windows,
                                          elevation_mask_series,
                                          interplane_los_series,
                                          transitions_from_bool_matrix,
                                          windows_from_bool,
                                          windows_from_bool_tensor)

__all__ = ["WalkerStar", "satellite_elements", "IGS_STATIONS", "gs_ecef",
           "eci_positions", "ecef_positions", "access_windows",
           "access_window_arrays", "elevation_mask_series",
           "interplane_los_series", "windows_from_bool",
           "windows_from_bool_tensor", "transitions_from_bool_matrix",
           "PackedEclipse", "eclipse_series", "eclipse_fraction",
           "sun_direction_eci"]
