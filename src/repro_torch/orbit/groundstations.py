"""The 13-station IGS-inspired ground network (paper Fig. 10)."""
from __future__ import annotations

import numpy as np

from repro_torch.orbit.constellation import R_EARTH

# (name, lat_deg, lon_deg) — locations from paper Fig. 10
IGS_STATIONS = (
    ("Sioux Falls (US)", 43.55, -96.70),
    ("Sanya (China)", 18.25, 109.50),
    ("Johannesburg (South Africa)", -26.20, 28.05),
    ("Cordoba (Argentina)", -31.42, -64.18),
    ("Tromso (Norway)", 69.65, 18.96),
    ("Kashi (China)", 39.47, 75.99),
    ("Beijing (China)", 39.90, 116.40),
    ("Neustrelitz (Germany)", 53.36, 13.07),
    ("Parepare (Indonesia)", -4.01, 119.62),
    ("Alice Springs (Australia)", -23.70, 133.88),
    ("Fairbanks (US)", 64.84, -147.72),
    ("Prince Albert (Canada)", 53.20, -105.75),
    ("Shadnagar (India)", 17.07, 78.18),
)


def gs_ecef(n_stations: int = 13) -> np.ndarray:
    """ECEF positions (G, 3) of the first n stations (paper sweeps 1..13)."""
    assert 1 <= n_stations <= len(IGS_STATIONS)
    out = []
    for name, lat, lon in IGS_STATIONS[:n_stations]:
        la, lo = np.radians(lat), np.radians(lon)
        out.append([R_EARTH * np.cos(la) * np.cos(lo),
                    R_EARTH * np.cos(la) * np.sin(lo),
                    R_EARTH * np.sin(la)])
    return np.asarray(out)
