"""The paper's own configuration (§7 experimental setup): Hippo index defaults
and the TPC-H-style workload parameters, exposed like any other config."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HippoPaperConfig:
    resolution: int = 400          # default histogram resolution (§7)
    density: float = 0.2           # default partial histogram density (§7)
    page_card: int = 50            # tuples per page (§6.2 running example)
    # TPC-H-style workload scales: tuples in the Lineitem-like table.
    # (The paper uses 2/20/200 GB; we scale by tuple count on this host.)
    scales: tuple = (60_000, 600_000, 6_000_000)
    selectivities: tuple = (0.00001, 0.0001, 0.001, 0.01)  # 0.001%..1%
    densities_sweep: tuple = (0.2, 0.4, 0.8)               # Fig. 8 / Table 3
    resolutions_sweep: tuple = (400, 800, 1600)            # Fig. 9 / Table 3
    refresh_fraction: float = 0.001                        # TPC-H refresh: 0.1%


DEFAULT = HippoPaperConfig()
