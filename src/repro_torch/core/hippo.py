"""CREATE INDEX helpers shared by the index front ends (port of the
sampling half of ``repro.core.hippo``; ``HippoIndex`` itself comes with a
later slice, ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import histogram as hg
from repro_torch.storage.table import PagedTable


def sample_keys(table: PagedTable, sample_size: int = 65536) -> np.ndarray:
    """The CREATE INDEX build sample: live tuples, capped at ``sample_size``
    by the reference's fixed-seed draw (``default_rng(0).choice``), so both
    packages quantile the same sample."""
    if table.num_pages == 0:
        raise ValueError(
            "empty table: pass an explicit hist (the complete histogram "
            "is DBMS-maintained and cannot be sampled from zero tuples)")
    live = table.keys[: table.num_pages][table.valid[: table.num_pages]]
    if live.size > sample_size:
        rng = np.random.default_rng(0)
        live = rng.choice(live, size=sample_size, replace=False)
    return live


def sample_histogram(table: PagedTable, resolution: int,
                     sample_size: int = 65536, device=None) -> hg.Histogram:
    """The DBMS-maintained complete histogram, sampled from the table (§4.1)."""
    return hg.build(sample_keys(table, sample_size), resolution, device=device)


@dataclass
class MaintenanceCounters:
    inserts: int = 0
    entries_touched: int = 0
    entries_created: int = 0
    vacuums: int = 0
    entries_resummarized: int = 0
