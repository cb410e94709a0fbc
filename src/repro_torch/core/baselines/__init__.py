"""The paper's comparison baselines (port of ``repro.core.baselines``): a
B+-tree that lives on the device, a min-max (BRIN) index and a full scan."""
from repro_torch.core.baselines.btree import BPlusTree  # noqa: F401
from repro_torch.core.baselines.fullscan import FullScan  # noqa: F401
from repro_torch.core.baselines.minmax import MinMaxIndex  # noqa: F401
