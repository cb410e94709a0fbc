from repro_torch.checkpointing.checkpoint import (  # noqa: F401
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.checkpointing.layout import (  # noqa: F401
    CorruptSnapshotError, commit_sentinel, pack_sections, read_section_file,
    section_sizes, unpack_sections, write_file_durable, write_section_file,
)
from repro_torch.checkpointing.snapshot import (  # noqa: F401
    delta_chain, disk_usage, latest_delta_seq, latest_epoch, load_index,
    recover_index, save_delta, save_index,
)
from repro_torch.checkpointing.wal import Journal, WalRecord  # noqa: F401
