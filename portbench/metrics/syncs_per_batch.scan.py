"""syncs_per_batch.scan: host-blocking CUDA runtime calls inside the program's hippo.engine.batch spans in the traced part, over those spans."""
from pb_spans import syncs_per_batch as read  # noqa: F401
