"""batch_ms.scan: median run_batch span in the traced part (host clock)."""
from pb_readers import batch_ms as read  # noqa: F401
