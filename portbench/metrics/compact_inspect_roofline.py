"""compact_inspect_roofline: kernel B's once-moved bytes over 3.35 TB/s against its device time, %."""
from pb_readers import compact_inspect_roofline as read  # noqa: F401
