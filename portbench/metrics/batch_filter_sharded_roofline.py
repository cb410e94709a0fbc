"""batch_filter_sharded_roofline: kernel A's once-moved bytes over 3.35 TB/s against its device time, %."""
from pb_readers import batch_filter_sharded_roofline as read  # noqa: F401
