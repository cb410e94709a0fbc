"""device_idle.scan: share of the traced window with no device operation running, %."""
from pb_readers import device_idle as read  # noqa: F401
