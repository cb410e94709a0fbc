"""read_qps: all queries answered in the window over the window (host clock)."""
from pb_readers import read_qps as read  # noqa: F401
