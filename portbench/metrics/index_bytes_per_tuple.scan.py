"""index_bytes_per_tuple.scan: the index's bytes after the window over live tuples."""
from pb_readers import index_bytes_per_tuple as read  # noqa: F401
