"""delete_rows_ms.refresh: median of the harness's span around each
order's delete, the whole window (host clock)."""
from pb_readers import median


def read(run):
    return median(run.delete_ms)
