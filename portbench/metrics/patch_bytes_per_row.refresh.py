"""patch_bytes_per_row.refresh: WriterStats patch_bytes (host-to-device
bytes of every slab patch) over the rows staged plus the rows deleted by
id, in the traced part. A program without these counters reads nothing."""


def read(run):
    w = run.writer
    if "patch_bytes" not in w or "rows_deleted" not in w:
        return None
    rows = w.get("staged", 0) + w["rows_deleted"]
    return w["patch_bytes"] / rows if rows else None
