"""syncs_per_row.durable: journal fsyncs over the rows written plus the
rows deleted by id, in the traced part (EngineStats journal_syncs and
writes, WriterStats rows_deleted): 1 where every row commits alone, the
rows of an order's inverse where each order commits once. A program
without these counters reads nothing."""


def read(run):
    e, w = run.engine, run.writer
    if "journal_syncs" not in e or "rows_deleted" not in w:
        return None
    rows = e.get("writes", 0) + w["rows_deleted"]
    return e["journal_syncs"] / rows if rows else None
