"""journal_sync_ms.durable: the mean host time of one journal fsync in the
traced part, EngineStats journal_sync_us over journal_syncs, in ms. A
program without these counters, or a traced part with no fsync, reads
nothing."""


def read(run):
    e = run.engine
    if "journal_sync_us" not in e or not e.get("journal_syncs"):
        return None
    return e["journal_sync_us"] / e["journal_syncs"] / 1e3
