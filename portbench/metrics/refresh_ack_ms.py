"""refresh_ack_ms: mean time from each refresh operation's due time to
its acknowledgement (an RF1 order with all of its writes, a `write` of a
stream that writes one row an operation, a delete), over every operation
due in the window (host clock). It holds the wait behind the batch or drain
the loop was running when the operation fell due, and the call itself. The
mean, since write and delete acknowledgements sit in two modes that a
median jumps between."""


def read(run):
    return float(run.write_ms.mean()) if run.write_ms.size else None
