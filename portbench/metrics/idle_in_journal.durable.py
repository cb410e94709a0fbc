"""idle_in_journal.durable: share of the traced part in which the device
idles inside the program's journal spans (hippo.wal.append, the encode and
write of a record, and hippo.wal.sync, its fsync), %. Inside the
write-side spans these are the innermost, so this idle is left out of
idle_in_refresh.refresh. A program without these spans reads nothing."""
import pb_spans

PREFIX = "hippo.wal."


def read(run):
    st = pb_spans.read(run)
    if st is None or not any(n.startswith(PREFIX) for n in st.host_self_s):
        return None
    idle = sum(s for n, s in st.idle_by_span_s.items()
               if n.startswith(PREFIX))
    return idle / st.window_s * 100.0
