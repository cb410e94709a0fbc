"""idle_in_refresh.refresh: share of the traced part in which the device
idles inside the program's write-side spans (hippo.engine.write,
hippo.engine.delete_rows, hippo.engine.drain and hippo.writer.*), %. A
program without these spans reads nothing."""
import pb_spans

ENGINE_SPANS = ("hippo.engine.write", "hippo.engine.delete_rows",
                "hippo.engine.drain")
WRITER_PREFIX = "hippo.writer."


def _write_side(name: str) -> bool:
    return name in ENGINE_SPANS or name.startswith(WRITER_PREFIX)


def read(run):
    st = pb_spans.read(run)
    if st is None or not any(_write_side(n) for n in st.host_self_s):
        return None
    idle = sum(s for n, s in st.idle_by_span_s.items() if _write_side(n))
    return idle / st.window_s * 100.0
