"""Reading a traced run: ``pb_trace.read_events`` and ``pb_spans`` on
hand-built event lists (times in microseconds), and the readers of
``idle_in_engine.scan`` and ``syncs_per_batch.scan`` in a traced run on
the CPU.

The hand-built part: a 100 us window, two batches, device work in five
pieces.

    device busy    [0,5] [14,16] [22,30] [45,55] [75,80]
    device idle    [5,14] [16,22] [30,45] [55,75] [80,100]          70 us
    batch spans    [10,40] [50,90]
      inside       convert [12,20], inspect [25,35]; convert [52,60],
                   readback [70,88]
    blocking calls 18 (convert), 72 (readback), 85 cudaMemcpy (readback),
                   95 (outside every span), 30 on another thread;
                   cudaMemcpyAsync at 86 blocks nothing
"""
import time

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

import pb_harness
import pb_registry
import pb_spans
import pb_trace

MAIN, OTHER = 1, 2


def _ev(name, a, b, device=False, thread=MAIN):
    return FunctionEvent(id=0, name=name, thread=thread, start_us=a, end_us=b,
                         device_type=DeviceType.CUDA if device
                         else DeviceType.CPU)


HARNESS = [_ev("pb.window", 0, 100), _ev("pb.batch", 9, 41),
           _ev("pb.batch", 49, 91),
           # the harness's spans are mirrored on the device
           _ev("pb.batch", 14, 30, device=True),
           _ev("pb.batch", 45, 80, device=True)]
DEVICE = [_ev("compact_inspect_kernel", 0, 5, device=True),
          _ev("batch_filter_kernel", 14, 16, device=True),
          _ev("compact_inspect_kernel", 22, 30, device=True),
          _ev("Memcpy HtoD", 45, 55, device=True),
          _ev("reduce_kernel", 75, 80, device=True)]
OPS = [_ev("aten::where", 1, 4),
       _ev("cudaStreamSynchronize", 18, 21),
       _ev("cudaStreamSynchronize", 30, 31, thread=OTHER),
       _ev("cudaStreamSynchronize", 72, 73),
       _ev("cudaMemcpy", 85, 85.5),
       _ev("cudaMemcpyAsync", 86, 86.5),
       _ev("cudaStreamSynchronize", 95, 96)]
SPANS = [_ev("hippo.engine.batch", 10, 40), _ev("hippo.index.convert", 12, 20),
         _ev("hippo.index.inspect", 25, 35),
         _ev("hippo.engine.batch", 50, 90), _ev("hippo.index.convert", 52, 60),
         _ev("hippo.engine.readback", 70, 88)]
MIRRORS = [_ev("hippo.engine.batch", 14, 30, device=True),
           _ev("hippo.index.inspect", 22, 30, device=True),
           _ev("hippo.engine.batch", 45, 80, device=True)]


def _gap_lengths(trace):
    return sorted(s for _, s in trace.idle_gaps)


def test_the_program_spans_leave_the_device_reading_unchanged():
    without = pb_trace.read_events(HARNESS + DEVICE + OPS)
    with_spans = pb_trace.read_events(HARNESS + DEVICE + OPS + SPANS)
    for t in (without, with_spans):
        assert t.window_s == pytest.approx(100e-6)
        assert t.busy_s == pytest.approx(30e-6)
    assert with_spans.kernel_seconds("compact_inspect_kernel") == \
        without.kernel_seconds("compact_inspect_kernel") == \
        pytest.approx(13e-6)
    assert _gap_lengths(with_spans) == _gap_lengths(without)
    # pb_spans skips device-side mirrors of the program's spans too
    a = pb_spans.read_stages(HARNESS + DEVICE + OPS + SPANS)
    b = pb_spans.read_stages(HARNESS + DEVICE + OPS + SPANS + MIRRORS)
    assert a.table() == b.table()
    assert a.idle_s == pytest.approx(70e-6)


def test_idle_and_blocking_calls_put_down_to_stages_by_hand():
    st = pb_spans.read_stages(HARNESS + DEVICE + OPS + SPANS)
    assert st.batches == 2
    assert st.idle_in_batches_s == pytest.approx(50e-6)
    assert st.syncs_in_batches == 3
    idle = {k: v * 1e6 for k, v in st.idle_by_span_s.items()}
    # [16,22] and [55,75] each fall across two or three stages
    assert idle == pytest.approx({pb_spans.OUTSIDE: 20.0,
                                  "hippo.engine.batch": 21.0,
                                  "hippo.index.convert": 11.0,
                                  "hippo.index.inspect": 5.0,
                                  "hippo.engine.readback": 13.0})
    assert sum(idle.values()) == pytest.approx(70.0)
    host = {k: v * 1e6 for k, v in st.host_self_s.items()}
    assert host == pytest.approx({pb_spans.OUTSIDE: 30.0,
                                  "hippo.engine.batch": 26.0,
                                  "hippo.index.convert": 16.0,
                                  "hippo.index.inspect": 10.0,
                                  "hippo.engine.readback": 18.0})
    assert st.syncs_by_span == {"hippo.index.convert": 1,
                                "hippo.engine.readback": 2,
                                pb_spans.OUTSIDE: 2}
    table = st.table()
    assert table["device_idle_pct"] == pytest.approx(70.0)
    assert table["per_batch"]["hippo.engine.readback"]["syncs"] == 1.0
    assert table["per_batch"]["hippo.index.convert"]["idle_ms"] == \
        pytest.approx(5.5e-3)
    assert sum(r["idle_pct"] for r in table["per_batch"].values()) == \
        pytest.approx(table["device_idle_pct"])


def test_gap_labels_name_the_innermost_program_span():
    st = pb_spans.read_stages(HARNESS + DEVICE + OPS + SPANS)
    labels = {round(s * 1e6, 6): label for label, s in st.gaps}
    assert labels[6.0] == \
        "pb.batch > hippo.index.convert > cudaStreamSynchronize"
    assert labels[9.0] == "pb.batch"
    assert labels[15.0] == "pb.batch > hippo.engine.batch"
    assert len(st.gaps) == 5


@pytest.mark.parametrize("metric,events,value", [
    ("idle_in_engine.scan", HARNESS + DEVICE + OPS + SPANS, 50.0),
    ("syncs_per_batch.scan", HARNESS + DEVICE + OPS + SPANS, 1.5),
    ("idle_in_engine.scan", HARNESS + DEVICE + OPS, None),
    ("syncs_per_batch.scan", HARNESS + DEVICE + OPS, None),
])
def test_the_readers_find_the_run_s_profiler(metric, events, value):
    """A program without spans (an earlier commit) reads None."""

    class Done:
        def events(self):
            return events

    tracer = pb_trace.Tracer()
    tracer._done = Done()
    run = pb_harness.Run(setup_s=1.0, trace=pb_trace.read_events(events))
    lines = []
    pb_spans.read(run, log=lines.append)
    assert [s.startswith("stages: ") for s in lines] == \
        ([True] if value is not None else [])
    got = pb_registry.load_reader(metric)(run)
    assert got == (pytest.approx(value) if value is not None else None)
    assert pb_spans.read(pb_harness.Run(setup_s=1.0)) is None   # untraced


def test_a_traced_run_on_the_cpu_reads_the_program_spans(monkeypatch,
                                                          tiny):
    """Through the harness: the readers get the traced part's events with
    the program's spans in them; with no device the metrics read nothing
    and the line leaves them out."""
    seen = []
    orig = pb_spans.read_stages

    def read_stages(events):
        seen.append({e.name for e in events if e.name.startswith("hippo.")})
        return orig(events)
    monkeypatch.setattr(pb_spans, "read_stages", read_stages)
    cell = tiny(pb_registry.find_cell("dbgen.scan"), rows=6000)
    out = pb_harness.run_cell(cell, 987654321987, 0.6, True, "cpu",
                              time.perf_counter(), log=lambda s: None)
    assert out["correct"]
    assert len(seen) == 2            # once for each of the two readers
    for names in seen:
        assert {"hippo.engine.batch", "hippo.index.convert",
                "hippo.engine.readback"} <= names
    assert "idle_in_engine.scan" not in out["metrics"]
    assert "syncs_per_batch.scan" not in out["metrics"]
    assert "batch_ms.scan" in out["metrics"]
