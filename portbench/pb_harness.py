"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

The window drives the program's main path: ``repro_torch.runtime.engine.
QueryEngine`` (``submit``, ``run_batch``, and the configuration's refresh
stream, ``portbench/streams/``, issuing its writes and deletes) over a
``repro_torch.core.partition.ShardedHippoIndex`` in the engine's default
compact mode. One thread does everything, in this order at every turn of the
loop: the refresh operations that are due, the queries that are due (open
loop) or the top-up to the outstanding count (closed loop), then one
``run_batch`` if a query waits, else a sleep until the next due time. A
query's latency runs from its due time to the return of the batch that
answered it; a write's or a delete's from its due time to the return of the
call.

Every answer the engine gives, in the warm-up, the window and the drain
after it, is compared with ``pb_reference`` once the program's state is
freed.

A configuration's ``"engine"`` object adds ``QueryEngine`` keyword
arguments to the ones the harness sets (``engine_kwargs``). With
``"storage_dir": true`` the run gets a directory of its own under
``.portbench_cache/storage/`` (removed when the run ends, on failure too),
logs a ``storage:`` line, and after the drain closes the engine without a
save, recovers a new one from the directory and judges it at every
acknowledged operation: the check ``lost_on_recovery``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

import pb_bytes
import pb_data
import pb_reference
import pb_traffic
from pb_registry import Cell, load_reader, load_stream
from pb_trace import NULL_SPAN, Trace, Tracer

WARMUP_BATCHES = 8       # read batches before any write: the slab widens
WARMUP_ROWS = 512        # appends in the warm-up: every drain kind runs
DRAIN_WAIT_S = 60.0      # how long answers due in the window are awaited
TRACE_S = 3.0            # a traced run traces the window's first seconds
HARNESS_SETS = ("batch", "top_k", "drain_policy", "drain_units")


def clock() -> float:
    return time.perf_counter()


@dataclass
class Run:
    """What the metric readers read (``portbench/metrics/*.py``)."""
    setup_s: float
    window_s: float = 0.0
    reads_done: int = 0                 # queries answered inside the window
    read_ms: np.ndarray = None          # every query due in the window
    write_ms: np.ndarray = None         # every write and delete due in it
    delete_ms: np.ndarray = None        # delete() spans, the whole window
    # A traced run's spans and stats cover its traced part alone; an
    # untraced run's cover the window.
    batch_ms: np.ndarray = None         # run_batch spans
    stage_us: np.ndarray = None         # write() spans
    engine: dict = field(default_factory=dict)   # EngineStats deltas
    writer: dict = field(default_factory=dict)   # WriterStats deltas
    trace: Trace | None = None
    kernel_calls: dict = field(default_factory=dict)
    index_bytes: int = 0
    live_tuples: int = 0
    page_card: int = 0


def engine_kwargs(config: dict, mix: dict, storage_dir=None) -> dict:
    """The ``QueryEngine`` keyword arguments of a cell: the four the harness
    sets from the configuration and the mix, and the configuration's
    ``"engine"`` object, whose ``"storage_dir": true`` becomes
    ``storage_dir`` (the harness owns the path). Refuses a key the harness
    sets, ``writer``, a ``storage_dir`` other than true, and
    ``background_save`` beside it: ``QueryEngine.close`` flushes the
    persister, so the recovery check would see commits a crash loses."""
    kw = {"batch": int(config["batch"]),
          "top_k": int(mix["reads"].get("top_k", 0)),
          "drain_policy": config["drain_policy"],
          "drain_units": int(config["drain_units"])}
    extra = dict(config.get("engine") or {})
    for key in extra:
        if key in HARNESS_SETS or key == "writer":
            raise ValueError(f"{config['name']}: engine key {key!r} is the "
                             f"harness's to set")
    if "storage_dir" in extra:
        if extra["storage_dir"] is not True:
            raise ValueError(f"{config['name']}: engine key 'storage_dir' "
                             f"must be true (the harness gives the path), "
                             f"got {extra['storage_dir']!r}")
        if storage_dir is None:
            raise ValueError(f"{config['name']}: engine key 'storage_dir' "
                             f"needs the run's storage directory")
        if extra.get("background_save"):
            raise ValueError(f"{config['name']}: engine key "
                             f"'background_save' is refused with "
                             f"'storage_dir': closing the engine flushes "
                             f"the persister, which a crash does not")
        extra["storage_dir"] = storage_dir
    kw.update(extra)
    return kw


def _new_storage_dir(cell: Cell, seed: int) -> Path:
    """``.portbench_cache/storage/<cell>.<seed>.<pid>/`` in the checkout,
    fresh, after removing what runs whose process has ended left there."""
    base = cell.root / ".portbench_cache" / "storage"
    base.mkdir(parents=True, exist_ok=True)
    for old in base.iterdir():
        pid = old.name.rsplit(".", 1)[-1]
        if pid.isdigit() and not Path(f"/proc/{pid}").exists():
            shutil.rmtree(old, ignore_errors=True)
    path = base / f"{cell.name}.{seed}.{os.getpid()}"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir()
    return path


def _fs_type(path: Path) -> str:
    """The filesystem type of the mount that holds ``path``
    (``/proc/self/mounts``, the longest mount point above it)."""
    path = str(path.resolve())
    best, kind = "", "unknown"
    try:
        lines = Path("/proc/self/mounts").read_text().splitlines()
    except OSError:
        return kind
    for line in lines:
        f = line.split()
        if len(f) < 3:
            continue
        mnt = f[1].replace("\\040", " ")
        if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                and len(mnt) > len(best):
            best, kind = mnt, f[2]
    return f"{kind} at {best}" if best else kind


def _io_written() -> int | None:
    """The bytes this process has passed to write calls, ``wchar`` of
    ``/proc/self/io`` (its ``write_bytes`` reads 0 on a 9p root)."""
    try:
        lines = Path("/proc/self/io").read_text().splitlines()
    except OSError:
        return None
    for line in lines:
        k, _, v = line.partition(":")
        if k == "wchar":
            return int(v)
    return None


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _recover_and_probe(storage: Path, dev, kwargs: dict, days: int, sync
                       ) -> tuple[float, np.ndarray, np.ndarray, list]:
    """``QueryEngine.recover`` of the run's directory, timed, then one query
    a day of ``[0, days)`` and one over all of them; returns the seconds,
    the probe's bounds and its counts (None where none came)."""
    from repro_torch.core.predicate import Predicate
    from repro_torch.runtime.engine import QueryEngine
    kwargs = {k: v for k, v in kwargs.items() if k != "storage_dir"}
    t = clock()
    eng = QueryEngine.recover(storage, device=dev, snapshot_on_recover=False,
                              **kwargs)
    sync()
    recover_s = clock() - t
    lo = np.concatenate([np.arange(days), [0]]).astype(np.int64)
    hi = np.concatenate([np.arange(days), [days - 1]]).astype(np.int64)
    tickets = [eng.submit(Predicate.between(float(a), float(b)))
               for a, b in zip(lo.tolist(), hi.tolist())]
    try:
        eng.drain()
    finally:
        eng.close()
    counts = [t.count if t.done else None for t in tickets]
    del eng, tickets
    gc.collect()
    return recover_s, lo, hi, counts


def _stats(obj) -> dict:
    return {k: v for k, v in dataclasses.asdict(obj).items()
            if isinstance(v, (int, float))}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _engine_stats(eng) -> tuple[dict, dict]:
    return (_stats(eng.stats), _stats(eng.writer.stats) if eng.writer
            else {})


class _Recorder:
    """Records the argument shapes of kernels A (and its unsharded form,
    which shares the kernel's name) and B while tracing."""

    def __init__(self, hix, tracer: Tracer):
        self.calls = {"compact_inspect": [], "batch_filter_sharded": [],
                      "batch_filter_unsharded": []}
        self._hix = hix
        self._orig = (hix.compact_inspect, hix.batch_filter_sharded,
                      hix.batch_filter)
        ci, bf, bfu = self._orig

        def compact_inspect(keys, valid, sel, sel_mask, los, his):
            if tracer.recording:
                s, q, m = sel_mask.shape
                self.calls["compact_inspect"].append((s, q, m))
            return ci(keys, valid, sel, sel_mask, los, his)

        def batch_filter_sharded(queries, entries, live):
            if tracer.recording:
                s, q, w = queries.shape
                self.calls["batch_filter_sharded"].append(
                    (s, q, entries.shape[1], w))
            return bf(queries, entries, live)

        def batch_filter(queries, entries, live):
            if tracer.recording:
                q, w = queries.shape
                self.calls["batch_filter_unsharded"].append(
                    (1, q, entries.shape[0], w))
            return bfu(queries, entries, live)

        hix.compact_inspect = compact_inspect
        hix.batch_filter_sharded = batch_filter_sharded
        hix.batch_filter = batch_filter

    def restore(self) -> None:
        (self._hix.compact_inspect, self._hix.batch_filter_sharded,
         self._hix.batch_filter) = self._orig


class Driver:
    """The engine, the refresh stream's position and the log of answers."""

    def __init__(self, eng, stream, queries, top_k: int, tracer: Tracer):
        from repro_torch.core.predicate import Predicate
        self.pred = Predicate.between
        self.eng = eng
        self.stream = stream
        self.queries = queries
        self.top_k = top_k
        self.tracer = tracer
        self.n_ops = 0              # refresh operations acknowledged
        self.lo: list = []          # per qid
        self.hi: list = []
        self.due: list = []         # per qid: due time (None: closed loop)
        self.done_at: dict = {}     # qid -> time of its answer
        self.log: list = []         # (n_ops, qids, counts, row_ids)

    @property
    def waiting(self) -> int:
        e = self.eng
        return len(e.queue) + sum(t is not None for t in e.slots)

    def submit(self, lo: int, hi: int, due=None) -> None:
        self.eng.submit(self.pred(float(lo), float(hi)))
        self.lo.append(lo)
        self.hi.append(hi)
        self.due.append(due)

    def top_up(self, n: int) -> None:
        """Submit n queries placed on the days as they stand now."""
        if n <= 0:
            return
        lo, hi = self.queries.take(n, self.stream.newest_day(self.n_ops))
        for a, b in zip(lo.tolist(), hi.tolist()):
            self.submit(a, b)

    def apply_op(self) -> tuple[str, float, float]:
        """Acknowledge the next refresh operation; returns its kind, start
        and end."""
        k = self.n_ops
        span = "pb.write" if self.stream.op(k)[0] == "w" else "pb.delete"
        t0 = clock()
        with self.tracer.span(span):
            kind = self.stream.issue(self.eng, k)
        t1 = clock()
        self.n_ops += 1
        return kind, t0, t1

    def batch(self) -> tuple[float, float, int]:
        t0 = clock()
        with self.tracer.span("pb.batch"):
            finished = self.eng.run_batch()
        t1 = clock()
        qids = [t.qid for t in finished]
        for q in qids:
            self.done_at[q] = t1
        self.log.append((self.n_ops, qids, [t.count for t in finished],
                         [t.row_ids for t in finished] if self.top_k
                         else None))
        return t0, t1, len(finished)

    def answers(self) -> list:
        """The log as the reference's batches; queries never answered come
        last, with no count."""
        lo = np.asarray(self.lo, np.int64)
        hi = np.asarray(self.hi, np.int64)
        out = []
        for n_ops, qids, counts, ids in self.log:
            q = np.asarray(qids, np.int64)
            out.append((n_ops, lo[q], hi[q], self.top_k, counts,
                        ids if ids is not None else [None] * len(q)))
        lost = [q for q in range(len(self.lo)) if q not in self.done_at]
        if lost:
            q = np.asarray(lost, np.int64)
            out.append((self.n_ops, lo[q], hi[q], self.top_k,
                        [None] * len(q), [None] * len(q)))
        return out


def _power_limit() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
            else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _warm_up(drv: Driver, has_writes: bool, batch: int) -> None:
    """Every path the window takes, once: the slab bucket's widening and
    fallback, and with writes every drain kind (the drift remap of each
    shard, the insert queue with its slab patch, the retention delete's
    vacuum) and the staged overlay."""
    for _ in range(WARMUP_BATCHES):
        drv.top_up(batch)
        drv.batch()
    if has_writes:
        target = drv.stream.ops_for_rows(WARMUP_ROWS)
        while drv.n_ops < target:
            for _ in range(min(64, target - drv.n_ops)):
                drv.apply_op()
            drv.top_up(batch)
            drv.batch()
        for _ in range(64):
            if not drv.eng.writer.pending_units:
                break
            drv.top_up(batch)
            drv.batch()
    for _ in range(4):
        drv.top_up(batch)
        drv.batch()


def _window(drv: Driver, seconds: float, mix: dict, read_due, read_lo,
            read_hi, op_due, tracer: Tracer | None, on_trace=None) -> dict:
    """The measured window. ``read_due``/``op_due``: due times (seconds from
    the window's start) of the open loop's queries and of the refresh
    operations; ``read_due`` None for a closed loop.

    With a tracer, the profiler starts before the window and the window's
    first ``TRACE_S`` seconds are the traced part; stopping the profiler
    then stalls the host while it parses the trace, so the rest of the
    window serves the check alone and the spans come from the traced
    part."""
    closed = read_due is None
    outstanding = int(mix["reads"].get("outstanding", 0))
    qi = oi = 0
    rec = {"read_late": [], "op_late": [], "write_ms": [], "stage_us": [],
           "delete_ms": [], "batch_ms": [], "backlog": [], "reads_done": 0,
           "qids": []}
    traced = tracer is not None
    if traced:
        tracer.start()
        on_trace["before"] = _engine_stats(drv.eng)
        tracer.begin()
    t0 = clock()
    end = t0
    while True:
        now = clock() - t0
        if now >= seconds:
            break
        if traced and tracer.recording and now >= min(TRACE_S, seconds):
            on_trace["after"] = _engine_stats(drv.eng)
            tracer.stop()
        keep = not traced or tracer.recording
        while oi < len(op_due) and op_due[oi] <= now:
            kind, a, b = drv.apply_op()
            rec["op_late"].append(a - t0 - op_due[oi])
            rec["write_ms"].append((b - t0 - op_due[oi]) * 1e3)
            if kind == "d":
                rec["delete_ms"].append((b - a) * 1e3)
            elif keep:
                rec["stage_us"].append((b - a) * 1e6)
            oi += 1
            now = clock() - t0
        if closed:
            drv.top_up(outstanding - drv.waiting)
        else:
            while qi < len(read_due) and read_due[qi] <= now:
                rec["read_late"].append(clock() - t0 - read_due[qi])
                rec["qids"].append(len(drv.lo))
                drv.submit(int(read_lo[qi]), int(read_hi[qi]),
                           due=t0 + read_due[qi])
                qi += 1
        if drv.waiting:
            a, b, n = drv.batch()
            end = b
            rec["reads_done"] += n
            if keep:
                rec["batch_ms"].append((b - a) * 1e3)
            rec["backlog"].append((b - t0, drv.waiting))
        else:
            nxt = min([seconds]
                      + ([op_due[oi]] if oi < len(op_due) else [])
                      + ([read_due[qi]] if not closed and qi < len(read_due)
                         else []))
            with (tracer.span("pb.wait") if tracer else NULL_SPAN):
                time.sleep(max(0.0, nxt - (clock() - t0)))
            end = clock()
    if traced and tracer.recording:
        on_trace["after"] = _engine_stats(drv.eng)
        tracer.stop()
    rec["window_s"] = max(end - t0, 1e-9)
    rec["ops_in_window"] = oi
    rec["reads_in_window"] = qi if not closed else None
    return rec


def _drain(drv: Driver, limit_s: float) -> None:
    """Answer what is still queued, a minute past the close at most."""
    t0 = clock()
    while drv.waiting and clock() - t0 < limit_s:
        drv.batch()


def _open_schedule(drv: Driver, mix: dict, seconds: float, seed: int,
                   rate_qps: float | None = None):
    """Due times of the window's refresh operations and queries, and the
    queries, placed on the days as the refresh stream leaves them at each
    query's due time."""
    w = mix.get("writes")
    if w:
        row_due = pb_traffic.arrivals(float(w["rate_rows_per_s"]), seconds,
                                      seed, pb_traffic.WRITE_GAPS)
        op_due = drv.stream.due(row_due, drv.n_ops)
    else:
        op_due = np.zeros((0,), np.float64)
    r = mix["reads"]
    if r["loop"] == "closed":
        return op_due, None, None, None
    rate = float(rate_qps if rate_qps is not None else r["rate_qps"])
    read_due = pb_traffic.arrivals(rate, seconds, seed,
                                   pb_traffic.READ_GAPS)
    n_before = drv.n_ops + np.searchsorted(op_due, read_due, side="right")
    newest = np.asarray([drv.stream.newest_day(int(n)) for n in n_before],
                        np.int64)
    lo, hi = drv.queries.take(len(read_due), newest)
    return op_due, read_due, lo, hi


def _pcts(x) -> str:
    if not len(x):
        return "none"
    x = np.asarray(x) * 1e3
    return f"median {np.median(x):.3f} ms, max {x.max():.3f} ms"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process, *, control: str | None = None,
             sweep: list | None = None, log=print) -> dict:
    """Run the cell once and return its result line (a dict). ``t_process``
    is the process's start on ``clock()``, or a dict of the start
    (``"start"``) and the later marks of the entry point. ``control``
    ``"bf16"`` judges the reference at bfloat16 in the program's place;
    ``sweep`` (read rates) runs one open-loop window per rate instead of the
    cell's own rate and reports each."""
    marks = t_process if isinstance(t_process, dict) \
        else {"start": t_process}
    t_process = last = marks["start"]
    parts = {}
    for k, t in marks.items():
        if k != "start":
            parts[k], last = t - last, t
    from repro_torch.core import index as hix
    from repro_torch.core.partition import ShardedHippoIndex
    from repro_torch.runtime.engine import QueryEngine
    from repro_torch.storage.table import PagedTable
    parts["import_program_s"] = clock() - last

    dev = torch.device(device)
    on_gpu = dev.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    t = clock()
    if on_gpu:
        from repro_torch.kernels import _build
        _build.library()
        log(f"device: {torch.cuda.get_device_name(0)}; {_power_limit()}")
    parts["kernel_library_s"] = clock() - t

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    has_writes = bool(mix.get("writes"))
    if has_writes and "refresh_stream" not in cfg:
        raise ValueError(f"{cell.name}: its mix writes, and its configuration "
                         f"names no refresh_stream")
    t = clock()
    data = pb_data.make_column(cfg, seed, dev)
    column = data.keys
    parts["data_s"] = clock() - t
    t = clock()
    table = PagedTable.from_values(column, page_card=int(cfg["page_card"]),
                                   spare_pages=int(cfg.get("spare_pages", 0)))
    sidx = ShardedHippoIndex.create(
        table, num_shards=int(cfg["num_shards"]),
        resolution=int(cfg["resolution"]), density=float(cfg["density"]),
        device=dev)
    sync()
    parts["upload_and_build_s"] = clock() - t
    top_k = int(mix["reads"].get("top_k", 0))
    storage = _new_storage_dir(cell, seed) \
        if (cfg.get("engine") or {}).get("storage_dir") is True else None
    tracer = Tracer()
    recorder = probe = None
    try:
        kwargs = engine_kwargs(cfg, mix, storage)
        eng = QueryEngine(sidx, **kwargs)
        recorder = _Recorder(hix, tracer) if trace else None
        stream = load_stream(cfg, seed, data, cell.root)
        drv = Driver(eng, stream, pb_traffic.Queries(mix, seed), top_k,
                     tracer)
        t = clock()
        _warm_up(drv, has_writes, int(cfg["batch"]))
        sync()
        parts["warm_up_s"] = clock() - t
        windows = []
        rates = sweep if sweep else [None]
        for rate in rates:
            op_due, read_due, read_lo, read_hi = _open_schedule(
                drv, mix, seconds, seed, rate)
            gc.collect()
            gc.freeze()
            if not windows:
                setup_s = clock() - t_process
                log("setup: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in parts.items())
                    + f"; setup_s {setup_s:.3f}")
            before = _engine_stats(eng)
            on_trace = {}
            io = _io_written() if storage is not None else None
            rec = _window(drv, seconds, mix, read_due, read_lo, read_hi,
                          op_due, tracer if trace and not sweep else None,
                          on_trace)
            if io is not None:
                rec["written"] = _io_written() - io
            if "after" in on_trace:
                before, after = on_trace["before"], on_trace["after"]
            else:
                after = _engine_stats(eng)
            rec["engine"] = _delta(after[0], before[0])
            rec["writer"] = _delta(after[1], before[1])
            rec["rate"] = rate
            _report_window(rec, drv, log)
            if sweep:
                _drain(drv, DRAIN_WAIT_S)
                log("sweep: " + json.dumps(_sweep_row(rec, drv)))
            windows.append(rec)
        _drain(drv, DRAIN_WAIT_S)
        sync()
        rec = windows[-1]
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        st = sidx.state.shards
        live = st.slot_live.sum(dim=1).cpu().tolist()
        index_bytes = pb_bytes.index_nbytes(
            st.num_entries.cpu().tolist(), live, sidx.cfg.words,
            int(st.bounds.shape[1]), sidx.spec.num_shards)
        answers = drv.answers()
        n_ops = drv.n_ops
        if storage is not None:
            # no save and staged rows undrained, as a crash leaves them;
            # close() would flush a persister, so engine_kwargs refuses
            # background_save here
            persists = eng.stats.persists
            eng.close()
        del eng, sidx, table, drv.eng
        gc.unfreeze()
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
        if storage is not None:
            dir_bytes = _dir_bytes(storage)
            recover_s, lo, hi, counts = _recover_and_probe(
                storage, dev, kwargs, stream.newest_day(n_ops) + 1, sync)
            probe = (n_ops, lo, hi, 0, counts, [None] * len(counts))
            if on_gpu:
                torch.cuda.empty_cache()
            log(f"storage: {_fs_type(storage)}; the window wrote "
                f"wchar {rec.get('written')} B; directory {dir_bytes} B after "
                f"the drain; persists {persists} ("
                f"{rec['engine'].get('persists', 0)} in the window); "
                f"recover_s {recover_s:.3f}")
    finally:
        if recorder is not None:
            recorder.restore()
        if storage is not None:
            shutil.rmtree(storage, ignore_errors=True)

    # -- the check, once the program's state is freed --------------------------
    t = clock()
    ref = pb_reference.Reference(column, stream, n_ops, dev, top_k=top_k)
    if control == "bf16":
        ctl = pb_reference.Reference(column, stream, n_ops, dev,
                                     key_dtype=torch.bfloat16, top_k=top_k)
        answers = pb_reference.control_answers(ctl, answers)
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    checks = pb_reference.judge(ref, answers)
    if probe is not None:
        got = pb_reference.judge(ref, [probe])
        checks["lost_on_recovery"] = got["wrong_counts"] \
            + got["missing_answers"]
    log(f"reference: {len(answers)} batches judged in "
        f"{clock() - t:.3f} s")

    if sweep:
        return {"sweep": [_sweep_row(r, drv) for r in windows],
                "checks": {k: {"value": v, "limit": 0}
                           for k, v in checks.items()}}

    qids = rec["qids"]
    run = Run(setup_s=setup_s, window_s=rec["window_s"],
              reads_done=rec["reads_done"], read_ms=_read_ms(rec, drv),
              write_ms=np.asarray(rec["write_ms"]),
              delete_ms=np.asarray(rec["delete_ms"]),
              batch_ms=np.asarray(rec["batch_ms"]),
              stage_us=np.asarray(rec["stage_us"]),
              engine=rec["engine"], writer=rec["writer"],
              trace=tracer.result(),
              kernel_calls=recorder.calls if recorder else {},
              index_bytes=index_bytes, live_tuples=ref.live_tuples,
              page_card=int(cfg["page_card"]))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader(m["name"], cell.root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    reads = len(qids) if rec["reads_in_window"] is not None \
        else rec["reads_done"]
    attempted = reads + rec["ops_in_window"]
    failed = checks["wrong_counts"] + checks["wrong_row_ids"] \
        + checks["missing_answers"] + checks.get("lost_on_recovery", 0)
    device_info = {"platform": "gpu" if on_gpu else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    tr = run.trace
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return out


def _report_window(rec: dict, drv: Driver, log) -> None:
    bl = rec["backlog"]
    w = rec["window_s"]
    marks = []
    for frac in (0.25, 0.5, 0.75, 1.0):
        before = [n for t, n in bl if t <= frac * w]
        marks.append(before[-1] if before else 0)
    grew = all(b > a for a, b in zip(marks, marks[1:])) and marks[-1] > 64
    log(f"window: {w:.3f} s; reads lateness {_pcts(rec['read_late'])}; "
        f"refresh lateness {_pcts(rec['op_late'])}; backlog at quarters "
        f"{marks}, {drv.waiting} waiting at the close"
        + ("; THE BACKLOG GREW ALL THROUGH THE WINDOW" if grew else ""))
    rec["backlog_marks"] = marks
    rec["grew"] = grew


def _read_ms(rec: dict, drv: Driver) -> np.ndarray:
    """Latency of every query due in the open loop's window, from its due
    time to its answer; answers never given are left to the check."""
    return np.asarray([(drv.done_at[q] - drv.due[q]) * 1e3
                       for q in rec["qids"] if q in drv.done_at])


def _sweep_row(rec: dict, drv: Driver) -> dict:
    w = rec["window_s"]
    ms = _read_ms(rec, drv)
    return {"rate_qps": rec["rate"], "offered": len(rec["qids"]),
            "answered_in_window_qps": rec["reads_done"] / w,
            "read_p50_ms": float(np.percentile(ms, 50)) if ms.size else None,
            "read_p95_ms": float(np.percentile(ms, 95)) if ms.size else None,
            "backlog_at_quarters": rec["backlog_marks"],
            "grew": rec["grew"], "batches": len(rec["backlog"]),
            "ops": rec["ops_in_window"]}
