"""Write-ahead journal for staged index maintenance (a copy of
``repro.checkpointing.wal``, which the port cannot import; both packages
write and replay the same journal files).

The async writer (``runtime.writer.MaintenanceWriter``) acknowledges a
write the moment it is staged — long before a drain applies it to the
table and index. The journal makes that acknowledgement durable:
*append before admission*. Every staged insert, every delete, and every
scheduled re-summarization appends one fsynced record here before the
writer mutates any in-memory state, so a crash at any point loses no
acknowledged operation: recovery loads the last committed snapshot and
replays the journal suffix (``checkpointing.snapshot.recover_index``).

Layout under ``<root>/wal/``: one append-only file per shard for inserts
(``shard_<k>.log`` — inserts are the high-rate stream and route to exactly
one shard) plus ``global.log`` for deletes and re-summarizations (both are
inherently cross-shard). A global monotonically increasing sequence number
stamps every record, so replay merges the files back into the exact
admission order.

Record kinds: the reference's three (one insert, a delete by key range, a
re-summarization) and two of the port's own, both in ``global.log``: a
group insert (``append_insert_group``: one transaction's rows, each its
shard and value, so a torn tail drops the whole group and never part of
it) and a delete by row id (``append_row_delete``: the ids). A journal
that holds neither is byte-identical to the reference's; the reference
stops its replay at a record of either, as at any unknown kind.

Record framing (little-endian)::

    [crc32 u32][payload_len u32][seqno u64][kind u8][payload ...]

The CRC covers seqno + kind + payload. A torn tail — a record cut mid-way
by a crash — fails the length or CRC check and terminates that file's
replay at the last good record; records are fsynced one at a time, so the
only record that can ever be torn is the one being appended at the moment
of the crash, which was by definition not yet acknowledged.

Truncation: ``reset()`` empties every journal file. It is called only
*after* a snapshot commits (the snapshot captures the writer's staged
queues, so the journal's history is redundant from that point). Sequence
numbers keep increasing across resets, and the snapshot records the
``last_seqno`` watermark at its commit; replay skips records at or below
the watermark, so a crash *between* snapshot commit and journal reset can
never double-apply an operation.

``truncate_through(seqno)`` is the watermark-aware form the background
persister needs: when a snapshot commits *asynchronously*, the foreground
may have appended records past the snapshot's watermark by the time the
commit callback runs — ``reset()`` would destroy those still-unsnapshotted
acknowledgements. ``truncate_through`` rewrites each file keeping only the
records past the watermark, each file committed by an atomic rename; a
crash mid-truncate leaves some files trimmed and some not, which replay
tolerates because every surviving record at or below the watermark is
filtered by the watermark discipline anyway. Appends and truncations can
race across threads (engine foreground vs. persister commit callback), so
both run under one internal lock.

An append's sync is ``os.fdatasync`` where the platform has it (Linux),
else ``os.fsync``: the record's bytes and the file's new length reach the
disk before the append returns, and its timestamps need not, as under
PostgreSQL's default ``wal_sync_method`` on Linux. Resets and truncations
still fsync whole files and the directory.

``stats()`` counts the appends' syncs and the host time inside them;
under a running profiler each append records the spans
``hippo.wal.append`` (encode and write) and ``hippo.wal.sync`` (the
sync).
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.runtime.faultinject import crashpoint
from repro_torch.spans import span

_FRAME = struct.Struct("<IIQB")      # crc32, payload_len, seqno, kind

KIND_INSERT = 1       # payload: <If  shard, value
KIND_DELETE = 2       # payload: <ff  lo, hi
KIND_RESUM = 3        # payload: <B   policy id, then (H+1,) f32 bounds
# the port's own kinds (the reference has neither)
KIND_INSERT_GROUP = 4  # payload: n x <If  shard, value (n >= 1)
KIND_ROW_DELETE = 5    # payload: n x <q   row id (n >= 1)

_INSERT = struct.Struct("<If")
_DELETE = struct.Struct("<ff")
_GROUP = np.dtype([("shard", "<u4"), ("value", "<f4")])   # _INSERT's rows
_ROW_ID = np.dtype("<i8")

# Policy ids are part of the on-disk format: append-only.
_POLICY_IDS = {"equal_mass": 0, "learned": 1}
_POLICY_NAMES = {v: k for k, v in _POLICY_IDS.items()}

_MAX_PAYLOAD = 1 << 24     # sanity bound: no record carries >16 MiB
_sync_record = getattr(os, "fdatasync", os.fsync)


@dataclass(frozen=True)
class WalRecord:
    """One replayable operation, decoded."""
    seqno: int
    kind: int
    shard: int | None = None          # KIND_INSERT
    value: float | None = None        # KIND_INSERT
    lo: float | None = None           # KIND_DELETE
    hi: float | None = None           # KIND_DELETE
    policy: str | None = None         # KIND_RESUM
    bounds: np.ndarray | None = None  # KIND_RESUM
    shards: np.ndarray | None = None  # KIND_INSERT_GROUP: (n,) u32
    values: np.ndarray | None = None  # KIND_INSERT_GROUP: (n,) f32
    row_ids: np.ndarray | None = None  # KIND_ROW_DELETE: (n,) int64


@dataclass
class JournalStats:
    """The appends' fsyncs and the host seconds inside them."""
    syncs: int = 0
    sync_s: float = 0.0


def _decode(seqno: int, kind: int, payload: bytes) -> WalRecord | None:
    if kind == KIND_INSERT and len(payload) == _INSERT.size:
        shard, value = _INSERT.unpack(payload)
        return WalRecord(seqno, kind, shard=shard, value=value)
    if kind == KIND_DELETE and len(payload) == _DELETE.size:
        lo, hi = _DELETE.unpack(payload)
        return WalRecord(seqno, kind, lo=lo, hi=hi)
    if kind == KIND_RESUM and len(payload) >= 1 \
            and (len(payload) - 1) % 4 == 0:
        policy = _POLICY_NAMES.get(payload[0])
        bounds = np.frombuffer(payload, np.float32, offset=1).copy()
        if policy is not None and bounds.size:
            return WalRecord(seqno, kind, policy=policy, bounds=bounds)
    if kind == KIND_INSERT_GROUP and payload \
            and len(payload) % _GROUP.itemsize == 0:
        rows = np.frombuffer(payload, _GROUP)
        return WalRecord(seqno, kind, shards=rows["shard"].copy(),
                         values=rows["value"].copy())
    if kind == KIND_ROW_DELETE and payload \
            and len(payload) % _ROW_ID.itemsize == 0:
        return WalRecord(seqno, kind,
                         row_ids=np.frombuffer(payload, _ROW_ID).copy())
    return None      # unknown kind / malformed payload: treat as torn


class Journal:
    """Append-only per-shard WAL under ``<root>/wal/``.

    ``sync=False`` skips the per-append fsync (benchmarks measuring
    in-memory paths); durability-bearing callers keep the default.
    """

    def __init__(self, root: str | Path, num_shards: int, *,
                 sync: bool = True):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.dir = Path(root) / "wal"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.num_shards = num_shards
        self.sync = sync
        # appends (engine foreground) and truncations (persister commit
        # callback) may run on different threads; file state is guarded
        self._lock = threading.Lock()
        self._handles: dict[str, object] = {}  # guarded-by: _lock
        self._stats = JournalStats()  # guarded-by: _lock
        # resume seqno allocation after the highest surviving record, so
        # post-recovery appends always order after everything on disk
        records = self.replay()
        self._next_seqno = (records[-1].seqno + 1) if records else 1

    # -- file plumbing -------------------------------------------------------

    def _filenames(self) -> list[str]:
        return [f"shard_{s}.log" for s in range(self.num_shards)] + \
            ["global.log"]

    def _handle(self, name: str):  # requires-lock: _lock
        h = self._handles.get(name)
        if h is None or h.closed:
            # unbuffered: each write is one syscall, with nothing to flush
            h = open(self.dir / name, "ab", buffering=0)
            self._handles[name] = h
        return h

    def _append(self, name: str, kind: int, payload: bytes) -> int:
        if len(payload) > _MAX_PAYLOAD:
            # replay would read it as a torn tail: refuse it unwritten
            raise ValueError(f"journal record of {len(payload)} B is over "
                             f"the {_MAX_PAYLOAD} B a record may carry")
        crashpoint("wal.pre_append")
        with self._lock:
            seqno = self._next_seqno
            with span("hippo.wal.append"):
                crc = _crc(seqno, kind, payload)
                h = self._handle(name)
                frame = memoryview(
                    _FRAME.pack(crc, len(payload), seqno, kind) + payload)
                while frame:
                    frame = frame[h.write(frame):]
            if self.sync:
                with span("hippo.wal.sync"):
                    t = time.perf_counter()
                    _sync_record(h.fileno())
                    self._stats.sync_s += time.perf_counter() - t
                self._stats.syncs += 1
            self._next_seqno += 1
            return seqno

    def stats(self) -> JournalStats:
        """A copy of the fsync counters since this object was made."""
        with self._lock:
            return JournalStats(self._stats.syncs, self._stats.sync_s)

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:  # requires-lock: _lock
        for h in self._handles.values():
            if not h.closed:
                h.close()
        self._handles.clear()

    # -- append (one call per acknowledged operation) ------------------------

    def append_insert(self, shard: int, value: float) -> int:
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} outside [0, {self.num_shards})")
        return self._append(f"shard_{shard}.log", KIND_INSERT,
                            _INSERT.pack(shard, float(value)))

    def append_delete(self, lo: float, hi: float) -> int:
        return self._append("global.log", KIND_DELETE,
                            _DELETE.pack(float(lo), float(hi)))

    def append_resummarize(self, bounds, policy: str = "equal_mass") -> int:
        pid = _POLICY_IDS.get(policy)
        if pid is None:
            raise ValueError(f"unknown summary policy {policy!r}")
        b = np.ascontiguousarray(np.asarray(bounds, np.float32).ravel())
        if b.size == 0:
            raise ValueError("resummarize record needs a non-empty bounds "
                             "array")
        return self._append("global.log", KIND_RESUM,
                            bytes([pid]) + b.tobytes())

    def append_insert_group(self, shards, values) -> int:
        """One record for rows staged together (an order's lineitems):
        each row's shard and value, in staging order. Replay restages all
        of them or, if the record is torn, none."""
        s = [int(x) for x in shards]
        v = [float(x) for x in values]
        if not s or len(s) != len(v):
            raise ValueError(f"a group insert record needs one shard a "
                             f"value and at least one row, got {len(s)} "
                             f"shards and {len(v)} values")
        if min(s) < 0 or max(s) >= self.num_shards:
            raise ValueError(f"group insert shards outside "
                             f"[0, {self.num_shards})")
        return self._append("global.log", KIND_INSERT_GROUP,
                            _group_payload(s, v))

    def append_row_delete(self, row_ids) -> int:
        """One record for a delete by row id: the ids, as given."""
        ids = np.ascontiguousarray(np.asarray(row_ids, _ROW_ID).ravel())
        if ids.size == 0:
            raise ValueError("a row delete record needs at least one id")
        return self._append("global.log", KIND_ROW_DELETE, ids.tobytes())

    # -- replay --------------------------------------------------------------

    def replay(self, after: int = 0) -> list[WalRecord]:
        """Every surviving record with ``seqno > after``, in admission
        (sequence-number) order. Torn tails are dropped per file; they can
        only ever be the final, unacknowledged append of a crashed process.
        """
        records: list[WalRecord] = []
        for name in self._filenames():
            path = self.dir / name
            if path.exists():
                records.extend(_scan_file(path))
        records.sort(key=lambda r: r.seqno)
        return [r for r in records if r.seqno > after]

    @property
    def last_seqno(self) -> int:
        """Highest sequence number ever handed out (0 before any append).
        Snapshots record this at commit as the replay watermark."""
        return self._next_seqno - 1

    # -- truncation (post-snapshot GC) ---------------------------------------

    def reset(self) -> None:
        """Empty every journal file — call only after a snapshot that
        captures the writer's staged state has durably committed *and* no
        record was appended past that snapshot's watermark (the synchronous
        drain-commit path guarantees this; concurrent writers must use
        ``truncate_through``). Sequence numbers continue from where they
        were (the watermark discipline depends on it)."""
        with self._lock:
            self._close_locked()
            for name in self._filenames():
                path = self.dir / name
                with open(path, "wb") as f:
                    f.flush()
                    os.fsync(f.fileno())
            fsync_dir_fd = os.open(str(self.dir), os.O_RDONLY)
            try:
                os.fsync(fsync_dir_fd)
            finally:
                os.close(fsync_dir_fd)

    def truncate_through(self, seqno: int) -> None:  # thread: worker
        """Drop every record with ``seqno <=`` the given watermark, keeping
        the rest — the commit callback of an asynchronous snapshot, which
        may run after the foreground appended records the snapshot does not
        cover. Each file is rewritten to a temp sibling, fsynced, and
        renamed in atomically; a crash between files leaves a mix of
        trimmed and untrimmed logs, all of whose at-or-below-watermark
        survivors replay filters out by the watermark discipline."""
        with self._lock:
            self._close_locked()
            for name in self._filenames():
                path = self.dir / name
                if not path.exists():
                    continue
                keep = [r for r in _scan_file(path) if r.seqno > seqno]
                tmp = path.with_suffix(path.suffix + ".trunc")
                with open(tmp, "wb") as f:
                    for rec in keep:
                        payload = _encode_payload(rec)
                        f.write(_FRAME.pack(
                            _crc(rec.seqno, rec.kind, payload),
                            len(payload), rec.seqno, rec.kind) + payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            fsync_dir_fd = os.open(str(self.dir), os.O_RDONLY)
            try:
                os.fsync(fsync_dir_fd)
            finally:
                os.close(fsync_dir_fd)


def _encode_payload(rec: WalRecord) -> bytes:
    """Re-frame a decoded record's payload byte-identically (truncation
    rewrites surviving records; the CRC covers exactly these bytes)."""
    if rec.kind == KIND_INSERT:
        return _INSERT.pack(rec.shard, rec.value)
    if rec.kind == KIND_DELETE:
        return _DELETE.pack(rec.lo, rec.hi)
    if rec.kind == KIND_RESUM:
        return bytes([_POLICY_IDS[rec.policy]]) + \
            np.asarray(rec.bounds, np.float32).tobytes()
    if rec.kind == KIND_INSERT_GROUP:
        return _group_payload(rec.shards.tolist(), rec.values.tolist())
    if rec.kind == KIND_ROW_DELETE:
        return np.asarray(rec.row_ids, _ROW_ID).tobytes()
    raise ValueError(f"unknown record kind {rec.kind}")


def _group_payload(shards: list[int], values: list[float]) -> bytes:
    """A group insert's rows as ``_INSERT`` packs one: (shard, value)."""
    return b"".join(map(_INSERT.pack, shards, values))


def _crc(seqno: int, kind: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(struct.pack("<QB", seqno, kind)))


def _scan_file(path: Path) -> list[WalRecord]:
    """Parse one journal file, stopping at the first torn/corrupt record."""
    data = path.read_bytes()
    out: list[WalRecord] = []
    off = 0
    while off + _FRAME.size <= len(data):
        crc, plen, seqno, kind = _FRAME.unpack_from(data, off)
        end = off + _FRAME.size + plen
        if plen > _MAX_PAYLOAD or end > len(data):
            break                       # torn tail: length runs off the file
        payload = data[off + _FRAME.size: end]
        if _crc(seqno, kind, payload) != crc:
            break                       # torn/corrupt record
        rec = _decode(seqno, kind, payload)
        if rec is None:
            break                       # unknown kind: stop, don't guess
        out.append(rec)
        off = end
    return out
