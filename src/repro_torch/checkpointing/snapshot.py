"""Index snapshots — durable save/load/recover for a sharded Hippo index
(port of ``repro.checkpointing.snapshot``; both packages write and read the
same ``HIPPOIX1`` directories, byte for byte).

``save_index`` serializes a ``core.partition.ShardedHippoIndex`` — table
slabs, every shard's live entry prefix, per-shard bounds + epochs, learned
summary models, and (when a ``runtime.writer.MaintenanceWriter`` is
attached) its staged queues and pending re-summarization — into one
section file (``checkpointing.layout``) under ``<root>/snap_<epoch>/``,
committed by a fsync-then-rename ``COMMITTED`` sentinel. ``load_index``
reconstructs an equivalent index; ``recover_index`` additionally replays
the write-ahead journal (``checkpointing.wal``) so a crash at *any*
instant — mid-stage, mid-drain, mid-snapshot — recovers to exactly the
acknowledged state.

Incremental deltas: a full rewrite per drain commit is fine at ~1 MB and
wrong at 10 GB, so ``save_delta``
commits only what a drain changed — the drain knows exactly which shards
swapped (``runtime.writer.MaintenanceWriter.dirty_checkpoint_shards``).
A delta lives in ``<root>/delta_<base>_<k>/`` beside its base full
snapshot ``snap_<base>/``, in the same section container under the same
COMMITTED-sentinel discipline, and carries per changed shard: that
shard's table slab rows (keys/valid/dirty/payload for its page range),
its full index sections, its bounds and model — plus, because they are
tiny, the complete summaries array, counters, bounds epochs, table
fill/num_pages, the writer's staged state, and the WAL watermark. Delta
sequence numbers are dense (1..k); a committed gap means a skipped commit
and loading refuses with ``CorruptSnapshotError`` rather than serve a
state with a hole in its history. Loading applies base + deltas in order:
each shard's final content comes from the last delta that captured it
(any change to a shard — drain swap, vacuum, resummarize, or a delete
flipping its validity bits — puts it in the next delta), so the chain
replays to the bit-identical index the full rewrite would have produced.
Compaction (``runtime.engine`` policy: after K deltas or when the chain
outweighs the base) folds the chain into a fresh full snapshot; old bases
are pruned together with their deltas.

Collect vs. write: ``collect_full_sections``/``collect_delta_sections``
read the index into host arrays (the only part that must see a quiescent
index), ``write_full_snapshot``/``write_delta_snapshot`` do the file I/O
(the part a background persister thread runs). ``save_index``/
``save_delta`` are the synchronous compositions.

Torch and numpy meet at the section boundary: collect makes one
device-to-host copy of the per-shard scalars, bounds and summaries, and one
of each collected shard's live prefix (bitmaps, starts, ends, order and
live flags in one buffer); the entry bitmaps are int32 words on the device
and their uint32 bits in the file. Load decodes on the host and uploads the
stacked leaves once, to ``device`` (None: the card). The bitmap encoding is
``core.bitmap.rle_encode_rows``/``rle_decode_rows``: vectorized, with the
reference's per-entry loop's bytes.

What the bytes are (the paper's §6 storage model, measured for real):

  * only each shard's **live slot prefix** is stored — the device arrays
    are padded to ``max_slots`` for shape stability, but the disk format
    pays for actual entries only;
  * each entry's bucket bitmap is stored as the smaller of its raw packed
    words and its word-level RLE form (``core.bitmap.rle_compress``), one
    flag byte per entry — the paper's compressed-bitmap storage without
    ever inflating dense bitmaps;
  * per-shard boundary arrays are deduplicated in full snapshots: shards
    serving shard 0's epoch reference its bounds instead of repeating
    them (they only diverge while a re-summarization is partially
    drained); a delta stores its changed shards' bounds unconditionally;
  * table validity/dirty masks are bit-packed.

``disk_usage`` splits a snapshot's (or delta's) real file size into table
vs. index bytes: the index bytes per tuple are the paper's storage measure,
read from real files.

Consistency contract: a snapshot or delta captures (index state, table,
staged queues, pending resummarize, WAL watermark) at one instant.
Recovery = latest committed snapshot + its delta chain + journal records
past the *last chain element's* watermark, replayed through a fresh
writer in admission order. The watermark makes the "truncate journal
after commit" step crash-safe: a crash between the commit and the journal
truncation replays nothing twice. Pruning renames a doomed directory to
``*.tombstone`` before deleting it, so a crash mid-prune can never leave
a half-deleted directory that still carries a COMMITTED sentinel —
tombstones are invisible to epoch/chain discovery and swept on the next
save.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import index as hix
from repro_torch.core.hippo import MaintenanceCounters
from repro_torch.core.learned import PiecewiseLinearModel
from repro_torch.core.partition import (ShardedHippoIndex, ShardedHippoState,
                                        ShardSpec)
from repro_torch.checkpointing.layout import (CorruptSnapshotError,
                                              commit_sentinel, fsync_dir,
                                              read_section_file, section_sizes,
                                              write_section_file)
from repro_torch.checkpointing.wal import (KIND_DELETE, KIND_INSERT,
                                           KIND_INSERT_GROUP, KIND_RESUM,
                                           KIND_ROW_DELETE, Journal)
from repro_torch.device import resolve_device
from repro_torch.runtime.faultinject import crashpoint
from repro_torch.storage.table import PagedTable

_SNAP_PREFIX = "snap_"
_DELTA_PREFIX = "delta_"
_TOMB = ".tombstone"
_META = "__meta__"
_I32_MAX = np.iinfo(np.int32).max


def _encode_model(m: PiecewiseLinearModel | None, prefix: str,
                  sections: dict) -> dict | None:
    if m is None:
        return None
    sections[f"{prefix}/knots_x"] = np.asarray(m.knots_x, np.float64)
    sections[f"{prefix}/knots_y"] = np.asarray(m.knots_y, np.float64)
    return {"n_knots": int(m.n_knots), "segments": int(m.segments),
            "max_error": float(m.max_error)}


def _decode_model(meta: dict | None, prefix: str,
                  sections: dict) -> PiecewiseLinearModel | None:
    if meta is None:
        return None
    return PiecewiseLinearModel(
        knots_x=np.asarray(sections[f"{prefix}/knots_x"], np.float64),
        knots_y=np.asarray(sections[f"{prefix}/knots_y"], np.float64),
        n_knots=int(meta["n_knots"]), segments=int(meta["segments"]),
        max_error=float(meta["max_error"]))


# ---------------------------------------------------------------------------
# Collect: index state -> named host-array sections
# ---------------------------------------------------------------------------

class _HostState:
    """The per-shard scalars, bounds and summaries of a sharded state, each
    copied to the host once; ``prefix`` copies one shard's live prefix."""

    def __init__(self, state: ShardedHippoState):
        st = state.shards
        self.shards = st
        scalars = torch.stack([st.num_entries, st.num_slots,
                               st.summarized_until], dim=1).cpu().numpy()
        self.num_entries, self.num_slots, self.summarized_until = (
            scalars[:, 0], scalars[:, 1], scalars[:, 2])
        self.bounds = st.bounds.cpu().numpy()
        self.summaries = state.summaries.cpu().numpy().view(np.uint32)

    def prefix(self, s: int) -> tuple[np.ndarray, ...]:
        """Shard s's live prefix: (bitmaps u32 (n, W), starts, ends, order
        i32 (n,), live bool (n,)), from one device-to-host copy."""
        st, n = self.shards, int(self.num_slots[s])
        w = st.bitmaps.shape[-1]
        buf = torch.cat([st.bitmaps[s, :n].reshape(-1), st.starts[s, :n],
                         st.ends[s, :n], st.sorted_order[s, :n],
                         st.slot_live[s, :n].to(torch.int32)]).cpu().numpy()
        cols = buf[n * w:].reshape(4, n)
        return (buf[: n * w].view(np.uint32).reshape(n, w), cols[0], cols[1],
                cols[2], cols[3].astype(bool))


def _collect_shard_sections(host: _HostState, s: int, pre: str,
                            sections: dict) -> dict:
    """One shard's index sections (live prefix, encoded bitmaps) + meta."""
    bitmaps, starts, ends, order, live = host.prefix(s)
    flags, lens, data = bm.rle_encode_rows(bitmaps)
    sections[f"{pre}/bm_flags"] = flags
    sections[f"{pre}/bm_lens"] = lens
    sections[f"{pre}/bm_data"] = data
    sections[f"{pre}/starts"] = starts
    sections[f"{pre}/ends"] = ends
    sections[f"{pre}/order"] = order
    sections[f"{pre}/live"] = np.packbits(live)
    return {
        "num_entries": int(host.num_entries[s]),
        "num_slots": int(host.num_slots[s]),
        "summarized_until": int(host.summarized_until[s]),
    }


def _collect_writer(w, sections: dict) -> dict | None:
    """The attached writer's staged state (queues, pending resummarize)."""
    if w is None:
        return None
    qshards = []
    for s, q in sorted(w._queues.items()):
        if not q.values:
            continue
        sections[f"wal/q{s}/values"] = np.asarray(q.values, np.float32)
        sections[f"wal/q{s}/live"] = np.asarray(q.live, np.uint8)
        qshards.append(int(s))
    meta = {
        "queues": qshards,
        "pending_resummarize": [int(s) for s in w._pending_resummarize],
        "resum_epoch": int(w._resum_epoch),
        "staged": int(w.stats.staged),
        "killed": int(w.stats.killed),
        "pending_model": _encode_model(w._pending_model, "wal/pmodel",
                                       sections),
    }
    if w._pending_bounds is not None:
        sections["wal/pending_bounds"] = np.asarray(w._pending_bounds,
                                                    np.float32)
    return meta


def collect_full_sections(index: ShardedHippoIndex,
                          wal_seqno: int) -> dict[str, np.ndarray]:
    """Everything a full snapshot stores, as named sections + a meta blob."""
    cfg, spec, table = index.cfg, index.spec, index.table
    sections: dict[str, np.ndarray] = {}

    npages = table.num_pages
    ntuples = npages * table.page_card
    sections["table/keys"] = np.asarray(table.keys[:npages], np.float32)
    sections["table/valid"] = np.packbits(
        table.valid[:npages].reshape(-1))
    sections["table/dirty"] = np.packbits(table.dirty[:npages])
    payload_meta = {}
    for name, col in table.payload.items():
        sections[f"table/payload/{name}"] = np.asarray(col[:npages])
        payload_meta[name] = np.asarray(col).dtype.str

    shards_meta = []
    host = _HostState(index.state)
    bounds0 = host.bounds[0]
    for s in range(spec.num_shards):
        pre = f"s{s}"
        sm = _collect_shard_sections(host, s, pre, sections)
        own_bounds = False
        if s > 0:
            bs = host.bounds[s]
            if not np.array_equal(bs, bounds0):
                sections[f"{pre}/bounds"] = bs
                own_bounds = True
        sm["own_bounds"] = own_bounds
        shards_meta.append(sm)
    sections["s0/bounds"] = bounds0
    sections["summaries"] = host.summaries

    models_meta = [
        _encode_model(m, f"s{s}/model", sections)
        for s, m in enumerate(index.summary_models or
                              [None] * spec.num_shards)]

    writer_meta = _collect_writer(index.staging, sections)

    meta = {
        "kind": "sharded_hippo_index",
        "cfg": {"resolution": cfg.resolution, "density": cfg.density,
                "page_card": cfg.page_card, "max_slots": cfg.max_slots,
                "relocate_on_update": cfg.relocate_on_update},
        "spec": {"num_shards": spec.num_shards,
                 "pages_per_shard": spec.pages_per_shard},
        "summary": index.summary,
        "bounds_epochs": [int(e) for e in index.bounds_epochs],
        "counters": {k: int(v) for k, v in vars(index.counters).items()},
        "table": {"num_pages": int(npages), "fill": int(table.fill),
                  "num_tuples": int(ntuples), "payload": payload_meta},
        "shards": shards_meta,
        "models": models_meta,
        "writer": writer_meta,
        "wal_seqno": int(wal_seqno),
    }
    sections[_META] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"), np.uint8).copy()
    return sections


def collect_delta_sections(index: ShardedHippoIndex, wal_seqno: int,
                           shards, base_epoch: int,
                           delta_seq: int) -> dict[str, np.ndarray]:
    """What one drain commit changed: the given shards' index sections and
    table slab rows, plus the (tiny) global scalars a load needs in full —
    summaries, counters, bounds epochs, table fill, writer staged state."""
    spec, table = index.spec, index.table
    sections: dict[str, np.ndarray] = {}
    npages = table.num_pages
    shard_ids = sorted({int(s) for s in shards})
    if any(s < 0 or s >= spec.num_shards for s in shard_ids):
        raise ValueError(f"delta shards {shard_ids} outside "
                         f"[0, {spec.num_shards})")

    payload_meta = {name: np.asarray(col).dtype.str
                    for name, col in table.payload.items()}
    host = _HostState(index.state)
    shards_meta = {}
    for s in shard_ids:
        pre = f"d{s}"
        sm = _collect_shard_sections(host, s, pre, sections)
        sections[f"{pre}/bounds"] = host.bounds[s]
        lo = spec.page_lo(s)
        hi = min(lo + spec.pages_per_shard, npages)
        if hi > lo:
            sections[f"{pre}/keys"] = np.asarray(table.keys[lo:hi],
                                                 np.float32)
            sections[f"{pre}/valid"] = np.packbits(
                table.valid[lo:hi].reshape(-1))
            sections[f"{pre}/dirty"] = np.packbits(table.dirty[lo:hi])
            for name, col in table.payload.items():
                sections[f"{pre}/payload/{name}"] = np.asarray(col[lo:hi])
        sm["page_lo"], sm["page_hi"] = lo, hi
        sm["model"] = _encode_model(
            (index.summary_models or [None] * spec.num_shards)[s],
            f"{pre}/model", sections)
        shards_meta[str(s)] = sm
    sections["summaries"] = host.summaries

    writer_meta = _collect_writer(index.staging, sections)

    meta = {
        "kind": "sharded_hippo_delta",
        "base_epoch": int(base_epoch),
        "delta_seq": int(delta_seq),
        "shards": shard_ids,
        "summary": index.summary,
        "bounds_epochs": [int(e) for e in index.bounds_epochs],
        "counters": {k: int(v) for k, v in vars(index.counters).items()},
        "table": {"num_pages": int(npages), "fill": int(table.fill),
                  "num_tuples": int(npages * table.page_card),
                  "payload": payload_meta},
        "shards_meta": shards_meta,
        "writer": writer_meta,
        "wal_seqno": int(wal_seqno),
    }
    sections[_META] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"), np.uint8).copy()
    return sections


# ---------------------------------------------------------------------------
# Directory discovery: epochs, delta chains, tombstone-safe pruning
# ---------------------------------------------------------------------------

def latest_epoch(root: str | Path) -> int | None:
    """Highest committed snapshot epoch under ``root`` (None if none).
    Tombstoned (mid-prune) directories are never candidates."""
    root = Path(root)
    if not root.exists():
        return None
    epochs = []
    for d in root.iterdir():
        if (d.name.startswith(_SNAP_PREFIX) and not d.name.endswith(_TOMB)
                and (d / "COMMITTED").exists()):
            try:
                epochs.append(int(d.name[len(_SNAP_PREFIX):]))
            except ValueError:
                continue
    return max(epochs) if epochs else None


def _delta_dirs(root: Path, base_epoch: int) -> list[tuple[int, Path]]:
    out = []
    pre = f"{_DELTA_PREFIX}{base_epoch}_"
    for d in root.iterdir():
        if not d.name.startswith(pre) or d.name.endswith(_TOMB):
            continue
        try:
            seq = int(d.name[len(pre):])
        except ValueError:
            continue
        if (d / "COMMITTED").exists():
            out.append((seq, d))
    out.sort()
    return out


def latest_delta_seq(root: str | Path, base_epoch: int) -> int:
    """Highest committed delta sequence against ``base_epoch`` (0 if none)."""
    root = Path(root)
    if not root.exists():
        return 0
    dirs = _delta_dirs(root, base_epoch)
    return dirs[-1][0] if dirs else 0


def delta_chain(root: str | Path, base_epoch: int) -> list[tuple[int, Path]]:
    """Committed deltas against ``base_epoch`` in replay order (seq 1..k).

    Sequence numbers must be dense: a committed delta k without every
    committed delta below it means a commit was skipped (which the
    background persister's poisoning discipline exists to prevent), and
    replaying across the hole would silently lose that commit's shards —
    refuse with ``CorruptSnapshotError`` instead.
    """
    dirs = _delta_dirs(Path(root), base_epoch)
    for i, (seq, _) in enumerate(dirs):
        if seq != i + 1:
            raise CorruptSnapshotError(
                f"delta chain for snapshot {base_epoch} is missing seq "
                f"{i + 1} (found {[s for s, _ in dirs]}): a committed gap "
                f"means a skipped commit — refusing to replay across it")
    return dirs


def _prune(root: Path, keep: int) -> None:
    """Drop all but the newest ``keep`` full snapshots, each with its delta
    chain. Atomic against crashes: a doomed directory is renamed to
    ``<name>.tombstone`` first (one rename — afterwards its COMMITTED
    sentinel is invisible to discovery), then deleted; tombstones left by
    a crash mid-prune are swept here on the next save."""
    for p in list(root.iterdir()):
        if p.name.endswith(_TOMB):
            shutil.rmtree(p, ignore_errors=True)
    committed = sorted(
        (int(p.name[len(_SNAP_PREFIX):]) for p in root.iterdir()
         if p.name.startswith(_SNAP_PREFIX) and not p.name.endswith(_TOMB)
         and (p / "COMMITTED").exists()),
        reverse=True)
    doomed = []
    for old in committed[keep:]:
        doomed.append(root / f"{_SNAP_PREFIX}{old}")
        doomed.extend(p for _, p in _delta_dirs(root, old))
    for d in doomed:
        tomb = d.with_name(d.name + _TOMB)
        try:
            # hippolint: disable=crash -- this rename deletes, not commits:
            # the payload is a doomed-but-committed snapshot, so durability
            # is not required — a crash that loses the rename merely
            # resurrects a committed directory the next save re-sweeps
            os.replace(d, tomb)
        except OSError:
            tomb = d     # rename refused: fall back to direct removal
        shutil.rmtree(tomb, ignore_errors=True)


# ---------------------------------------------------------------------------
# Write: sections -> committed directory (the background persister's half)
# ---------------------------------------------------------------------------

def write_full_snapshot(root: str | Path, sections: dict, *, keep: int = 3,
                        epoch: int | None = None,
                        compact: bool = False) -> Path:
    """Write + commit a full snapshot from pre-collected sections.

    ``epoch=None`` allocates the next epoch from disk (synchronous
    callers); a background persister passes the epoch it reserved at
    collect time. ``compact=True`` marks this full snapshot as a
    compaction fold of a delta chain — same bytes, distinct crash-point
    site. Pruning (``keep``) runs after the commit.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    if epoch is None:
        epoch = (latest_epoch(root) or 0) + 1
    d = root / f"{_SNAP_PREFIX}{epoch}"
    if d.exists():
        shutil.rmtree(d)     # leftover uncommitted attempt
    d.mkdir()
    fsync_dir(root)
    write_section_file(d / "index.bin", sections)
    crashpoint("compact.pre_commit" if compact else "snapshot.pre_commit")
    commit_sentinel(d)
    _prune(root, keep)
    return d


def write_delta_snapshot(root: str | Path, sections: dict, base_epoch: int,
                         delta_seq: int) -> Path:
    """Write + commit one delta against ``snap_<base_epoch>``."""
    root = Path(root)
    base = root / f"{_SNAP_PREFIX}{base_epoch}"
    if not (base / "COMMITTED").exists():
        raise FileNotFoundError(
            f"delta base snapshot {base} is not committed — a delta "
            f"against an uncommitted base could never replay")
    d = root / f"{_DELTA_PREFIX}{base_epoch}_{delta_seq}"
    if d.exists():
        shutil.rmtree(d)     # leftover uncommitted attempt at this seq
    d.mkdir()
    fsync_dir(root)
    write_section_file(d / "index.bin", sections)
    crashpoint("delta.pre_commit")
    commit_sentinel(d)
    return d


def save_index(root: str | Path, index: ShardedHippoIndex, *,
               wal_seqno: int = 0, keep: int = 3, epoch: int | None = None,
               compact: bool = False) -> Path:
    """Durably snapshot ``index`` under ``<root>/snap_<epoch>/``.

    The snapshot is committed by the ``COMMITTED`` sentinel appearing
    (fsync-then-rename); a crash before that leaves an ignorable partial
    directory. ``wal_seqno`` records the journal watermark at this
    snapshot's instant — journal records at or below it are already
    reflected here and must not replay. Keeps the last ``keep`` committed
    snapshots (with their delta chains); older ones are pruned after the
    new commit via tombstone renames.
    """
    return write_full_snapshot(root, collect_full_sections(index, wal_seqno),
                               keep=keep, epoch=epoch, compact=compact)


def save_delta(root: str | Path, index: ShardedHippoIndex, *, shards,
               wal_seqno: int = 0, base_epoch: int | None = None,
               delta_seq: int | None = None) -> Path:
    """Durably commit an incremental delta: the given ``shards``' current
    index sections and table slab rows against the last full snapshot.
    ``shards`` must cover every shard changed since the previous commit
    (the writer's ``dirty_checkpoint_shards`` tracks exactly that)."""
    root = Path(root)
    if base_epoch is None:
        base_epoch = latest_epoch(root)
        if base_epoch is None:
            raise FileNotFoundError(
                f"no committed full snapshot under {root} to delta against")
    if delta_seq is None:
        delta_seq = latest_delta_seq(root, base_epoch) + 1
    sections = collect_delta_sections(index, wal_seqno, shards, base_epoch,
                                      delta_seq)
    return write_delta_snapshot(root, sections, base_epoch, delta_seq)


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def _snapshot_dir(root: Path, epoch: int | None) -> Path:
    if epoch is None:
        epoch = latest_epoch(root)
        if epoch is None:
            raise FileNotFoundError(
                f"no committed snapshot under {root} (uncommitted partials, "
                f"if any, are ignored by design)")
    d = root / f"{_SNAP_PREFIX}{epoch}"
    if not (d / "COMMITTED").exists():
        raise FileNotFoundError(
            f"snapshot {d} is not committed — refusing to load a torn "
            f"snapshot")
    return d


def _load_raw(root: str | Path, epoch: int | None
              ) -> tuple[Path, dict, dict[str, np.ndarray]]:
    d = _snapshot_dir(Path(root), epoch)
    sections = read_section_file(d / "index.bin")
    if _META not in sections:
        raise CorruptSnapshotError(f"{d}: snapshot has no metadata section")
    try:
        meta = json.loads(bytes(sections[_META]).decode("utf-8"))
    except ValueError as e:
        raise CorruptSnapshotError(f"{d}: metadata is not valid JSON") from e
    if meta.get("kind") != "sharded_hippo_index":
        raise CorruptSnapshotError(
            f"{d}: snapshot kind {meta.get('kind')!r} is not an index")
    return d, meta, sections


def _read_delta(path: Path, base_epoch: int,
                seq: int) -> tuple[dict, dict[str, np.ndarray]]:
    sections = read_section_file(path / "index.bin")
    if _META not in sections:
        raise CorruptSnapshotError(f"{path}: delta has no metadata section")
    try:
        meta = json.loads(bytes(sections[_META]).decode("utf-8"))
    except ValueError as e:
        raise CorruptSnapshotError(f"{path}: metadata is not valid "
                                   f"JSON") from e
    if meta.get("kind") != "sharded_hippo_delta":
        raise CorruptSnapshotError(
            f"{path}: kind {meta.get('kind')!r} is not an index delta")
    if (int(meta.get("base_epoch", -1)) != base_epoch
            or int(meta.get("delta_seq", -1)) != seq):
        raise CorruptSnapshotError(
            f"{path}: delta claims base {meta.get('base_epoch')} seq "
            f"{meta.get('delta_seq')} but sits at base {base_epoch} seq "
            f"{seq} — directory layout and contents disagree")
    return meta, sections


def _load_chain(root: Path, epoch: int | None
                ) -> tuple[dict, dict, list[tuple[dict, dict]]]:
    """Base snapshot meta/sections plus its committed delta chain, in
    replay order."""
    d, meta, sections = _load_raw(root, epoch)
    base_epoch = int(d.name[len(_SNAP_PREFIX):])
    chain = [_read_delta(p, base_epoch, seq)
             for seq, p in delta_chain(root, base_epoch)]
    return meta, sections, chain


def _decode_shard_leaves(cfg: hix.HippoConfig, pre: str, sm: dict,
                         sections: dict, bounds: np.ndarray) -> dict:
    """One shard's HippoState leaves (numpy, padded to max_slots)."""
    S, W = cfg.max_slots, cfg.words
    n = sm["num_slots"]
    bitmaps = np.zeros((S, W), np.uint32)
    bitmaps[:n] = bm.rle_decode_rows(
        sections[f"{pre}/bm_flags"], sections[f"{pre}/bm_lens"],
        sections[f"{pre}/bm_data"], W)
    starts = np.full((S,), _I32_MAX, np.int32)
    starts[:n] = sections[f"{pre}/starts"]
    ends = np.full((S,), _I32_MAX, np.int32)
    ends[:n] = sections[f"{pre}/ends"]
    order = np.arange(S, dtype=np.int32)
    order[:n] = sections[f"{pre}/order"]
    live = np.zeros((S,), bool)
    live[:n] = np.unpackbits(sections[f"{pre}/live"],
                             count=n).astype(bool)
    return {
        "bounds": bounds, "bitmaps": bitmaps, "starts": starts, "ends": ends,
        "sorted_order": order, "slot_live": live,
        "num_entries": np.int32(sm["num_entries"]),
        "num_slots": np.int32(n),
        "summarized_until": np.int32(sm["summarized_until"]),
    }


def _rebuild_table(meta: dict, sections: dict,
                   chain: list[tuple[dict, dict]]) -> PagedTable:
    """Base table rows patched by each delta's changed-shard slab rows, at
    the chain's final capacity."""
    page_card = meta["cfg"]["page_card"]
    eff_t = (chain[-1][0] if chain else meta)["table"]
    npages, fill = eff_t["num_pages"], eff_t["fill"]
    base_np = meta["table"]["num_pages"]
    keys = np.zeros((npages, page_card), np.float32)
    valid = np.zeros((npages, page_card), bool)
    dirty = np.zeros((npages,), bool)
    keys[:base_np] = np.array(sections["table/keys"], np.float32).reshape(
        base_np, page_card)
    valid[:base_np] = np.unpackbits(
        sections["table/valid"],
        count=base_np * page_card).astype(bool).reshape(base_np, page_card)
    dirty[:base_np] = np.unpackbits(sections["table/dirty"],
                                    count=base_np).astype(bool)
    payload = {}
    for name, dstr in meta["table"]["payload"].items():
        col = np.zeros((npages, page_card), np.dtype(dstr))
        col[:base_np] = np.array(
            sections[f"table/payload/{name}"]).reshape(base_np, page_card)
        payload[name] = col
    for dmeta, dsec in chain:
        for s in dmeta["shards"]:
            sm = dmeta["shards_meta"][str(s)]
            lo, hi = sm["page_lo"], sm["page_hi"]
            if hi <= lo:
                continue
            if hi > npages:
                raise CorruptSnapshotError(
                    f"delta seq {dmeta['delta_seq']} patches pages up to "
                    f"{hi} but the chain's final table has {npages} pages")
            pre, n = f"d{s}", hi - lo
            keys[lo:hi] = np.array(dsec[f"{pre}/keys"], np.float32).reshape(
                n, page_card)
            valid[lo:hi] = np.unpackbits(
                dsec[f"{pre}/valid"],
                count=n * page_card).astype(bool).reshape(n, page_card)
            dirty[lo:hi] = np.unpackbits(dsec[f"{pre}/dirty"],
                                         count=n).astype(bool)
            for name in payload:
                payload[name][lo:hi] = np.array(
                    dsec[f"{pre}/payload/{name}"]).reshape(n, page_card)
    return PagedTable(
        page_card=page_card, capacity_pages=npages, keys=keys,
        valid=valid, dirty=dirty, num_pages=npages, fill=fill,
        num_dirty=int(dirty.sum()), payload=payload)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host-to-device copy; uint32 words travel as int32 (same bits)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _rebuild_state(cfg: hix.HippoConfig, meta: dict, sections: dict,
                   chain: list[tuple[dict, dict]],
                   dev: torch.device) -> ShardedHippoState:
    """Base per-shard leaves, each replaced by the last delta that captured
    its shard; stacked and uploaded to ``dev`` once at the end."""
    bounds0 = np.asarray(sections["s0/bounds"], np.float32)
    per_shard = []
    for s, sm in enumerate(meta["shards"]):
        pre = f"s{s}"
        bounds = (np.asarray(sections[f"{pre}/bounds"], np.float32)
                  if s > 0 and sm["own_bounds"] else bounds0)
        per_shard.append(_decode_shard_leaves(cfg, pre, sm, sections, bounds))
    summaries = np.asarray(sections["summaries"], np.uint32)
    for dmeta, dsec in chain:
        for s in dmeta["shards"]:
            sm = dmeta["shards_meta"][str(s)]
            pre = f"d{s}"
            bounds = np.asarray(dsec[f"{pre}/bounds"], np.float32)
            per_shard[int(s)] = _decode_shard_leaves(cfg, pre, sm, dsec,
                                                     bounds)
        summaries = np.asarray(dsec["summaries"], np.uint32)
    shards = hix.HippoState(**{
        f: _upload(np.stack([ps[f] for ps in per_shard]), dev)
        for f in hix.HippoState._fields})
    return ShardedHippoState(shards=shards, summaries=_upload(summaries, dev))


def _build_index(meta: dict, sections: dict, chain: list[tuple[dict, dict]],
                 dev: torch.device) -> ShardedHippoIndex:
    c = meta["cfg"]
    cfg = hix.HippoConfig(
        resolution=c["resolution"], density=c["density"],
        page_card=c["page_card"], max_slots=c["max_slots"],
        relocate_on_update=c["relocate_on_update"])
    spec = ShardSpec(num_shards=meta["spec"]["num_shards"],
                     pages_per_shard=meta["spec"]["pages_per_shard"])
    eff = chain[-1][0] if chain else meta
    models = [_decode_model(mm, f"s{s}/model", sections)
              for s, mm in enumerate(meta["models"])]
    for dmeta, dsec in chain:
        for s in dmeta["shards"]:
            models[int(s)] = _decode_model(
                dmeta["shards_meta"][str(s)]["model"], f"d{s}/model", dsec)
    return ShardedHippoIndex(
        cfg=cfg, spec=spec,
        state=_rebuild_state(cfg, meta, sections, chain, dev),
        table=_rebuild_table(meta, sections, chain), device=dev,
        counters=MaintenanceCounters(**eff["counters"]),
        bounds_epochs=np.asarray(eff["bounds_epochs"], np.int64),
        summary=eff["summary"],
        summary_models=models)


def load_index(root: str | Path, *, epoch: int | None = None, device=None
               ) -> tuple[ShardedHippoIndex, dict]:
    """Reconstruct the latest (or a specific) committed snapshot's index,
    its delta chain applied, on ``device`` (None: the card).

    Returns ``(index, meta)``; with a delta chain, ``meta`` is the base
    snapshot's metadata with the chain-effective scalars (wal watermark,
    counters, table, writer state, bounds epochs) folded in. The index is
    writer-less; use ``recover_index`` (or ``QueryEngine.recover``) when a
    journal/staged state may exist. Counts, row ids, bounds, epochs, and
    learned models round-trip exactly (``tests/test_torch_persistence.py``).
    """
    dev = resolve_device(device)
    meta, sections, chain = _load_chain(Path(root), epoch)
    index = _build_index(meta, sections, chain, dev)
    if chain:
        eff = dict(meta)
        last = chain[-1][0]
        for k in ("wal_seqno", "counters", "bounds_epochs", "summary",
                  "table", "writer"):
            eff[k] = last[k]
        eff["deltas"] = len(chain)
        return index, eff
    return index, meta


# ---------------------------------------------------------------------------
# Recovery: snapshot + delta chain + journal replay
# ---------------------------------------------------------------------------

def _restore_writer(index: ShardedHippoIndex, meta: dict, sections: dict):
    """Reattach a writer carrying the snapshot's staged state."""
    from repro_torch.runtime.writer import MaintenanceWriter, _ShardQueue
    w = MaintenanceWriter(index)
    wm = meta["writer"]
    for s in wm["queues"]:
        q = _ShardQueue()
        q.values = [float(v) for v in sections[f"wal/q{s}/values"]]
        q.live = [bool(b) for b in sections[f"wal/q{s}/live"]]
        q.n_live = sum(q.live)
        w._queues[int(s)] = q
        if q.n_live:
            w.drift.observe(np.asarray(
                [v for v, a in zip(q.values, q.live) if a], np.float32))
    w._staged_total = sum(len(q.values) for q in w._queues.values())
    w._version += 1
    w.stats.staged = int(wm["staged"])
    w.stats.killed = int(wm["killed"])
    w._pending_resummarize = [int(s) for s in wm["pending_resummarize"]]
    w._resum_epoch = int(wm["resum_epoch"])
    if "wal/pending_bounds" in sections:
        w._pending_bounds = np.asarray(sections["wal/pending_bounds"],
                                       np.float32)
    w._pending_model = _decode_model(wm["pending_model"], "wal/pmodel",
                                     sections)
    return w


def recover_index(root: str | Path, *, epoch: int | None = None,
                  wal_sync: bool = True, device=None):
    """Crash recovery: latest committed snapshot + delta chain + journal
    suffix replay.

    Returns ``(index, writer, journal)``. The writer holds the staged
    state exactly as acknowledged before the crash (the chain's last
    captured queues plus replayed journal records past the chain's
    watermark); the journal is attached to it, so subsequent writes keep
    journaling. ``writer`` is None only when the snapshot had no writer
    and the journal is empty. The index lives on ``device`` (None: the
    card).
    """
    dev = resolve_device(device)
    root = Path(root)
    meta, sections, chain = _load_chain(root, epoch)       # read + CRC
    index = _build_index(meta, sections, chain, dev)       # decode + upload
    writer, journal = _replay_journal(root, index, meta, sections, chain,
                                      wal_sync)
    return index, writer, journal


def _replay_journal(root: Path, index: ShardedHippoIndex, meta: dict,
                    sections: dict, chain: list[tuple[dict, dict]],
                    wal_sync: bool):
    """Reattach the chain's staged state and replay the journal's records
    past its watermark, in admission order; returns (writer, journal).

    A group insert restages its rows as ``write_many`` did. A row delete
    applies to the table's validity; where its ids reach past the table's
    tail, the crashed process had drained staged rows into the table after
    the chain's last commit (``snapshot_on_drain=False``), so the writer
    drains what it holds first: a staged row's position, and so its id,
    is fixed when it is staged."""
    eff_meta, eff_sections = (chain[-1] if chain else (meta, sections))
    journal = Journal(root, index.spec.num_shards, sync=wal_sync)
    records = journal.replay(after=int(eff_meta.get("wal_seqno", 0)))

    writer = None
    if eff_meta["writer"] is not None:
        writer = _restore_writer(index, eff_meta, eff_sections)
    elif records:
        from repro_torch.runtime.writer import MaintenanceWriter
        writer = MaintenanceWriter(index)

    for rec in records:
        if rec.kind == KIND_INSERT:
            s = writer.write(rec.value)
            if s != rec.shard:
                raise CorruptSnapshotError(
                    f"journal replay routed a staged insert to shard {s} "
                    f"but the record was acknowledged on shard {rec.shard} "
                    f"— snapshot and journal disagree")
        elif rec.kind == KIND_INSERT_GROUP:
            shards = writer.write_many(rec.values)
            if shards != rec.shards.tolist():
                raise CorruptSnapshotError(
                    f"journal replay routed a group insert to shards "
                    f"{shards} but it was acknowledged on "
                    f"{rec.shards.tolist()} — snapshot and journal disagree")
        elif rec.kind == KIND_DELETE:
            writer.delete(rec.lo, rec.hi)
        elif rec.kind == KIND_ROW_DELETE:
            try:
                writer.delete_rows(rec.row_ids)
            except IndexError:      # refused before any change
                if not writer.queue_depth:
                    raise
                writer.flush()
                writer.delete_rows(rec.row_ids)
        elif rec.kind == KIND_RESUM:
            writer.schedule_resummarize(bounds=rec.bounds, policy=rec.policy)
    if writer is not None:
        writer.journal = journal
    return writer, journal


# ---------------------------------------------------------------------------
# Storage accounting (real bytes on disk)
# ---------------------------------------------------------------------------

def _is_table_section(name: str) -> bool:
    if name.startswith("table/"):
        return True
    # delta layout: d<shard>/{keys,valid,dirty,payload/*} are slab rows
    if name.startswith("d") and "/" in name:
        tail = name.split("/", 1)[1]
        return tail in ("keys", "valid", "dirty") or \
            tail.startswith("payload/")
    return False


def disk_usage(snapshot: str | Path) -> dict[str, int]:
    """Real byte split of a snapshot or delta: ``total`` file size,
    ``table`` (heap payload sections), and ``index`` (everything else:
    entries, bounds, summaries, models, staged state, metadata, headers).
    The index figure is what the storage comparison charges Hippo per
    tuple — container overhead included, nothing amortized away."""
    snapshot = Path(snapshot)
    f = snapshot / "index.bin" if snapshot.is_dir() else snapshot
    sizes = section_sizes(f)
    total = f.stat().st_size
    table = sum(nb for name, nb in sizes.items() if _is_table_section(name))
    return {"total": total, "table": table, "index": total - table}
