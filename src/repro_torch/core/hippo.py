"""High-level Hippo index API — the paper's CREATE INDEX / SELECT / INSERT /
DELETE / VACUUM surface (§7.1) over the functional core (port of
``repro.core.hippo``).

    table = PagedTable.from_values(values, page_card=50)
    idx = HippoIndex.create(table, resolution=400, density=0.2)  # the card
    res = idx.search(Predicate.between(1000, 2000))
    idx.insert(1234.0)                  # eager (Algorithm 3)
    table.delete_where(500, 600)        # marks pages dirty
    idx.vacuum()                        # lazy re-summarize (§5.2)

``HippoIndex`` is the unsharded index: one ``HippoState`` over the whole
table on ``device`` (None: the card). Its searches are the single-query
``search`` (with the exact tuple mask), the dense batch ``search_batch`` and
the gather paths ``search_compact``/``search_compact_batch``. ``insert``,
the atomic ``insert_batch`` and ``vacuum`` keep the reference's maintenance
counters and its capacity refusals.

The sampling helpers (``sample_keys``, ``sample_histogram``) and
``MaintenanceCounters`` are shared with ``core.partition``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import histogram as hg
from repro_torch.core import index as hix
from repro_torch.core.predicate import (Predicate, intervals, to_bucket_bitmap,
                                        to_bucket_bitmaps)
from repro_torch.device import resolve_device
from repro_torch.storage.table import PagedTable


def sample_keys(table: PagedTable, sample_size: int = 65536) -> np.ndarray:
    """The CREATE INDEX build sample: live tuples, capped at ``sample_size``
    by the reference's fixed-seed draw (``default_rng(0).choice``), so both
    packages quantile the same sample."""
    if table.num_pages == 0:
        raise ValueError(
            "empty table: pass an explicit hist (the complete histogram "
            "is DBMS-maintained and cannot be sampled from zero tuples)")
    live = table.keys[: table.num_pages][table.valid[: table.num_pages]]
    if live.size > sample_size:
        rng = np.random.default_rng(0)
        live = rng.choice(live, size=sample_size, replace=False)
    return live


def sample_histogram(table: PagedTable, resolution: int,
                     sample_size: int = 65536, device=None) -> hg.Histogram:
    """The DBMS-maintained complete histogram, sampled from the table (§4.1)."""
    return hg.build(sample_keys(table, sample_size), resolution, device=device)


@dataclass
class MaintenanceCounters:
    inserts: int = 0
    entries_touched: int = 0
    entries_created: int = 0
    vacuums: int = 0
    entries_resummarized: int = 0


@dataclass
class HippoIndex:
    """The unsharded index; every tensor lives on ``device``."""
    cfg: hix.HippoConfig
    state: hix.HippoState
    table: PagedTable
    device: torch.device
    counters: MaintenanceCounters = field(default_factory=MaintenanceCounters)

    # -- creation ------------------------------------------------------------

    @staticmethod
    def create(table: PagedTable, resolution: int = 400, density: float = 0.2,
               max_slots: int | None = None, sample_size: int = 65536,
               relocate_on_update: bool = True,
               hist: hg.Histogram | None = None, device=None
               ) -> "HippoIndex":
        """CREATE INDEX ... USING hippo(attr) on ``device`` (None: the card):
        the complete histogram from a table sample (§4.1), then Algorithm 2.
        Defaults follow the reference."""
        dev = resolve_device(device)
        if max_slots is None:
            # worst case one entry per page, plus an update budget
            max_slots = int(table.num_pages * 1.25) + 1024
        cfg = hix.HippoConfig(resolution=resolution, density=density,
                              page_card=table.page_card, max_slots=max_slots,
                              relocate_on_update=relocate_on_update)
        if hist is None:
            hist = sample_histogram(table, resolution, sample_size, device=dev)
        hist = hg.Histogram(hist.bounds.to(dev))
        state = hix.build(cfg, hist, table.device_keys(device=dev),
                          table.device_valid(device=dev))
        return HippoIndex(cfg=cfg, state=state, table=table, device=dev)

    # -- query (Algorithm 1) ---------------------------------------------------

    def _views(self) -> tuple[torch.Tensor, torch.Tensor]:
        return (self.table.device_keys(device=self.device),
                self.table.device_valid(device=self.device))

    def search(self, pred: Predicate) -> hix.SearchResult:
        """One predicate: count, exact tuple mask, page mask and the paper's
        I/O metrics (``core.index.search``)."""
        qbm = to_bucket_bitmap(pred, self.state.histogram)
        los, his = intervals([pred], self.device)
        keys, valid = self._views()
        return hix.search(self.state, qbm, keys, valid, los[0], his[0])

    def search_batch(self, preds: list[Predicate]) -> hix.BatchSearchResult:
        """Batched Algorithm 1 (``core.index.search_many``): row q equals
        ``search(preds[q])``'s scalars."""
        qbms = to_bucket_bitmaps(preds, self.state.histogram)
        los, his = intervals(preds, self.device)
        keys, valid = self._views()
        return hix.search_many(self.state, qbms, keys, valid, los, his)

    def search_compact(self, pred: Predicate, max_selected: int | None = None):
        """Gather-path search. Returns (count, pages_inspected, truncated)."""
        qbm = to_bucket_bitmap(pred, self.state.histogram)
        if max_selected is None:
            max_selected = self.table.num_pages
        los, his = intervals([pred], self.device)
        keys, valid = self._views()
        return hix.search_compact(self.state, qbm, keys, valid, los[0],
                                  his[0], max_selected=max_selected)

    def search_compact_batch(self, preds: list[Predicate], *,
                             max_selected: int, top_k: int = 0
                             ) -> hix.CompactBatchResult:
        """Batched gather path (``core.index.search_compact_many``); row ids
        are global (``page_id * page_card + slot``)."""
        qbms = to_bucket_bitmaps(preds, self.state.histogram)
        los, his = intervals(preds, self.device)
        keys, valid = self._views()
        return hix.search_compact_many(self.state, qbms, keys, valid, los,
                                       his, max_selected=max_selected,
                                       top_k=top_k)

    @property
    def gather_cap(self) -> int:
        """Slab width at which the gather path can never truncate."""
        return max(self.table.num_pages, 1)

    # -- maintenance ---------------------------------------------------------

    def _require_slot_capacity(self, num_slots: int | None = None) -> None:
        """Refuse maintenance that would overflow the physical slot array,
        checked before any table or index state changes."""
        if num_slots is None:
            num_slots = int(self.state.num_slots)
        if num_slots + 1 > self.cfg.max_slots:
            raise RuntimeError(
                f"index at slot capacity ({num_slots}/"
                f"{self.cfg.max_slots}); rebuild with a larger max_slots")

    def insert(self, value: float) -> None:
        """Eager single-tuple insert: table append + Algorithm 3 update."""
        _, opens_page = self.table.next_page_id()
        if opens_page or self.cfg.relocate_on_update:
            # only the new-entry and relocation paths consume a slot
            self._require_slot_capacity()
        page_id, _ = self.table.insert(value)
        before = int(self.state.num_entries)
        self.state, after = hix.insert_tuples(self.cfg, self.state, [value],
                                              [page_id])
        self.counters.inserts += 1
        self.counters.entries_touched += 1
        self.counters.entries_created += after - before

    def insert_batch(self, values: np.ndarray) -> None:
        """Vectorized insert. Atomic: either the whole batch lands or, on
        slot-capacity exhaustion, table and index are rolled back to their
        pre-batch snapshot before the raise (no update writes into the
        snapshot's tensors).

        Tuples landing on already-summarized pages take one fused OR;
        tuples past ``summarized_until`` replay the eager path on the host
        (``core.index.insert_tuples``), with the capacity check per tuple at
        actual need, as in the reference.
        """
        values = np.asarray(values, np.float32).ravel()
        if values.size == 0:
            return
        snap_state = self.state
        snap_pages, snap_fill = self.table.num_pages, self.table.fill
        try:
            self._insert_batch_apply(values)
        except RuntimeError:
            self.state = snap_state
            self.table.truncate_to(snap_pages, snap_fill)
            raise
        self.counters.inserts += len(values)

    def _insert_batch_apply(self, values: np.ndarray) -> None:
        pages = self.table.append(values)
        old = pages <= int(self.state.summarized_until)
        ids = hg.bucketize(self.state.histogram,
                           torch.from_numpy(values).to(self.device))
        if old.any():
            sel = torch.from_numpy(old).to(self.device)
            self.state = hix.or_existing(
                self.cfg, self.state, ids[sel],
                torch.from_numpy(pages[old]).to(self.device))
        if old.all():
            return

        new = torch.from_numpy(~old).to(self.device)
        self.state, _ = hix.insert_tuples(
            self.cfg, self.state, None, pages[~old], ids=ids[new],
            on_full=self._require_slot_capacity)

    def vacuum(self) -> int:
        """Lazy maintenance after deletes (§5.2): re-summarize the entries
        whose ranges hold dirty pages, located with one search of the sorted
        list. Returns entries re-summarized."""
        dirty_pages = np.flatnonzero(self.table.dirty[: self.table.num_pages])
        if dirty_pages.size == 0:
            return 0
        slots, _ = hix.locate_slots(self.state,
                                    torch.from_numpy(dirty_pages))
        affected = torch.zeros((self.cfg.max_slots,), dtype=torch.bool,
                               device=self.device)
        affected[slots.long()] = True
        keys, valid = self._views()
        self.state = hix.resummarize_slots(self.cfg, self.state, keys, valid,
                                           affected)
        self.table.clear_dirty(dirty_pages)
        n = int(affected.sum())
        self.counters.vacuums += 1
        self.counters.entries_resummarized += n
        return n

    # -- introspection -------------------------------------------------------

    @property
    def num_entries(self) -> int:
        return int(self.state.num_entries)

    def nbytes(self, compressed: bool = False) -> int:
        return hix.index_nbytes(self.cfg, self.state, compressed=compressed)

    def entries_host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(starts, ends, bitmaps) of live entries in logical order; bitmaps
        as uint32 words, as the reference returns them."""
        order = self.state.sorted_order.cpu().numpy()[: self.num_entries]
        return (self.state.starts.cpu().numpy()[order],
                self.state.ends.cpu().numpy()[order],
                self.state.bitmaps.cpu().numpy().view(np.uint32)[order])
