"""PagedTable — the heap-file analogue backing a Hippo index (port of
``repro.storage.table``).

A page is a fixed-width row block of ``page_card`` tuples; the key column is
float32 (num_pages, page_card) on the host (numpy, the buffer manager's
copy), and queries read torch device views of it. The sharded views reshape
the page space into S contiguous slabs of ``pages_per_shard`` pages; slab
pages past ``num_pages`` are zero-key, invalid padding.

Mutations are host-side numpy, as in the reference: appends (``insert``,
``insert_batch``, the vectorized ``append``), ``delete_where`` (by key
range) and ``delete_rows`` (by row id, the port's own), which mark tuples
invalid and set the per-page ``dirty`` note that VACUUM consumes (§5.2),
``clear_dirty`` and the rollback ``truncate_to``. Every mutation drops the
unsharded view. The cached slab view instead notes what each mutation
changed (the first page an append wrote, the slabs a range delete hit, the
row ids a row delete cleared) and ``sync_slab_view`` copies just that into
it, in place; every read of the view applies what is pending first, so no
mutation makes a reader upload the table again. A rollback, or a table
that outgrew the view's slabs, drops the view.

Device views follow the port's device rule: ``device=None`` is the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass
class _SlabView:
    """The cached (S, PPS, page_card) device views and what the host table
    changed since they were last in step with it."""
    layout: tuple                   # (num_shards, pages_per_shard, device)
    keys: torch.Tensor
    valid: torch.Tensor
    first_page: int | None = None   # the first page appended to
    slabs: set = field(default_factory=set)     # slabs a range delete hit
    ids: list = field(default_factory=list)     # row ids a row delete cleared

    @property
    def pending(self) -> bool:
        return self.first_page is not None or bool(self.slabs or self.ids)


@dataclass
class PagedTable:
    page_card: int
    capacity_pages: int
    keys: np.ndarray = field(default=None)      # (capacity_pages, page_card) f32
    valid: np.ndarray = field(default=None)     # (capacity_pages, page_card) bool
    dirty: np.ndarray = field(default=None)     # (capacity_pages,) bool — VACUUM notes
    num_pages: int = 0                          # pages in use (last may be partial)
    fill: int = 0                               # tuples in the last page
    num_dirty: int = 0                          # pages with a pending VACUUM note
    payload: dict = field(default_factory=dict)  # name -> (capacity, page_card) array
    _dev: tuple | None = field(default=None, repr=False, compare=False)
    _dev_shard: _SlabView | None = field(default=None, repr=False,
                                         compare=False)

    def __post_init__(self):
        if self.keys is None:
            self.keys = np.zeros((self.capacity_pages, self.page_card), np.float32)
        if self.valid is None:
            self.valid = np.zeros((self.capacity_pages, self.page_card), bool)
        if self.dirty is None:
            self.dirty = np.zeros((self.capacity_pages,), bool)

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_values(values: np.ndarray, page_card: int, spare_pages: int = 0,
                    payload: dict | None = None) -> "PagedTable":
        values = np.asarray(values, np.float32).ravel()
        n = values.size
        num_pages = (n + page_card - 1) // page_card
        cap = num_pages + spare_pages
        t = PagedTable(page_card=page_card, capacity_pages=cap)
        t.keys.reshape(-1)[:n] = values
        t.valid.reshape(-1)[:n] = True
        t.num_pages = num_pages
        t.fill = n - (num_pages - 1) * page_card if n else 0
        for name, col in (payload or {}).items():
            buf = np.zeros((cap, page_card), np.asarray(col).dtype)
            buf.reshape(-1)[:n] = np.asarray(col).ravel()
            t.payload[name] = buf
        return t

    # -- properties ----------------------------------------------------------

    @property
    def cardinality(self) -> int:
        return int(self.valid[: self.num_pages].sum())

    def heap_nbytes(self) -> int:
        """Bytes of live table storage (key column only, paper's table size)."""
        return self.num_pages * self.page_card * 4

    # -- row-id decoding (compact-path result payloads) ----------------------

    def row_values(self, row_ids, payload: str | None = None) -> np.ndarray:
        """Key (or payload-column) values for global row ids
        (``page_id * page_card + slot``). Negative ids (the -1 pads of a
        ``top_k`` result) are skipped. Raises on ids past the table."""
        if isinstance(row_ids, torch.Tensor):
            row_ids = row_ids.cpu().numpy()
        ids = np.asarray(row_ids).ravel()
        ids = ids[ids >= 0]
        if ids.size and int(ids.max()) >= self.num_pages * self.page_card:
            raise IndexError(
                f"row id {int(ids.max())} past the table's "
                f"{self.num_pages * self.page_card} tuple slots")
        col = self.keys if payload is None else self.payload[payload]
        return col.reshape(-1)[ids]

    # -- device views --------------------------------------------------------

    def _device_views(self, n: int, device) -> tuple:
        """(keys, valid) tensors of the first ``n`` pages on ``device``,
        cached per (n, device)."""
        dev = resolve_device(device)
        key = (n, dev)
        if self._dev is None or self._dev[0] != key:
            self._dev = (key, torch.from_numpy(self.keys[:n]).to(dev),
                         torch.from_numpy(self.valid[:n]).to(dev))
        return self._dev

    def device_keys(self, num_pages: int | None = None,
                    device=None) -> torch.Tensor:
        n = self.num_pages if num_pages is None else num_pages
        return self._device_views(n, device)[1]

    def device_valid(self, num_pages: int | None = None,
                     device=None) -> torch.Tensor:
        n = self.num_pages if num_pages is None else num_pages
        return self._device_views(n, device)[2]

    # -- sharded device views (core.partition slab layout) -------------------

    def _shard_views(self, num_shards: int, pages_per_shard: int,
                     device) -> _SlabView:
        """The slab view: keys and valid of shape (S, PPS, page_card) on
        ``device``, cached per layout and brought in step with the host by
        ``sync_slab_view``. Slab pages beyond ``num_pages`` are invalid
        padding."""
        dev = resolve_device(device)
        layout = (num_shards, pages_per_shard, dev)
        v = self._dev_shard
        if v is not None and v.layout == layout:
            if v.pending:
                self.sync_slab_view()
            return v
        total = num_shards * pages_per_shard
        if total < self.num_pages:
            raise ValueError(
                f"slab layout {num_shards}x{pages_per_shard} covers {total} "
                f"pages < table's {self.num_pages}")
        shape = (num_shards, pages_per_shard, self.page_card)
        self._dev_shard = None          # free the old views before allocating
        keys = torch.zeros(shape, dtype=torch.float32, device=dev)
        valid = torch.zeros(shape, dtype=torch.bool, device=dev)
        n = self.num_pages
        keys.view(total, self.page_card)[:n] = \
            torch.from_numpy(self.keys[:n]).to(dev)
        valid.view(total, self.page_card)[:n] = \
            torch.from_numpy(self.valid[:n]).to(dev)
        self._dev_shard = _SlabView(layout, keys, valid)
        return self._dev_shard

    def sync_slab_view(self) -> int:
        """Copy what the host changed since the cached slab view was last in
        step into it, in place; returns the host-to-device bytes copied (0
        with no view, or nothing pending).

        A global page id is its row in the view's flat (S·PPS, C) form, and
        a global row id its element. The pages from the first one appended
        to the table's end, and each slab a range delete hit, are gathered,
        each page once, into a fresh page-locked buffer per tensor (a later
        mutation cannot race its upload) and uploaded with one non-blocking
        copy per contiguous run; the view's pages past ``num_pages`` stay
        zero padding. Then the row ids deleted by id, in one page-locked
        upload, have their valid bits cleared by one indexed store. Both
        read the host, so their order does not matter.
        """
        v = self._dev_shard
        if v is None:
            return 0
        _, pps, dev = v.layout
        n, c = self.num_pages, self.page_card
        pin = dev.type == "cuda"
        runs = [(s * pps, min(s * pps + pps, n)) for s in v.slabs]
        if v.first_page is not None:
            runs.append((v.first_page, n))
        merged: list[list[int]] = []
        for lo, hi in sorted(runs):     # each run is a page or more
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        rows = sum(hi - lo for lo, hi in merged)
        nbytes = 0
        for host, view in ((self.keys, v.keys), (self.valid, v.valid)):
            if not rows:
                break
            buf = torch.empty((rows, c), dtype=view.dtype, pin_memory=pin)
            flat, at = view.view(-1, c), 0
            for lo, hi in merged:
                buf.numpy()[at: at + hi - lo] = host[lo:hi]
                flat[lo:hi].copy_(buf[at: at + hi - lo], non_blocking=True)
                at += hi - lo
            nbytes += buf.numel() * buf.element_size()
        if v.ids:
            ids = np.concatenate(v.ids)
            buf = torch.empty((ids.size,), dtype=torch.int64, pin_memory=pin)
            buf.numpy()[:] = ids
            v.valid.view(-1).index_fill_(0, buf.to(dev, non_blocking=True),
                                         False)
            nbytes += ids.nbytes
        v.first_page, v.slabs, v.ids = None, set(), []
        return nbytes

    def device_keys_sharded(self, num_shards: int, pages_per_shard: int,
                            device=None) -> torch.Tensor:
        return self._shard_views(num_shards, pages_per_shard, device).keys

    def device_valid_sharded(self, num_shards: int, pages_per_shard: int,
                             device=None) -> torch.Tensor:
        return self._shard_views(num_shards, pages_per_shard, device).valid

    # -- mutations (host side = buffer manager) ------------------------------

    def _mutated(self, first_page: int | None = None,
                 pages: np.ndarray | None = None,
                 ids: np.ndarray | None = None) -> None:
        """Drop the unsharded view, and note in the slab view what changed:
        appends from ``first_page`` on, a range delete's hit ``pages``, or a
        row delete's ``ids``. Any other change, or a table past the view's
        slabs, drops the slab view too."""
        self._dev = None
        v = self._dev_shard
        if v is None:
            return
        num_shards, pps, _ = v.layout
        if first_page is not None and self.num_pages <= num_shards * pps:
            if v.first_page is None:    # appends only move forward
                v.first_page = first_page
        elif pages is not None:
            v.slabs.update(np.unique(pages // pps).tolist())
        elif ids is not None:
            v.ids.append(ids)
        else:
            self._dev_shard = None

    def next_page_id(self) -> tuple[int, bool]:
        """(page the next append lands on, whether it opens a new page): the
        append policy that index layers predict through before mutating."""
        new_page = self.fill == self.page_card or self.num_pages == 0
        return (self.num_pages if new_page else self.num_pages - 1), new_page

    def insert(self, value: float) -> tuple[int, bool]:
        """Append one tuple to the last partial page, else open a new page;
        returns (page_id, is_new_page)."""
        _, new_page = self.next_page_id()
        if new_page:
            if self.num_pages == self.capacity_pages:
                self._grow()
            self.num_pages += 1
            self.fill = 0
        p = self.num_pages - 1
        self.keys[p, self.fill] = np.float32(value)
        self.valid[p, self.fill] = True
        self.fill += 1
        self._mutated(first_page=p)
        return p, new_page

    def append_pages(self, n: int) -> np.ndarray:
        """(n,) int64: the pages the next ``n`` appends land on, without
        appending them."""
        base = (self.num_pages - 1) * self.page_card + self.fill \
            if self.num_pages else 0
        return (base + np.arange(n, dtype=np.int64)) // self.page_card

    def append(self, values: np.ndarray,
               live: np.ndarray | None = None) -> np.ndarray:
        """Append ``values`` in order, as ``insert`` would one by one (the
        same pages and fills, and the same growth steps), in one vectorized
        write; returns the (n,) page id of each. Rows where the bool mask
        ``live`` is False take their slots but are never valid (the writer's
        staged rows a delete overtook)."""
        values = np.asarray(values, np.float32).ravel()
        if values.size == 0:
            return np.zeros((0,), np.int64)
        base = (self.num_pages - 1) * self.page_card + self.fill \
            if self.num_pages else 0
        flat = base + np.arange(values.size, dtype=np.int64)
        pages, slots = flat // self.page_card, flat % self.page_card
        while self.capacity_pages <= pages[-1]:
            self._grow()
        self.keys[pages, slots] = values
        self.valid[pages, slots] = True if live is None else live
        self.num_pages = int(pages[-1]) + 1
        self.fill = int(slots[-1]) + 1
        self._mutated(first_page=int(pages[0]))
        return pages

    def insert_batch(self, values: np.ndarray) -> tuple[int, int]:
        """Vectorized append; returns (first_page_touched, last_page)."""
        first = max(self.num_pages - 1, 0)
        self.append(values)
        return first, self.num_pages - 1

    def delete_where(self, lo: float, hi: float) -> int:
        """Mark tuples with key in [lo, hi] deleted; set page dirty notes."""
        live = self.valid[: self.num_pages]
        keys = self.keys[: self.num_pages]
        hit = live & (keys >= lo) & (keys <= hi)
        if not hit.any():
            return 0                      # nothing changed: keep device views
        npages = hit.any(axis=1)
        self.num_dirty += int((npages & ~self.dirty[: self.num_pages]).sum())
        self.valid[: self.num_pages] &= ~hit
        self.dirty[: self.num_pages] |= npages
        self._mutated(pages=np.flatnonzero(npages))
        return int(hit.sum())

    def checked_row_ids(self, row_ids) -> np.ndarray:
        """``row_ids`` unique and ascending, as int64; IndexError for an id
        below 0 or at or past the append tail. Changes nothing."""
        ids = np.unique(np.asarray(row_ids, np.int64).ravel())
        tail = (self.num_pages - 1) * self.page_card + self.fill \
            if self.num_pages else 0
        if ids.size and (ids[0] < 0 or ids[-1] >= tail):
            bad = int(ids[0] if ids[0] < 0 else ids[-1])
            raise IndexError(f"row id {bad} outside the table's {tail} "
                             f"appended tuples")
        return ids

    def delete_rows(self, row_ids) -> np.ndarray:
        """Mark the live tuples at global row ids (``page * page_card +
        slot``) deleted and set their pages' dirty notes; the work grows
        with the ids, not with the table. Raises IndexError, before any
        change, for an id below 0 or at or past the append tail. Returns
        the ids of the tuples it deleted, ascending and unique (ids already
        deleted, or given twice, are left out)."""
        return self.delete_checked_rows(self.checked_row_ids(row_ids))

    def delete_checked_rows(self, ids: np.ndarray) -> np.ndarray:
        """``delete_rows`` for ids that ``checked_row_ids`` returned."""
        pages, slots = np.divmod(ids, self.page_card)
        hit = self.valid[pages, slots]
        if not hit.any():
            return ids[:0]                # nothing changed: keep device views
        ids, pages, slots = ids[hit], pages[hit], slots[hit]
        self.valid[pages, slots] = False
        touched = np.unique(pages)
        self.num_dirty += int((~self.dirty[touched]).sum())
        self.dirty[touched] = True
        self._mutated(ids=ids)
        return ids

    def clear_dirty(self, page_ids: np.ndarray) -> None:
        # dedup: repeated ids must not decrement num_dirty twice
        ids = np.unique(np.asarray(page_ids, np.int64))
        self.num_dirty -= int(self.dirty[ids].sum())
        self.dirty[ids] = False

    def truncate_to(self, num_pages: int, fill: int) -> None:
        """Drop tuples appended past a (num_pages, fill) snapshot: the
        rollback of an atomic batch insert (appends only write forward of
        the snapshot position)."""
        self.valid[num_pages:] = False
        self.keys[num_pages:] = 0.0
        self.num_dirty -= int(self.dirty[num_pages:].sum())
        self.dirty[num_pages:] = False
        if num_pages:
            self.valid[num_pages - 1, fill:] = False
            self.keys[num_pages - 1, fill:] = 0.0
        self.num_pages = num_pages
        self.fill = fill
        self._mutated()

    def _grow(self) -> None:
        add = max(self.capacity_pages // 2, 64)
        c = self.page_card
        self.keys = np.concatenate([self.keys, np.zeros((add, c), np.float32)])
        self.valid = np.concatenate([self.valid, np.zeros((add, c), bool)])
        self.dirty = np.concatenate([self.dirty, np.zeros((add,), bool)])
        for name, buf in self.payload.items():
            self.payload[name] = np.concatenate(
                [buf, np.zeros((add, c), buf.dtype)])
        self.capacity_pages += add
