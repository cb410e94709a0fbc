"""PagedTable — the heap-file analogue backing a Hippo index (port of
``repro.storage.table``, read side).

A page is a fixed-width row block of ``page_card`` tuples; the key column is
float32 (num_pages, page_card) on the host (numpy, the buffer manager's
copy), and queries read torch device views of it. The sharded views reshape
the page space into S contiguous slabs of ``pages_per_shard`` pages; slab
pages past ``num_pages`` are zero-key, invalid padding.

Device views follow the port's device rule: ``device=None`` is the card.
Mutations (``delete_where``, appends, ``refresh_shard_slabs``) come with the
maintenance slice (ROADMAP.md, queue 1 item 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass
class PagedTable:
    page_card: int
    capacity_pages: int
    keys: np.ndarray = field(default=None)      # (capacity_pages, page_card) f32
    valid: np.ndarray = field(default=None)     # (capacity_pages, page_card) bool
    num_pages: int = 0                          # pages in use (last may be partial)
    fill: int = 0                               # tuples in the last page
    payload: dict = field(default_factory=dict)  # name -> (capacity, page_card) array
    _dev: tuple | None = field(default=None, repr=False, compare=False)
    _dev_shard: tuple | None = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.keys is None:
            self.keys = np.zeros((self.capacity_pages, self.page_card), np.float32)
        if self.valid is None:
            self.valid = np.zeros((self.capacity_pages, self.page_card), bool)

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
                     device) -> tuple:
        """(keys, valid) slabs of shape (S, PPS, page_card) on ``device``,
        cached like ``_device_views``. Slab pages beyond ``num_pages`` are
        invalid padding."""
        dev = resolve_device(device)
        key = (num_shards, pages_per_shard, self.num_pages, dev)
        if self._dev_shard is None or self._dev_shard[0] != key:
            total = num_shards * pages_per_shard
            if total < self.num_pages:
                raise ValueError(
                    f"slab layout {num_shards}x{pages_per_shard} covers {total} "
                    f"pages < table's {self.num_pages}")
            shape = (num_shards, pages_per_shard, self.page_card)
            self._dev_shard = None      # free the old views before allocating
            keys = torch.zeros(shape, dtype=torch.float32, device=dev)
            valid = torch.zeros(shape, dtype=torch.bool, device=dev)
            n = self.num_pages
            keys.view(total, self.page_card)[:n] = \
                torch.from_numpy(self.keys[:n]).to(dev)
            valid.view(total, self.page_card)[:n] = \
                torch.from_numpy(self.valid[:n]).to(dev)
            self._dev_shard = (key, keys, valid)
        return self._dev_shard

    def device_keys_sharded(self, num_shards: int, pages_per_shard: int,
                            device=None) -> torch.Tensor:
        return self._shard_views(num_shards, pages_per_shard, device)[1]

    def device_valid_sharded(self, num_shards: int, pages_per_shard: int,
                             device=None) -> torch.Tensor:
        return self._shard_views(num_shards, pages_per_shard, device)[2]
