"""B+-tree baseline (§7.3's comparison target; §8 "Tree Index Structures")
(port of ``repro.core.baselines.btree``), living on the device.

The reference keeps each node as Python lists; here the tree is pools of
rows, so that a tree over tens of millions of keys sits on the card and a
query is a few tensor operations. The structure is the reference's, node for
node: the same leaves in chain order with the same keys and tids, the same
separators at every level, the same height, the same I/O counters after any
sequence of calls and the same ``nbytes()``.

Layout:

  * Leaves: ``_lkeys`` (cap, F+1) float64 and ``_ltids`` (cap, F+1) int64 on
    the device, one row per leaf, padded with NaN and -1 past the leaf's fill
    (F+1 columns hold a leaf for the moment between an insert and its
    split). The keys are float64, as the reference's: a bulk-loaded key is a
    float32 value, an inserted one keeps its float64 value.
  * Host mirrors of the small parts: each leaf's fill and ``next`` leaf, and
    every internal level (separators (cap, F+1) float64, child ids (cap, F+2)
    int64 into the level below, fills). An insert or a delete descends on
    these mirrors, so that a split is decided without a device sync; only a
    leaf split reads its separator back, and a delete its match.
  * A device view for queries (``_view``), rebuilt after a mutation: the
    internal levels, the chain order of the leaves (list ranking of ``next``
    by pointer jumping) and each leaf's last key in chain order.

A query descends with one compare-and-count (a ``searchsorted``) per level on
the device, finds the first non-empty leaf at or after the descent's leaf
whose last key is > hi, reads the two ranks back and filters the chained
leaves between them. The reference's precision is kept where it matters:
descents and the stop test compare in float64, the leaf filter and the
delete's match in float32 (NumPy rounds a Python float bound to float32
there, ``_as_numpy_compares``). The reference counts storage as 4 B a key,
8 B a pointer or child and 16 B a node header, whatever its Python objects
hold; ``nbytes`` counts the same from the fills.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

_NAN = float("nan")


@dataclass
class IOCounters:
    node_reads: int = 0
    node_writes: int = 0
    node_splits: int = 0


class _Level:
    """Host mirror of one internal level: separators, child ids, fills."""

    def __init__(self, fanout: int, cap: int):
        self.keys = np.full((cap, fanout + 1), np.nan)
        self.child = np.full((cap, fanout + 2), -1, np.int64)
        self.fill = np.zeros(cap, np.int64)
        self.n = 0

    def alloc(self) -> int:
        if self.n == self.keys.shape[0]:
            cap = 2 * self.n
            for name, pad in (("keys", np.nan), ("child", -1), ("fill", 0)):
                old = getattr(self, name)
                new = np.full((cap, *old.shape[1:]), pad, old.dtype)
                new[: self.n] = old
                setattr(self, name, new)
        self.n += 1
        return self.n - 1


def _stable_order(values: torch.Tensor) -> torch.Tensor:
    """``np.argsort(values, kind="stable")`` of a float32 tensor, on its
    device: a stable sort of int32 keys that order the floats as NumPy does
    (+0.0 and -0.0 tie, every NaN last and tied), whatever the backend's
    float sort does with signed zeros and NaN payloads."""
    bits = (values + 0.0).view(torch.int32)          # -0.0 + 0.0 == +0.0
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)         # monotone in the float
    key = torch.where(values.isnan(), torch.iinfo(torch.int32).max, key)
    return torch.sort(key, stable=True).indices


def _as_numpy_compares(x, against) -> tuple[float, torch.dtype]:
    """A bound ``x`` and the dtype NumPy compares it in against values of
    type ``against`` (NEP 50): a Python number takes the other side's dtype,
    a numpy scalar promotes. The bound is rounded to that dtype."""
    if np.result_type(against, x) == np.float64:
        return float(x), torch.float64
    return float(np.float32(x)), torch.float32


class BPlusTree:
    """The reference's B+-tree on ``device``; build it with ``bulk_load``."""

    def __init__(self, fanout: int = 256, device=None, leaf_cap: int = 1):
        self.fanout = fanout
        self.device = resolve_device(device)
        self.io = IOCounters()
        self.num_keys = 0
        f1 = fanout + 1
        cap = max(1, leaf_cap)
        self._lkeys = torch.full((cap, f1), _NAN, dtype=torch.float64,
                                 device=self.device)
        self._ltids = torch.full((cap, f1), -1, dtype=torch.int64,
                                 device=self.device)
        self._lfill = np.zeros(cap, np.int64)
        self._next = np.full(cap, -1, np.int64)
        self._nleaves = 1                  # the root: one empty leaf
        self._levels: list[_Level] = []    # internal levels, lowest first
        self._cols = torch.arange(f1, device=self.device)
        self._cache = None

    @staticmethod
    def from_rows(fanout: int, leaves: list, leaf_next, levels: list,
                  io: IOCounters, num_keys: int, device=None) -> "BPlusTree":
        """A tree from plain rows (``convert.btree_from_reference``):
        ``leaves`` [(keys, tids)] by leaf id, leaf 0 the head of the chain;
        ``leaf_next`` the next leaf id of each (-1 at the tail); ``levels``
        the internal levels from the lowest up, each [(separators, child
        ids)] by node id, node 0 of the top level the root."""
        t = BPlusTree(fanout, device, leaf_cap=len(leaves) + 64)
        n = len(leaves)
        keys = np.full((n, fanout + 1), np.nan)
        tids = np.full((n, fanout + 1), -1, np.int64)
        for i, (k, p) in enumerate(leaves):
            keys[i, : len(k)] = k
            tids[i, : len(p)] = p
            t._lfill[i] = len(k)
        t._lkeys[:n] = torch.from_numpy(keys).to(t.device)
        t._ltids[:n] = torch.from_numpy(tids).to(t.device)
        t._next[:n] = leaf_next
        t._nleaves = n
        for rows in levels:
            lvl = _Level(fanout, len(rows))
            for node, (k, c) in enumerate(rows):
                lvl.alloc()
                lvl.keys[node, : len(k)] = k
                lvl.child[node, : len(c)] = c
                lvl.fill[node] = len(k)
            t._levels.append(lvl)
        t.io = IOCounters(io.node_reads, io.node_writes, io.node_splits)
        t.num_keys = num_keys
        return t

    # -- bulk load (index initialization) ------------------------------------

    @staticmethod
    def bulk_load(values, page_card: int, fanout: int = 256,
                  device=None) -> "BPlusTree":
        """Sorted bottom-up bulk load, the fast CREATE INDEX path: one stable
        device sort, leaves as reshaped rows, internal levels from the
        leaves' first keys. ``values`` is a numpy array or a tensor; it is
        taken as float32, as the reference takes it. Raises ``IndexError``
        where the reference does (a level of n > fanout nodes with
        n % fanout == 1 leaves a parent without separators, whose first
        separator the level above asks for)."""
        dev = resolve_device(device)
        if isinstance(values, torch.Tensor):
            v = values.detach().to(dev, torch.float32).reshape(-1)
        else:
            v = torch.from_numpy(
                np.ascontiguousarray(values, np.float32).ravel()).to(dev)
        n = v.numel()
        num_leaves = -(-n // fanout)
        t = BPlusTree(fanout, dev,
                      leaf_cap=num_leaves + max(64, num_leaves // 32))
        if n == 0:
            return t
        order = _stable_order(v)
        tids = (order // page_card) << 16 | order % page_card
        skeys = v[order].to(torch.float64)
        del order
        pad = num_leaves * fanout - n
        t._lkeys[:num_leaves, :fanout] = torch.nn.functional.pad(
            skeys, (0, pad), value=_NAN).reshape(num_leaves, fanout)
        t._ltids[:num_leaves, :fanout] = torch.nn.functional.pad(
            tids, (0, pad), value=-1).reshape(num_leaves, fanout)
        first = skeys[::fanout].cpu().numpy()
        del skeys, tids
        t._lfill[:num_leaves] = fanout
        t._lfill[num_leaves - 1] = n - (num_leaves - 1) * fanout
        t._next[: num_leaves - 1] = np.arange(1, num_leaves)
        t._nleaves = num_leaves
        t.num_keys = n
        t.io.node_writes += num_leaves
        count, has_first = num_leaves, np.ones(num_leaves, bool)
        while count > 1:
            parents = -(-count // fanout)
            lvl = _Level(fanout, parents)
            lvl.n = parents
            c = np.arange(count)
            slot = c % fanout
            lvl.child[c // fanout, slot] = c
            sep = slot > 0
            if not has_first[sep].all():
                raise IndexError("list index out of range")
            lvl.keys[c[sep] // fanout, slot[sep] - 1] = first[sep]
            lvl.fill[:parents] = np.bincount(c // fanout) - 1
            t._levels.append(lvl)
            t.io.node_writes += parents
            first = lvl.keys[:parents, 0]
            has_first = lvl.fill[:parents] > 0
            count = parents
        return t

    # -- the device view that queries read ------------------------------------

    def _view(self) -> dict:
        """Internal levels (root first), the chain order of the leaves, each
        leaf's rank and each ranked leaf's last key (NaN if empty) on the
        device; rebuilt on the first query after a mutation."""
        if self._cache is not None:
            return self._cache
        dev, n = self.device, self._nleaves
        levels = [(torch.from_numpy(lvl.keys[: lvl.n]).to(dev),
                   torch.from_numpy(lvl.child[: lvl.n]).to(dev))
                  for lvl in reversed(self._levels)]
        # list ranking: each leaf's distance to the tail by pointer jumping
        ptr = torch.from_numpy(self._next[:n]).to(dev)
        dist = (ptr >= 0).to(torch.int64)
        for _ in range((n - 1).bit_length()):     # 2**rounds >= n - 1
            has = ptr >= 0
            at = ptr.clamp(min=0)
            dist = torch.where(has, dist + dist[at], dist)
            ptr = torch.where(has, ptr[at], ptr)
        rank = (n - 1) - dist
        chain = torch.empty_like(rank)
        chain[rank] = torch.arange(n, device=dev)
        fill = torch.from_numpy(self._lfill[:n]).to(dev)[chain]
        last = self._lkeys[chain, (fill - 1).clamp(min=0)]
        last = torch.where(fill > 0, last, _NAN)
        self._cache = {"levels": levels, "chain": chain, "rank": rank,
                       "last": last, "ranks": torch.arange(n, device=dev)}
        return self._cache

    def _scan(self, lo, hi):
        """The chained leaves ``range_search`` visits and the float32 filter
        of their keys: (leaf ids in chain order, (k, F+1) bool mask)."""
        view = self._view()
        n = self._nleaves
        if math.isnan(lo):          # searchsorted sorts NaN last: rightmost
            r0 = torch.tensor(n - 1, device=self.device)
        else:
            node = torch.zeros((), dtype=torch.int64, device=self.device)
            for keys, child in view["levels"]:
                node = child[node, (keys[node] <= float(lo)).sum()]
            r0 = view["rank"][node]
        # the stop test ``node.keys[-1] > hi``: a Python float against hi
        hi_stop, dt = _as_numpy_compares(hi, 1.0)
        last = view["last"].to(dt)
        ranks = view["ranks"]
        stop = torch.where((last > hi_stop) & (ranks >= r0), ranks, n - 1)
        first, end = torch.stack([r0, stop.min()]).tolist()
        self.io.node_reads += len(self._levels) + 1 + (end - first)
        rows = view["chain"][first: end + 1]
        # the leaf filter: the keys as float32 against lo and hi
        k = self._lkeys[rows].to(torch.float32)
        (lo, dt_lo), (hi, dt_hi) = (_as_numpy_compares(lo, np.float32),
                                    _as_numpy_compares(hi, np.float32))
        return rows, (k.to(dt_lo) >= lo) & (k.to(dt_hi) <= hi)

    # -- search -----------------------------------------------------------------

    def range_search(self, lo: float, hi: float) -> torch.Tensor:
        """Tuple pointers with key in [lo, hi], in chain order: a 1-D int64
        tensor on the tree's device."""
        rows, mask = self._scan(lo, hi)
        return self._ltids[rows][mask]

    def count_range(self, lo: float, hi: float) -> int:
        _, mask = self._scan(lo, hi)
        return int(mask.sum())

    # -- maintenance ------------------------------------------------------------

    def _descend(self, key: float) -> tuple[list, int]:
        """The reference's descent on the host mirrors (float64,
        side="right"): the path [(level, node, child index)] from the root
        and the leaf; counts one read per level, the leaf included."""
        path = []
        node = 0
        for lvl in reversed(self._levels):
            f = lvl.fill[node]
            idx = int(np.searchsorted(lvl.keys[node, :f], key, side="right"))
            path.append((lvl, node, idx))
            node = int(lvl.child[node, idx])
        self.io.node_reads += len(path) + 1
        return path, node

    def _alloc_leaf(self) -> int:
        cap = self._lkeys.shape[0]
        if self._nleaves == cap:
            grow = max(64, cap // 4)
            self._lkeys = torch.cat([self._lkeys, self._lkeys.new_full(
                (grow, self.fanout + 1), _NAN)])
            self._ltids = torch.cat([self._ltids, self._ltids.new_full(
                (grow, self.fanout + 1), -1)])
            self._lfill = np.concatenate([self._lfill,
                                          np.zeros(grow, np.int64)])
            self._next = np.concatenate([self._next,
                                         np.full(grow, -1, np.int64)])
        self._nleaves += 1
        return self._nleaves - 1

    def insert(self, key: float, tid: int) -> None:
        key, tid = float(key), int(tid)
        self._cache = None
        path, leaf = self._descend(key)
        f = int(self._lfill[leaf])
        row_k, row_t = self._lkeys[leaf], self._ltids[leaf]
        # searchsorted(keys, key, side="right") on the device: NaN padding
        # compares False, and a NaN key sorts after every key
        pos = f if math.isnan(key) else (row_k <= key).sum()
        cols = self._cols
        before, at = cols < pos, cols == pos
        self._lkeys[leaf] = torch.where(before, row_k, torch.where(
            at, key, row_k.roll(1)))
        self._ltids[leaf] = torch.where(before, row_t, torch.where(
            at, tid, row_t.roll(1)))
        f += 1
        self._lfill[leaf] = f
        self.io.node_writes += 1
        self.num_keys += 1
        if f <= self.fanout:
            return
        # the leaf splits at mid = len // 2; sep = right.keys[0]
        self.io.node_splits += 1
        mid = f // 2
        right = self._alloc_leaf()
        for pool, pad in ((self._lkeys, _NAN), (self._ltids, -1)):
            pool[right, : f - mid] = pool[leaf, mid:f]
            pool[leaf, mid:] = pad
        self._lfill[leaf], self._lfill[right] = mid, f - mid
        self._next[right], self._next[leaf] = self._next[leaf], right
        sep = float(self._lkeys[right, 0])
        self.io.node_writes += 2
        left = leaf
        while True:
            if not path:                           # a new root
                lvl = _Level(self.fanout, 1)
                lvl.n = 1
                lvl.keys[0, 0] = sep
                lvl.child[0, :2] = (left, right)
                lvl.fill[0] = 1
                self._levels.append(lvl)
                self.io.node_writes += 1
                return
            lvl, p, idx = path.pop()
            f = int(lvl.fill[p])
            lvl.keys[p, idx + 1: f + 1] = lvl.keys[p, idx:f].copy()
            lvl.keys[p, idx] = sep
            lvl.child[p, idx + 2: f + 2] = lvl.child[p, idx + 1: f + 1].copy()
            lvl.child[p, idx + 1] = right
            f += 1
            lvl.fill[p] = f
            self.io.node_writes += 1
            if f <= self.fanout:
                return
            # an internal node moves keys[mid] up
            self.io.node_splits += 1
            mid = f // 2
            sep = float(lvl.keys[p, mid])
            q = lvl.alloc()
            lvl.keys[q, : f - mid - 1] = lvl.keys[p, mid + 1: f]
            lvl.child[q, : f - mid] = lvl.child[p, mid + 1: f + 1]
            lvl.keys[p, mid:] = np.nan
            lvl.child[p, mid + 1:] = -1
            lvl.fill[p], lvl.fill[q] = mid, f - mid - 1
            self.io.node_writes += 2
            left, right = p, q

    def delete(self, key: float) -> bool:
        """Eager single-key delete (no rebalancing, conservative I/O count):
        the first key of the descent's leaf equal to ``key`` in float32."""
        _, leaf = self._descend(float(key))
        f = int(self._lfill[leaf])
        hit = self._lkeys[leaf].to(torch.float32) == float(np.float32(key))
        i = int(torch.where(hit, self._cols, self.fanout + 1).min())
        if i > self.fanout:
            return False
        self._cache = None
        for pool, pad in ((self._lkeys, _NAN), (self._ltids, -1)):
            pool[leaf, i: f - 1] = pool[leaf, i + 1: f].clone()
            pool[leaf, f - 1] = pad
        self._lfill[leaf] = f - 1
        self.io.node_writes += 1
        self.num_keys -= 1
        return True

    # -- storage accounting -------------------------------------------------------

    @property
    def height(self) -> int:
        """Levels from the root to the leaves, the leaves included."""
        return len(self._levels) + 1

    def num_nodes(self) -> tuple[int, ...]:
        """Nodes per level, the leaves first."""
        return (self._nleaves, *(lvl.n for lvl in self._levels))

    def nbytes(self) -> int:
        """Key + pointer bytes across all nodes (float32 key, int64
        tid/child, 16 B header), as the reference counts them."""
        total = int(self._lfill[: self._nleaves].sum()) * 12 \
            + 16 * self._nleaves
        for lvl in self._levels:
            f = lvl.fill[: lvl.n]
            total += int(f.sum()) * 12 + 8 * lvl.n + 16 * lvl.n
        return total

    def device_nbytes(self) -> int:
        """Bytes this tree holds on its device: the leaf pools and, once a
        query has run, the query view."""
        held = [self._lkeys, self._ltids, self._cols]
        if self._cache is not None:
            held += [t for pair in self._cache["levels"] for t in pair]
            held += [self._cache[k] for k in ("chain", "rank", "last",
                                              "ranks")]
        return sum(t.numel() * t.element_size() for t in held)

    # -- structure, for the parity tests and the CPU/card comparison -------------

    def structure(self) -> dict:
        """The tree as plain host values: ``internal``, per level from the
        root down, each node's separators in key order (float64 arrays,
        nodes left to right); ``leaves``, (keys float64, tids int64) per leaf
        in chain order; ``leaf_order``, the leaf ids of a left-to-right walk
        of the tree; ``chain``, the leaf ids along ``next``."""
        internal, nodes = [], [0]
        for lvl in reversed(self._levels):
            internal.append([lvl.keys[p, : lvl.fill[p]].copy() for p in nodes])
            nodes = [int(c) for p in nodes
                     for c in lvl.child[p, : lvl.fill[p] + 1]]
        chain, leaf = [], 0
        while leaf >= 0:
            chain.append(leaf)
            leaf = int(self._next[leaf])
        idx = torch.tensor(chain, device=self.device)
        keys = self._lkeys[idx].cpu().numpy()
        tids = self._ltids[idx].cpu().numpy()
        fills = self._lfill[chain]
        return {"internal": internal, "leaf_order": nodes, "chain": chain,
                "leaves": [(keys[i, :f], tids[i, :f])
                           for i, f in enumerate(fills)]}
