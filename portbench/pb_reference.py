"""The plain reference: exact answers worked out from the benchmark's own
copy of the generated column, with the refresh stream's per-day changes
(``changes(k)`` of ``portbench/streams/<name>.py``) applied in the order the
harness acknowledged the operations. Imports nothing of the program, and
never asks the stream to issue an operation.

The keys are whole days stored as float32, and every predicate is a closed
interval of whole days, so a count is a sum of per-day live counts and the
first ``top_k`` row ids of a query are the smallest of the per-day lists of
first row ids. A row's id is its position in load order (what
``page * page_card + slot`` gives for a table filled in that order). Row ids
are checked on a table without a refresh stream: the engine gives a staged
row no id until a drain places it, which the reference cannot see.

``key_dtype`` is the precision the keys and endpoints are compared in:
float32 is the configuration's; the control passes the next one below
(bfloat16), which merges neighbouring days above 256 and must fail.
"""
from __future__ import annotations

import numpy as np
import torch

_PAD = np.iinfo(np.int64).max


def _rounded(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float64)).to(dtype).double() \
        .numpy()


class Reference:
    """Answers batches in the order they were served. A batch is
    ``(n_ops, lo, hi, top_k)``: the refresh operations acknowledged before
    it and its queries' inclusive day intervals. The days are
    ``[0, stream.newest_day(max_ops)]``."""

    def __init__(self, column: np.ndarray, stream, max_ops: int,
                 device, key_dtype: torch.dtype = torch.float32,
                 top_k: int = 0):
        self.stream = stream
        days_col = np.asarray(column).astype(np.int64)
        self.domain = stream.newest_day(max_ops) + 1
        self.counts = np.bincount(days_col, minlength=self.domain)
        self.key_of_day = _rounded(np.arange(self.domain), key_dtype)
        self.key_dtype = key_dtype
        self.device = device
        self.ops_done = 0
        self._first = None          # (domain, top_k) first row ids
        if top_k:
            self._first_rows(days_col, top_k)

    # -- state ---------------------------------------------------------------

    def _first_rows(self, days_col: np.ndarray, k: int) -> None:
        """Per day, the first k row ids of the loaded column."""
        dev = self.device
        col = torch.from_numpy(days_col).to(dev)
        order = torch.sort(col, stable=True).indices
        cnt = torch.bincount(col, minlength=self.domain)
        starts = torch.cumsum(cnt, 0) - cnt
        j = torch.arange(k, device=dev)
        take = j[None, :] < cnt[:, None]
        pos = (starts[:, None] + j[None, :]).clamp(max=max(col.numel() - 1, 0))
        self._first = torch.where(take, order[pos], _PAD)

    def advance(self, n_ops: int) -> None:
        """Apply the refresh operations up to ``n_ops``."""
        if n_ops < self.ops_done:
            raise ValueError("batches must come in the order they were served")
        if n_ops > self.ops_done and self._first is not None:
            raise ValueError("row ids are checked without a refresh stream")
        for k in range(self.ops_done, n_ops):
            for day, rows in self.stream.changes(k):
                self.counts[day] += rows
        self.ops_done = n_ops

    @property
    def live_tuples(self) -> int:
        return int(self.counts.sum())

    # -- answers -------------------------------------------------------------

    def _day_spans(self, lo, hi) -> tuple[np.ndarray, np.ndarray]:
        """[a, b): the days whose key lies in [lo, hi] at ``key_dtype``."""
        lo_r = _rounded(lo, self.key_dtype)
        hi_r = _rounded(hi, self.key_dtype)
        a = np.searchsorted(self.key_of_day, lo_r, side="left")
        b = np.searchsorted(self.key_of_day, hi_r, side="right")
        return a, np.maximum(b, a)

    def counts_for(self, lo, hi) -> np.ndarray:
        a, b = self._day_spans(lo, hi)
        cum = np.concatenate([[0], np.cumsum(self.counts)])
        return cum[b] - cum[a]

    def row_ids_for(self, lo, hi, k: int) -> list[np.ndarray]:
        """Each query's first k qualifying row ids, ascending."""
        if self._first is None or self._first.shape[1] < k:
            raise ValueError(f"built for top_k "
                             f"{0 if self._first is None else self._first.shape[1]}"
                             f", asked for {k}")
        a, b = self._day_spans(lo, hi)
        out = []
        n = len(a)
        span = int((b - a).max()) if n else 0
        step = max(1, (1 << 24) // max(span * k, 1))
        dev = self.device
        for i in range(0, n, step):
            aa = torch.from_numpy(a[i:i + step]).to(dev)
            bb = torch.from_numpy(b[i:i + step]).to(dev)
            d = aa[:, None] + torch.arange(max(span, 1), device=dev)[None, :]
            ok = d < bb[:, None]
            ids = self._first[d.clamp(max=self.domain - 1)][:, :, :k]
            ids = torch.where(ok[:, :, None], ids, _PAD).reshape(len(aa), -1)
            kk = min(k, ids.shape[1])
            best = torch.topk(ids, kk, dim=1, largest=False, sorted=True) \
                .values.cpu().numpy()
            out += [row[row != _PAD] for row in best]
        return out


def judge(reference: Reference, batches: list) -> dict:
    """Compare every served answer with the reference's.

    ``batches``: ``(n_ops, lo, hi, top_k, counts, row_ids)`` in the order
    they were served; ``counts`` holds None for a query that never got its
    answer. Returns the numbers compared (each must be 0)."""
    wrong_counts = wrong_ids = missing = 0
    for n_ops, lo, hi, top_k, counts, row_ids in batches:
        reference.advance(n_ops)
        want = reference.counts_for(lo, hi)
        got_missing = np.asarray([c is None for c in counts])
        missing += int(got_missing.sum())
        got = np.asarray([-1 if c is None else c for c in counts], np.int64)
        wrong_counts += int(((got != want) & ~got_missing).sum())
        if top_k:
            want_ids = reference.row_ids_for(lo, hi, top_k)
            for q, ids in enumerate(row_ids):
                if ids is not None and not np.array_equal(
                        np.asarray(ids, np.int64), want_ids[q]):
                    wrong_ids += 1
    return {"wrong_counts": wrong_counts, "wrong_row_ids": wrong_ids,
            "missing_answers": missing}


def control_answers(control: Reference, batches: list) -> list:
    """The control put in the program's place: the same batches answered by
    the reference at the lower precision."""
    out = []
    for n_ops, lo, hi, top_k, _, _ in batches:
        control.advance(n_ops)
        counts = [int(c) for c in control.counts_for(lo, hi)]
        ids = control.row_ids_for(lo, hi, top_k) if top_k else \
            [None] * len(lo)
        out.append((n_ops, lo, hi, top_k, counts, ids))
    return out
