"""A day-sorted table kept as a rolling window: appends of the newest day,
and a retention delete of the oldest day before each new day's first row.

Row r of the appends carries day ``days + r // rows_per_day``; before every
row with ``r % rows_per_day == 0`` the oldest whole day is deleted
(``delete(day, day)``), so the table holds a rolling window of ``days``
days. Operation k is ``("d", day)`` or ``("w", day)``. The configuration
states ``days`` and ``rows_per_day``.
"""
from __future__ import annotations

import numpy as np


class Stream:
    """The daily stream; see the module's docstring and
    ``pb_registry``'s for what each method answers."""

    def __init__(self, config: dict, seed: int, data):
        self.days = int(config["days"])
        self.rows_per_day = int(config["rows_per_day"])
        # the loaded rows of each day, which the day's delete takes away
        self._loaded = np.bincount(np.asarray(data.keys).astype(np.int64))

    def op(self, k: int) -> tuple[str, int]:
        per = self.rows_per_day + 1          # one delete, then a day of rows
        day, j = divmod(k, per)
        if j == 0:
            return ("d", day)
        return ("w", self.days + day)

    def issue(self, eng, k: int) -> str:
        kind, day = self.op(k)
        if kind == "w":
            eng.write(float(day))
        else:
            eng.delete(float(day), float(day))
        return kind

    def changes(self, k: int) -> list[tuple[int, int]]:
        """A write adds its row; day d's delete takes the day's loaded rows
        and, where d is an appended day, the whole day appended (each day
        is deleted once, after every row appended to it)."""
        kind, day = self.op(k)
        if kind == "w":
            return [(day, 1)]
        loaded = int(self._loaded[day]) if day < self._loaded.size else 0
        appended = self.rows_per_day if day >= self.days else 0
        return [(day, -(loaded + appended))]

    def newest_day(self, n_ops: int) -> int:
        """The newest day in the table after the first ``n_ops``
        operations."""
        rows = n_ops - ((n_ops - 1) // (self.rows_per_day + 1) + 1) \
            if n_ops > 0 else 0
        return self.days + (rows - 1) // self.rows_per_day if rows else \
            self.days - 1

    def ops_for_rows(self, rows: int) -> int:
        """Operations up to and including the ``rows``-th append."""
        if rows <= 0:
            return 0
        day, j = divmod(rows - 1, self.rows_per_day)
        return day * (self.rows_per_day + 1) + j + 2

    def due(self, row_due: np.ndarray, first_op: int) -> np.ndarray:
        """A delete comes due with its day's first row."""
        op_due = []
        k = first_op
        for t in row_due:
            if self.op(k)[0] == "d":
                op_due.append(t)
                k += 1
            op_due.append(t)
            k += 1
        return np.asarray(op_due, np.float64)
