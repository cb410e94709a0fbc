"""Quickstart: build a Hippo index, query it, maintain it (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's lifecycle end-to-end: CREATE INDEX (Algorithm 2 density
grouping), range/equality SELECTs (Algorithm 1 bitmap filtering), eager
INSERT (Algorithm 3), lazy DELETE + VACUUM (§5.2) — and prints the
storage/inspection numbers next to a B+-Tree and a BRIN-style min-max index.
Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core.baselines import BPlusTree, MinMaxIndex
from repro_torch.core.hippo import HippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.device import resolve_device
from repro_torch.storage.table import PagedTable


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    dev = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    card, page_card = 100_000, 50
    values = rng.uniform(0, 1_000_000, card)          # unordered attribute

    print("== CREATE INDEX hippo_idx ON t USING hippo(attr) ==")
    table = PagedTable.from_values(values, page_card=page_card, spare_pages=512)
    idx = HippoIndex.create(table, resolution=400, density=0.2, device=dev)
    bt = BPlusTree.bulk_load(values, page_card, device=dev)
    mm = MinMaxIndex.build(table.device_keys(device=dev),
                           table.device_valid(device=dev))
    print(f"  pages={table.num_pages}  hippo entries={idx.num_entries}")
    print(f"  sizes: hippo={idx.nbytes():,} B (rle {idx.nbytes(compressed=True):,}) "
          f"| b+tree={bt.nbytes():,} B ({bt.nbytes()/idx.nbytes():.1f}x) "
          f"| minmax={mm.nbytes():,} B")

    print("\n== SELECT * WHERE attr BETWEEN 500000 AND 501000 (SF~0.1%) ==")
    pred = Predicate.between(500_000, 501_000)
    res = idx.search(pred)
    _, mm_pages = mm.search(table.device_keys(device=dev),
                            table.device_valid(device=dev),
                            500_000.0, 501_000.0)
    print(f"  hippo: {int(res.count)} rows, inspected "
          f"{int(res.pages_inspected)}/{table.num_pages} pages "
          f"({int(res.pages_inspected)/table.num_pages:.1%})")
    print(f"  minmax (unordered data): inspected {int(mm_pages)}/{table.num_pages} "
          f"pages ({int(mm_pages)/table.num_pages:.1%}) — the §8 failure mode")
    brute = int(((values >= 500_000) & (values <= 501_000)).sum())
    assert int(res.count) == brute, "Hippo must be exact"
    print(f"  exactness check vs brute force: OK ({brute} rows)")

    print("\n== INSERT (eager, Algorithm 3) ==")
    before = idx.num_entries
    for v in rng.uniform(0, 1_000_000, 200):
        idx.insert(float(v))
    res2 = idx.search(pred)
    print(f"  inserted 200 tuples; entries {before} -> {idx.num_entries}; "
          f"query still exact: {int(res2.count)} rows")

    print("\n== DELETE + VACUUM (lazy, §5.2) ==")
    n = table.delete_where(500_000, 501_000)
    res3 = idx.search(pred)     # correct BEFORE any index maintenance
    resum = idx.vacuum()
    res4 = idx.search(pred)
    print(f"  deleted {n} tuples; pre-vacuum count={int(res3.count)} (exact), "
          f"vacuum re-summarized {resum}/{idx.num_entries} entries, "
          f"post-vacuum count={int(res4.count)}")
    print(f"  pages inspected after vacuum: {int(res4.pages_inspected)} "
          f"(was {int(res3.pages_inspected)})")


if __name__ == "__main__":
    main()
