"""The frozen byte arithmetic against hand-counted shapes, and the index's
bytes against the program's own accounting on a small CPU index."""
import numpy as np
import pytest

import pb_bytes


def test_compact_inspect_bytes_by_hand():
    # one call at SF10's shapes: S=4, Q=64, M=374,929, every page gathered
    s, q, m, pages, c = 4, 64, 374_929, 1_199_722, 50
    want = (pages * c * (4 + 1)           # keys and valid of each page once
            + s * m * 4                   # sel
            + s * q * m                   # sel_mask bytes
            + q * 8                       # los and his
            + s * q * m * 4)              # int32 counts written
    assert pb_bytes.compact_inspect_bytes([(s, q, m)], pages, c) == want
    assert want == 785_838_996   # 0.23464 ms at 3.35 TB/s, chip_smoke's B bound
    # two calls add their fixed parts; the gathered pages are a total
    assert pb_bytes.compact_inspect_bytes([(1, 2, 3), (1, 2, 3)], 5, 10) \
        == 2 * (12 + 6 + 16 + 24) + 5 * 50


def test_batch_filter_bytes_by_hand():
    s, q, e, w = 4, 64, 469_685, 13
    want = s * q * w * 4 + s * e * w * 4 + s * e + s * q * e
    assert pb_bytes.batch_filter_bytes([(s, q, e, w)]) == want == 219_825_892   # 0.06562 ms, A's bound


def test_roofline_percent():
    assert pb_bytes.roofline_percent(3.35e9, 1e-3) == pytest.approx(100.0)
    assert pb_bytes.roofline_percent(0, 1.0) is None
    assert pb_bytes.roofline_percent(10, 0.0) is None


def test_index_nbytes_equals_the_programs_accounting():
    from repro_torch.core.partition import ShardedHippoIndex
    from repro_torch.storage.table import PagedTable
    rng = np.random.default_rng(3)
    table = PagedTable.from_values(
        rng.integers(0, 2555, 30_000).astype(np.float32), page_card=50)
    idx = ShardedHippoIndex.create(table, num_shards=4, resolution=400,
                                   density=0.2, device="cpu")
    st = idx.state.shards
    got = pb_bytes.index_nbytes(st.num_entries.tolist(),
                                st.slot_live.sum(dim=1).tolist(),
                                idx.cfg.words, int(st.bounds.shape[1]),
                                idx.spec.num_shards)
    assert got == idx.nbytes()
