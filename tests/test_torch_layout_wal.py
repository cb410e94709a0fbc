"""Port parity: the section container (``repro_torch.checkpointing.layout``)
and the write-ahead journal (``repro_torch.checkpointing.wal``).

Both are copies of the reference's modules, so the bar is the same bytes:
a section file or a journal written by either copy is byte-identical to
the other's and reads back in the other, and the port refuses every
corruption the reference refuses (truncation, bad magic, unknown version,
a flipped payload byte) with its own ``CorruptSnapshotError``. The journal
replays in admission order, drops a torn tail, keeps sequence numbers
increasing across ``reset`` and keeps only the records past a watermark in
``truncate_through``.
"""
import struct

import numpy as np
import pytest

from repro.checkpointing import layout as jlayout
from repro.checkpointing.wal import Journal as JJournal
from repro_torch.checkpointing import layout as tlayout
from repro_torch.checkpointing.wal import Journal as TJournal
from repro_torch.runtime import faultinject as tfi

pytestmark = pytest.mark.persist

_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "uint32", "bool"]
COPIES = {"reference": (jlayout, JJournal), "port": (tlayout, TJournal)}


def _sections(seed: int, n: int = 6) -> dict:
    """Named arrays of every dtype, 0-d to 3-d, empty shapes included."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        dt = np.dtype(_DTYPES[int(rng.integers(len(_DTYPES)))])
        shape = tuple(int(rng.integers(0, 5))
                      for _ in range(int(rng.integers(0, 4))))
        size = int(np.prod(shape, dtype=np.int64))
        raw = rng.integers(0, 256, size * dt.itemsize, dtype=np.uint8)
        arr = raw.view(dt) if dt != np.bool_ else raw.astype(bool)[:size]
        out[f"sec_{i}/{dt.name}"] = arr.reshape(shape)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_pack_is_byte_identical_and_reads_in_both(seed):
    secs = _sections(seed)
    data = tlayout.pack_sections(secs)
    assert data == jlayout.pack_sections(secs)
    for mod in (jlayout, tlayout):
        back = mod.unpack_sections(data)
        assert list(back) == list(secs)
        for k, a in secs.items():
            assert back[k].dtype == a.dtype and back[k].shape == a.shape
            assert back[k].tobytes() == a.tobytes()


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_section_file_written_by_one_copy_reads_in_the_other(
        tmp_path, writer, reader):
    secs = _sections(11)
    path = tmp_path / "index.bin"
    n = COPIES[writer][0].write_section_file(path, secs)
    assert n == path.stat().st_size
    back = COPIES[reader][0].read_section_file(path)
    assert {k: v.tobytes() for k, v in back.items()} == \
        {k: v.tobytes() for k, v in secs.items()}
    assert COPIES[reader][0].section_sizes(path) == \
        {k: v.nbytes for k, v in secs.items()}


def test_layout_refuses_truncation_everywhere():
    data = tlayout.pack_sections(_sections(3))
    for cut in sorted({0, 1, 63, 64, 65, len(data) // 2, len(data) - 1}):
        with pytest.raises(tlayout.CorruptSnapshotError):
            tlayout.unpack_sections(data[:cut])


@pytest.mark.parametrize("what", ["magic", "version"])
def test_layout_refuses_bad_magic_and_unknown_version(what):
    data = bytearray(tlayout.pack_sections(_sections(4)))
    if what == "magic":
        data[:8] = b"NOTHIPPO"
        match = "bad magic"
    else:
        struct.pack_into("<I", data, 8, tlayout.FORMAT_VERSION + 1)
        match = "format version"
    for mod in (jlayout, tlayout):
        with pytest.raises(mod.CorruptSnapshotError, match=match):
            mod.unpack_sections(bytes(data))


def test_layout_refuses_a_flipped_payload_byte():
    data = bytearray(tlayout.pack_sections(_sections(5)))
    data[-1] ^= 0x40
    with pytest.raises(tlayout.CorruptSnapshotError, match="CRC"):
        tlayout.unpack_sections(bytes(data))


def test_commit_sentinel_is_published_after_the_payload(tmp_path):
    path = tmp_path / "snap" / "index.bin"
    path.parent.mkdir()
    tlayout.write_section_file(path, {"a": np.arange(3)})
    s = tlayout.commit_sentinel(path.parent)
    assert s.exists() and s.read_bytes() == b""
    assert not list(path.parent.glob("*.tmp"))


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------

def _appends(j):
    j.append_insert(1, 10.5)
    j.append_delete(3.0, 4.0)
    j.append_insert(0, -2.0)
    j.append_resummarize(np.linspace(0.0, 1.0, 9).astype(np.float32),
                         "learned")
    j.append_insert(1, np.float32(7.25))


def test_journal_files_are_byte_identical(tmp_path):
    for name, (_, journal) in COPIES.items():
        j = journal(tmp_path / name, 2, sync=False)
        _appends(j)
        j.close()
    for f in sorted((tmp_path / "reference" / "wal").iterdir()):
        assert f.read_bytes() == \
            (tmp_path / "port" / "wal" / f.name).read_bytes(), f.name


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_journal_written_by_one_copy_replays_in_the_other(
        tmp_path, writer, reader):
    j = COPIES[writer][1](tmp_path, 2, sync=False)
    _appends(j)
    j.close()
    got = COPIES[reader][1](tmp_path, 2, sync=False)
    want = COPIES[writer][1](tmp_path, 2, sync=False)
    for a, b in zip(got.replay(), want.replay()):
        assert (a.seqno, a.kind, a.shard, a.value, a.lo, a.hi, a.policy) == \
            (b.seqno, b.kind, b.shard, b.value, b.lo, b.hi, b.policy)
        if a.bounds is not None:
            assert np.array_equal(a.bounds, b.bounds)
    assert got.last_seqno == want.last_seqno == 5


def test_journal_replay_is_exact_and_ordered(tmp_path):
    j = TJournal(tmp_path, 2, sync=False)
    _appends(j)
    recs = j.replay()
    assert [r.kind for r in recs] == [1, 2, 1, 3, 1]
    assert [r.seqno for r in recs] == [1, 2, 3, 4, 5]
    assert (recs[0].shard, recs[0].value) == (1, 10.5)
    assert (recs[1].lo, recs[1].hi) == (3.0, 4.0)
    assert recs[3].policy == "learned"
    np.testing.assert_array_equal(recs[3].bounds,
                                  np.linspace(0.0, 1.0, 9).astype(np.float32))
    assert [r.seqno for r in j.replay(after=2)] == [3, 4, 5]
    with pytest.raises(ValueError):
        j.append_insert(2, 1.0)
    with pytest.raises(ValueError, match="policy"):
        j.append_resummarize(np.ones(3, np.float32), "bogus")


def test_journal_ignores_torn_tail_and_keeps_seqnos_monotonic(tmp_path):
    j = TJournal(tmp_path, 2, sync=False)
    for i in range(5):
        j.append_insert(i % 2, float(i))
    j.close()
    log = tmp_path / "wal" / "shard_1.log"
    log.write_bytes(log.read_bytes()[:-3])      # torn final record
    j2 = TJournal(tmp_path, 2, sync=False)
    assert len(j2.replay()) == 4, "only the torn record may be dropped"
    assert len(JJournal(tmp_path, 2, sync=False).replay()) == 4
    j2.reset()
    j2.append_insert(0, 9.0)
    assert j2.replay()[0].seqno > 5


def test_truncate_through_drops_only_at_or_below_watermark(tmp_path):
    j = TJournal(tmp_path, 2, sync=False)
    for i in range(6):
        j.append_insert(i % 2, float(i))
    j.append_delete(1.0, 2.0)                                   # seqno 7
    j.append_resummarize(np.linspace(0.0, 1.0, 9).astype(np.float32),
                         "learned")                             # seqno 8
    j.truncate_through(5)
    assert [r.seqno for r in j.replay()] == [6, 7, 8]
    j2 = TJournal(tmp_path, 2, sync=False)
    assert [r.seqno for r in j2.replay()] == [6, 7, 8]
    assert j2.last_seqno == 8
    assert [r.seqno for r in JJournal(tmp_path, 2, sync=False).replay()] == \
        [6, 7, 8]
    j2.truncate_through(100)
    assert j2.replay() == []


def test_journal_append_crash_point_writes_nothing(tmp_path):
    j = TJournal(tmp_path, 2, sync=False)
    j.append_insert(0, 1.0)
    tfi.crash_points.reset()
    tfi.crash_points.arm("wal.pre_append")
    try:
        with pytest.raises(tfi.InjectedCrash):
            j.append_insert(1, 2.0)
        assert tfi.crash_points.fired("wal.pre_append") == 1
    finally:
        tfi.crash_points.reset()
    assert [r.seqno for r in j.replay()] == [1] and j.last_seqno == 1
