"""Versioned binary section container — the on-disk layout primitive (a
copy of ``repro.checkpointing.layout``, which the port cannot import; both
packages write and read the same files).

Every durable artifact (index snapshots, and the serialized baseline
indexes of the reference's ``benchmarks/bench_storage``) is one *section
file*: a
fixed-offset header, a fixed-width section table, and raw C-contiguous
array payloads. The layout is deliberately dumb — no compression or
framing cleverness at this layer (bitmap-level encoding happens above, in
``checkpointing.snapshot``) — so a reader can validate the whole file
before trusting a single byte of it:

    offset 0    header (64 bytes)
                  magic ``b"HIPPOIX1"``, format version, section count,
                  table offset, total file size, CRC32 of everything
                  after the header
    offset 64   section table (152 bytes per section)
                  name (48B utf-8), dtype str (16B), ndim, shape (8×u64),
                  absolute payload offset, payload nbytes
    then        payloads, 64-byte aligned

Readers re-derive every extent from the header and refuse anything that
does not add up: short files, bad magic, unknown versions, sections
pointing outside the file, dtype/shape/nbytes disagreement, CRC mismatch.
All refusals raise ``CorruptSnapshotError`` — a torn or truncated file is
an error, never garbage counts.

Durability helpers (``write_file_durable``, ``commit_sentinel``) implement
the fsync-then-rename discipline: payload bytes are fsynced *before* the
commit marker becomes visible, and the marker itself appears via an atomic
``os.replace`` of an fsynced temp file, so a crash at any instant leaves
either the old committed state or the new one — never a committed-but-torn
snapshot.
"""
from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

MAGIC = b"HIPPOIX1"
FORMAT_VERSION = 1

_HEADER = struct.Struct("<8sIIQQI28x")       # magic, ver, nsec, table_off,
_SECTION = struct.Struct("<48s16sII8QQQ")    # file_size, crc  / name, dtype,
_ALIGN = 64                                  # ndim, pad, shape[8], off, nbytes
_MAX_NAME = 48
_MAX_DTYPE = 16
_MAX_NDIM = 8


class CorruptSnapshotError(Exception):
    """The file is not a valid snapshot: truncated, torn, version-bumped,
    or internally inconsistent. Loading must fail loudly, never return
    garbage counts."""


# ---------------------------------------------------------------------------
# Durability primitives (fsync-then-rename)
# ---------------------------------------------------------------------------

def fsync_file(path: str | Path) -> None:
    """Force a file's bytes to stable storage."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str | Path) -> None:
    """Force a directory entry (rename/create) to stable storage."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_file_durable(path: str | Path, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically and durably: temp file in the
    same directory, flush + fsync, ``os.replace`` onto the final name, then
    fsync the directory so the rename itself survives a crash."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)


def commit_sentinel(directory: str | Path, name: str = "COMMITTED") -> Path:
    """Publish a commit marker in ``directory`` via fsync-then-rename.

    Callers must have fsynced the directory's payload files first — the
    sentinel's appearance is the commit point, so everything it vouches for
    has to be durable before it exists.
    """
    directory = Path(directory)
    sentinel = directory / name
    write_file_durable(sentinel, b"")
    return sentinel


# ---------------------------------------------------------------------------
# Section codec
# ---------------------------------------------------------------------------

def _pad_to(n: int, align: int = _ALIGN) -> int:
    return -(-n // align) * align


def pack_sections(sections: dict[str, np.ndarray]) -> bytes:
    """Serialize named arrays into one section-file byte string."""
    entries = []
    payloads = []
    offset = _pad_to(_HEADER.size + _SECTION.size * len(sections))
    for name, arr in sections.items():
        arr = np.asarray(arr)
        if arr.ndim and not arr.flags.c_contiguous:
            # ascontiguousarray only when needed: it promotes 0-d to 1-d,
            # which would silently rewrite a scalar section's shape
            arr = np.ascontiguousarray(arr)
        nb = name.encode("utf-8")
        db = arr.dtype.str.encode("ascii")
        if len(nb) > _MAX_NAME:
            raise ValueError(f"section name too long ({len(nb)} > {_MAX_NAME} "
                             f"bytes): {name!r}")
        if len(db) > _MAX_DTYPE:
            raise ValueError(f"dtype string too long: {arr.dtype.str!r}")
        if arr.ndim > _MAX_NDIM:
            raise ValueError(f"section {name!r} has {arr.ndim} dims "
                             f"(max {_MAX_NDIM})")
        shape = list(arr.shape) + [0] * (_MAX_NDIM - arr.ndim)
        entries.append(_SECTION.pack(nb, db, arr.ndim, 0, *shape,
                                     offset, arr.nbytes))
        payloads.append((offset, arr.tobytes()))
        offset = _pad_to(offset + arr.nbytes)
    body = bytearray(offset - _HEADER.size)
    table = b"".join(entries)
    body[: len(table)] = table
    for off, raw in payloads:
        body[off - _HEADER.size: off - _HEADER.size + len(raw)] = raw
    file_size = _HEADER.size + len(body)
    crc = zlib.crc32(bytes(body))
    header = _HEADER.pack(MAGIC, FORMAT_VERSION, len(sections),
                          _HEADER.size, file_size, crc)
    return header + bytes(body)


def unpack_sections(data: bytes, *, origin: str = "<bytes>"
                    ) -> dict[str, np.ndarray]:
    """Parse and fully validate a section file; inverse of ``pack_sections``.

    Raises ``CorruptSnapshotError`` on any inconsistency — the returned
    arrays are only constructed after every check has passed.
    """
    if len(data) < _HEADER.size:
        raise CorruptSnapshotError(
            f"{origin}: {len(data)} bytes is shorter than the "
            f"{_HEADER.size}-byte header (truncated file)")
    magic, version, nsec, table_off, file_size, crc = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise CorruptSnapshotError(
            f"{origin}: bad magic {magic!r} (not a snapshot file)")
    if version != FORMAT_VERSION:
        raise CorruptSnapshotError(
            f"{origin}: format version {version} != supported "
            f"{FORMAT_VERSION} — refusing to guess at an unknown layout")
    if file_size != len(data):
        raise CorruptSnapshotError(
            f"{origin}: header claims {file_size} bytes, file has "
            f"{len(data)} (truncated or padded file)")
    if table_off != _HEADER.size or \
            table_off + nsec * _SECTION.size > file_size:
        raise CorruptSnapshotError(
            f"{origin}: section table ({nsec} sections at offset "
            f"{table_off}) runs outside the file")
    if zlib.crc32(data[_HEADER.size:]) != crc:
        raise CorruptSnapshotError(
            f"{origin}: CRC mismatch — payload bytes are torn or corrupted")
    out: dict[str, np.ndarray] = {}
    for i in range(nsec):
        (nb, db, ndim, _pad, *rest) = _SECTION.unpack_from(
            data, table_off + i * _SECTION.size)
        shape, off, nbytes = tuple(rest[:_MAX_NDIM]), rest[_MAX_NDIM], rest[-1]
        name = nb.rstrip(b"\0").decode("utf-8", errors="replace")
        if ndim > _MAX_NDIM:
            raise CorruptSnapshotError(
                f"{origin}: section {name!r} claims {ndim} dims")
        try:
            dtype = np.dtype(db.rstrip(b"\0").decode("ascii"))
        except (TypeError, UnicodeDecodeError) as e:
            raise CorruptSnapshotError(
                f"{origin}: section {name!r} has unparseable dtype") from e
        shape = shape[:ndim]
        expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if expect != nbytes:
            raise CorruptSnapshotError(
                f"{origin}: section {name!r} shape {shape} x {dtype} wants "
                f"{expect} bytes, table records {nbytes}")
        if off + nbytes > file_size:
            raise CorruptSnapshotError(
                f"{origin}: section {name!r} payload [{off}, {off + nbytes}) "
                f"runs past the {file_size}-byte file")
        if name in out:
            raise CorruptSnapshotError(
                f"{origin}: duplicate section name {name!r}")
        out[name] = np.frombuffer(
            data, dtype=dtype, count=int(np.prod(shape, dtype=np.int64)),
            offset=off).reshape(shape).copy()
    return out


def write_section_file(path: str | Path,
                       sections: dict[str, np.ndarray]) -> int:
    """Durably write a section file (temp + fsync + rename); returns its
    size in bytes."""
    data = pack_sections(sections)
    write_file_durable(path, data)
    return len(data)


def read_section_file(path: str | Path) -> dict[str, np.ndarray]:
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise CorruptSnapshotError(f"cannot read {path}: {e}") from e
    return unpack_sections(data, origin=str(path))


def section_sizes(path: str | Path) -> dict[str, int]:
    """Per-section payload bytes of a section file (validates it fully)."""
    return {name: arr.nbytes
            for name, arr in read_section_file(path).items()}
