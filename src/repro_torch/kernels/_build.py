"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``repro_torch/csrc/*.cu`` file is compiled for ``sm_90a`` (one ``nvcc``
process per source, all started together) and linked into one shared
library with a plain C interface, on first use, under ``repro_torch/_build/``
(listed in ``.gitignore``). The directory is keyed by a hash of the sources
and flags, so an edited kernel rebuilds and an unchanged one loads at once.
No PyTorch header is compiled: a build takes seconds, where
``torch.utils.cpp_extension.load`` takes minutes.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; ``check``
turns a nonzero code into an exception. Nothing here runs at import time, so
the package imports on a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libhippo_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

# C entry point -> argtypes; every entry point returns a cudaError_t as int.
SIGNATURES = {
    # values, n, bounds, num_bounds, resolution, nan_last, out, stream
    "hippo_bucketize": [_PTR, _I64, _PTR, _I32, _I32, _I32, _PTR, _PTR],
    # values, n, bounds, rows, num_bounds, resolution, nan_last, out, stream
    "hippo_bucketize_rows": [_PTR, _I64, _PTR, _I32, _I32, _I32, _I32, _PTR,
                             _PTR],
    # los, his, nonempty, Q, bounds, rows, num_bounds, resolution, nan_last,
    # words, stream
    "hippo_bucketize_rows_words": [_PTR, _PTR, _PTR, _I32, _PTR, _I32, _I32,
                                   _I32, _I32, _PTR, _PTR],
    # queries, entries, live, S, Q, E, W, out, stream
    "hippo_batch_filter_sharded": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                                   _PTR, _PTR],
    # queries, entries, live, Q, E, W, out, stream
    "hippo_batch_filter": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR, _PTR],
    # keys, valid, sel, sel_mask, los, his, S, P, C, M, Q, counts, stream
    "hippo_compact_inspect": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
                              _I32, _I32, _I32, _PTR, _PTR],
    # entries, query, live, E, W, out, stream
    "hippo_bitmap_and_any": [_PTR, _PTR, _PTR, _I32, _I32, _PTR, _PTR],
    # keys, valid, mask, interval, P, C, qual, counts, stream
    "hippo_page_inspect": [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _PTR, _PTR,
                           _PTR],
    # keys, valid, page_mask, los, his, S, P, C, Q, counts, stream
    "hippo_page_inspect_many": [_PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
                                _I32, _I32, _PTR, _PTR],
}


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, CUDA_PATH): the "
                       "CUDA kernels cannot be built on this machine")


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def build(csrc: Path = CSRC) -> Path:
    """Compile and link the kernels of ``csrc`` (the package's own by
    default) if this source hash has no library yet.

    Returns the library's path. The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept beside it in
    ``build.log``. A failed compile raises with that output.
    """
    out_dir = BUILD_ROOT / source_hash(csrc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    tag = f"{os.getpid()}"
    jobs = []
    for src in sources(csrc):
        obj = out_dir / f"{src.stem}.{tag}.o"
        proc = subprocess.Popen([exe, *COMPILE_FLAGS, "-c", str(src), "-o",
                                 str(obj)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(log))
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run([exe, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "build.log").write_text("\n".join(log))
    _fsync(tmp)
    os.replace(tmp, lib)
    _fsync(out_dir)
    return lib


def load(path: Path, signatures: dict | None = None) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points' types
    (``signatures``, by default ``SIGNATURES``: an earlier design's library
    may declare an entry point with other arguments)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in (signatures or SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hippo_error_string.argtypes = [ctypes.c_int]
    lib.hippo_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once per process)."""
    return load(build())


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        msg = library().hippo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


class Kernel:
    """One C entry point of the library, with its launch counter.

    ``launches`` counts the launches made through ``launch``; nothing else
    touches it, so a run can show that its path went through the kernel.
    ``source`` and ``replaces`` name the CUDA file and the TPU kernel
    (file:line) it replaces. A kernel with more entry points in the same
    file (the bucket probe's rows and words entries) launches them through
    ``launch`` too, under the same counter.
    """

    def __init__(self, symbol: str, source: str, replaces: str):
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args, on: torch.Tensor, entry: str | None = None
               ) -> None:
        """Call the entry point (``entry``, by default ``symbol``) with
        ``args`` on the current stream of ``on``'s device; raise if the
        launch reported a CUDA error."""
        entry = entry or self.symbol
        err = getattr(library(), entry)(*args, stream_of(on))
        check(err, entry)
        self.launches += 1
