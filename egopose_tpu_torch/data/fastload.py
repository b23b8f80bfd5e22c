"""ctypes bindings for the native packed-flow loader (counterpart of
egopose_tpu/data/fastload.py).

The port's own ``fastload.c`` is compiled with ``cc`` at first use into
``egopose_tpu_torch/_build/`` (the library's name hashes the source).
Unlike the JAX package's loader, a failed build, load or read raises: it
never falls back to numpy memmap reads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastload.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfastload_{digest}.so")


def _build(out: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-pthread", "-o",
                           tmp, _SRC], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed to build {_SRC}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def get_lib():
    """The native library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.fl_open.restype = ctypes.c_int
            lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64]
            lib.fl_read_batch.restype = ctypes.c_int
            lib.fl_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int]
            lib.fl_close_all.restype = None
            _lib = lib
        return _lib


def _npy_header_len(path):
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic[:6] != b"\x93NUMPY":
            raise ValueError(f"{path} is not a .npy file")
        if magic[6] == 1:
            return 10 + int.from_bytes(f.read(2), "little")
        return 12 + int.from_bytes(f.read(4), "little")


class PackedFlowReader:
    """Parallel chunk reader over packed per-take .npy files.

    reader = PackedFlowReader({take: path})
    arrs = reader.read_batch([(take, start, count), ...])  # float32 arrays
    """

    def __init__(self, paths: dict, n_threads: int = 8):
        self.n_threads = n_threads
        self.lib = get_lib()
        self.shapes, self.native = {}, {}
        for take, path in paths.items():
            arr = np.load(path, mmap_mode="r")
            if arr.dtype != np.float32 or not arr.flags.c_contiguous:
                raise ValueError(f"{path}: packed flow must be C-ordered "
                                 f"float32, not {arr.dtype}")
            self.shapes[take] = arr.shape
            frame_bytes = int(np.prod(arr.shape[1:])) * 4
            idx = self.lib.fl_open(path.encode(), _npy_header_len(path),
                                   frame_bytes, arr.shape[0])
            if idx < 0:
                raise OSError(f"fastload could not open {path} ({idx})")
            self.native[take] = idx

    def read_batch(self, requests):
        """requests: list of (take, start, count) -> list of (count, ...)
        float32 arrays, read in parallel by the native thread pool."""
        n = len(requests)
        fidx = (ctypes.c_int32 * n)()
        starts = (ctypes.c_int64 * n)()
        counts = (ctypes.c_int64 * n)()
        bufs = (ctypes.c_char_p * n)()
        outs = []
        for i, (take, s, c) in enumerate(requests):
            shape = self.shapes[take]
            if s < 0 or c < 0 or s + c > shape[0]:
                raise IndexError(f"frames [{s}, {s + c}) of {take}'s "
                                 f"{shape[0]}")
            out = np.empty((c,) + shape[1:], np.float32)
            outs.append(out)
            fidx[i] = self.native[take]
            starts[i], counts[i] = s, c
            bufs[i] = ctypes.cast(out.ctypes.data, ctypes.c_char_p)
        if self.lib.fl_read_batch(fidx, starts, counts, bufs, n,
                                  self.n_threads) != 0:
            raise OSError(f"fastload read failed for {requests}")
        return outs
