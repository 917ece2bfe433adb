"""ctypes bindings for the native C++ batch prefetcher (`native/prefetch.cc`).

A copy of `tcdiff_tpu/data/native_loader.py`. The reference overlaps host
IO with device compute through torch DataLoader worker processes
(`TCDiff.py:181-196`); here a C++ thread pool parses the feature .npy files
straight into a preallocated buffer, with a bounded queue of batches in
flight: the same overlap, with no pickling between processes.

`native/prefetch.cc` is built with g++ on first use into
`tcdiff_torch/build/libprefetch-<hash>.so` (the hash of the source, so an
edited source is rebuilt; the JAX package builds its own copy in
`native/`, and the two never share a file). `native_available()` gates
callers; `PrefetchingBatches` falls back to the dataset's synchronous
numpy loading where no toolchain exists, and says which loader ran
(`loader`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from tcdiff_torch.parallel.mesh import Rows

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "prefetch.cc"
_BUILD = Path(__file__).resolve().parent.parent / "build"
_lib = None
_build_lock = threading.Lock()


def _lib_path() -> Path:
    return _BUILD / f"libprefetch-{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    """The loaded library, built first where it is missing; None without a
    compiler or without the source."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        if not _SRC.exists():
            return None
        path = _lib_path()
        if not path.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", str(_SRC),
                                "-o", str(tmp)], check=True, capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                return None
            os.replace(tmp, path)  # another process may build it too: the rename is atomic
        lib = ctypes.CDLL(str(path))
        lib.pf_create.restype = ctypes.c_void_p
        lib.pf_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.pf_submit.restype = ctypes.c_int64
        lib.pf_submit.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.pf_next.restype = ctypes.c_int64
        lib.pf_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.pf_destroy.restype = None
        lib.pf_destroy.argtypes = [ctypes.c_void_p]
        lib.pf_read_npy_f32.restype = ctypes.c_int
        lib.pf_read_npy_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _build() is not None


def read_npy_f32(path: str, shape: Sequence[int]) -> np.ndarray:
    """Native single-file .npy read (float32/float64, C order)."""
    lib = _build()
    if lib is None:
        raise RuntimeError("native prefetcher unavailable (no g++?)")
    out = np.empty(shape, dtype=np.float32)
    if not lib.pf_read_npy_f32(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size):
        raise IOError(f"native npy read failed: {path}")
    return out


class NativePrefetcher:
    """Thread-pool loader over a fixed file list.

    submit(indices) enqueues a batch; next() blocks for the OLDEST submitted
    batch and returns it as (batch, *item_shape) float32.
    """

    def __init__(self, files: Sequence[str], item_shape: Sequence[int], n_threads: int = 8):
        self._lib = _build()
        if self._lib is None:
            raise RuntimeError("native prefetcher unavailable (no g++?)")
        self.item_shape = tuple(item_shape)
        self._elems = int(np.prod(item_shape))
        self._encoded = [f.encode() for f in files]
        arr = (ctypes.c_char_p * len(self._encoded))(*self._encoded)
        self._handle = self._lib.pf_create(arr, len(self._encoded), self._elems, n_threads)
        self._pending = []

    def submit(self, indices: Sequence[int]) -> None:
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self._encoded)):
            raise IndexError(f"file index out of range: {indices}")
        self._lib.pf_submit(self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx))
        self._pending.append(len(idx))

    def next(self) -> np.ndarray:
        n = self._pending.pop(0)
        out = np.empty((n, *self.item_shape), dtype=np.float32)
        rid = self._lib.pf_next(self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
        if rid < 0:
            raise IOError("native prefetcher: a file in the batch failed to parse")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.pf_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PrefetchingBatches:
    """Async epoch iterator over an AIOZDataset-like object.

    Keeps `depth` batches in flight in the native pool: while the device
    runs step N, the pool parses the features of steps N+1..N+depth. Falls
    back to the dataset's synchronous `batches()` without a toolchain.
    `loader` is "native" or "numpy" once iteration has begun. With `rows`
    (a data-parallel rank's share of each global batch of `batch_size`)
    every rank walks the same order and reads only its rows' files.
    """

    def __init__(self, dataset, batch_size: int, rng=None, depth: int = 2, n_threads: int = 8,
                 item_shape=(301, 438), rows: Optional[Rows] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = rng
        self.rows = rows
        self.depth = depth
        self.n_threads = n_threads
        self.item_shape = item_shape
        self.loader: Optional[str] = None

    def __iter__(self) -> Iterator[dict]:
        if not native_available():
            self.loader = "numpy"
            yield from self.dataset.batches(self.batch_size, rng=self.rng, rows=self.rows)
            return
        self.loader = "native"
        order = np.arange(len(self.dataset))
        if self.rng is not None:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % self.batch_size)
        starts = list(range(0, stop, self.batch_size))
        if not starts:
            return
        pf = NativePrefetcher(self.dataset.feature_files, self.item_shape, self.n_threads)
        try:
            chunks = [order[s:s + self.batch_size] for s in starts]
            if self.rows is not None:
                chunks = [self.rows.take(c) for c in chunks]
            for c in chunks[:self.depth]:
                pf.submit(c)
            for i, idx in enumerate(chunks):
                feats = pf.next()
                if i + self.depth < len(chunks):
                    pf.submit(chunks[i + self.depth])
                yield {
                    "x": self.dataset.poses[idx],
                    "cond": feats,
                    "filename": [self.dataset.feature_files[j] for j in idx],
                    "wav": [self.dataset.wav_files[j] for j in idx],
                }
        finally:
            pf.close()
