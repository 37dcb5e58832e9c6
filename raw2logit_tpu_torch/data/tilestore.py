"""The mmap tile store (port of ``raw2logit_tpu/data/tilestore.py``).

Tiles are decoded once into a packed ``.r2l`` file (``build_store``, byte
for byte the JAX package's format); epochs then read batches through
``TileStore.gather``: mmap and a threaded C++ gather that also
normalises uint16 / uint8 to float32 in [0, 1].

The C++ source is ``csrc/tilestore.cpp``. It is compiled at first use
with the host C++ compiler (``c++``, else ``g++``) into
``build/libtilestore-<hash>.so`` at the repository root (listed in
``.gitignore``) and bound with ``ctypes``. The hash covers the source,
the flags, the compiler's version and the machine, so a stale library,
or one that another host's toolchain built, is never loaded. A missing
compiler or a failed build raises; nothing falls back to Python.
"""

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "tilestore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_DTYPE_CODE = {np.dtype(np.float32): 0, np.dtype(np.uint16): 1,
               np.dtype(np.uint8): 2}


def compiler():
    """The host C++ compiler: ``c++``, else ``g++``; raises
    FileNotFoundError when neither is on PATH."""
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise FileNotFoundError(
        "no C++ compiler (c++ or g++) on PATH: the tile store is built "
        f"from {SOURCE} at first use")


def library_path(cxx):
    """Where ``SOURCE`` builds to with compiler ``cxx``."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    digest = hashlib.sha1()
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    for part in (" ".join(CXX_FLAGS), version, platform.machine(),
                 " ".join(platform.libc_ver())):
        digest.update(part.encode())
    return os.path.join(BUILD_DIR,
                        f"libtilestore-{digest.hexdigest()[:12]}.so")


def build():
    """Compile ``SOURCE`` unless its library exists; returns the library's
    path. Raises RuntimeError with the compiler's log when it fails."""
    cxx = compiler()
    out = library_path(cxx)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library():
    """The ``ctypes`` handle of the tile store, built on first use."""
    lib = ctypes.CDLL(build())
    lib.r2l_open.restype = ctypes.c_void_p
    lib.r2l_open.argtypes = [ctypes.c_char_p]
    lib.r2l_close.restype = None
    lib.r2l_close.argtypes = [ctypes.c_void_p]
    lib.r2l_len.restype = ctypes.c_uint64
    lib.r2l_len.argtypes = [ctypes.c_void_p]
    lib.r2l_shape.restype = None
    lib.r2l_shape.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.r2l_label_kind.restype = ctypes.c_uint64
    lib.r2l_label_kind.argtypes = [ctypes.c_void_p]
    lib.r2l_fill_batch.restype = None
    lib.r2l_fill_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_int]
    lib.r2l_write.restype = ctypes.c_int
    lib.r2l_write.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_void_p]
    return lib


_HEADER_FIELDS = 7  # magic, n, h, w, c, dtype, label_kind (u64 each)
_MAGIC = 0x52324C54494C4531


def _as_stored(x, dtype):
    """``x`` as ``dtype``; an integer store takes counts, so float items
    that are not whole numbers in its range raise instead of being cut to
    0 and 1."""
    x = np.asarray(x)
    if dtype.kind in "ui" and x.dtype.kind == "f":
        info = np.iinfo(dtype)
        if (x.min() < info.min or x.max() > info.max
                or not np.array_equal(x, np.round(x))):
            raise ValueError(
                f"a {dtype} store takes integer counts, got float items in "
                f"[{x.min()}, {x.max()}]: normalised images go into a "
                "float32 store")
    return np.asarray(x, dtype)


def build_store(dataset, path, dtype=np.float32):
    """Materialise an indexable (img, label) dataset into a .r2l store.

    Streams item by item through a numpy memmap of the (fixed-layout)
    file, so it never holds more than one decoded item in memory."""
    n = len(dataset)
    if n == 0:
        raise ValueError("empty dataset")
    x0, y0 = dataset[0]
    x0 = np.asarray(x0)
    h, w = x0.shape[:2]
    c = x0.shape[2] if x0.ndim == 3 else 0
    dtype = np.dtype(dtype)
    code = _DTYPE_CODE[dtype]

    task = getattr(dataset, "task", None)
    if task is None or task == "auto":
        task = ("segmentation" if np.asarray(y0).ndim >= 2
                else "classification")
    label_kind = 0 if task == "classification" else 1

    header = np.array([_MAGIC, n, h, w, c, code, label_kind], np.uint64)
    data_off = _HEADER_FIELDS * 8
    item_elems = (n,) + x0.shape
    labels_off = data_off + int(np.prod(item_elems)) * dtype.itemsize
    if label_kind == 0:
        label_shape, label_dtype = (n,), np.int64
    else:
        label_shape, label_dtype = (n, h, w), np.float32
    total = labels_off + int(np.prod(label_shape)) * \
        np.dtype(label_dtype).itemsize

    with open(path, "wb") as fh:
        fh.truncate(total)
    hdr = np.memmap(path, np.uint64, "r+", 0, (_HEADER_FIELDS,))
    hdr[:] = header
    hdr.flush()
    imgs = np.memmap(path, dtype, "r+", data_off, item_elems)
    labels = np.memmap(path, label_dtype, "r+", labels_off, label_shape)
    for i in range(n):
        x, y = dataset[i]
        imgs[i] = _as_stored(x, dtype)
        labels[i] = np.asarray(y)
    imgs.flush()
    labels.flush()
    return path


class TileStore:
    """mmap-backed random-access tile source with a threaded gather.

    Has the dataset protocol (len, getitem) and ``gather`` for batched
    reads (``data.loader.Loader`` takes it)."""

    def __init__(self, path, task="auto", n_threads=None):
        self._lib = load_library()
        # serialises gathers against close(): a munmap while a prefetch
        # thread is mid-gather would read unmapped memory
        self._lock = threading.Lock()
        self._h = self._lib.r2l_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open tile store {path}")
        shape = (ctypes.c_uint64 * 4)()
        self._lib.r2l_shape(self._h, shape)
        self.h, self.w, self.c, self._dtype_code = (int(s) for s in shape)
        self._n = int(self._lib.r2l_len(self._h))
        kind = int(self._lib.r2l_label_kind(self._h))
        self.task = "classification" if kind == 0 else "segmentation"
        self._label_kind = kind
        if task != "auto" and task != self.task:
            self.close()
            raise ValueError(f"store is {self.task}, requested {task}")
        self.n_threads = (n_threads if n_threads is not None
                          else min(4, os.cpu_count() or 1))

    def __len__(self):
        return self._n

    def __repr__(self):
        return f"TileStore[{self._n}]"

    def gather(self, indices):
        """indices -> (images float32 (B,H,W[,C]), labels int64 (B,) or
        masks float32 (B,H,W)); an index outside [0, len) raises."""
        idx = np.ascontiguousarray(indices, np.int64).reshape(-1)
        b = idx.shape[0]
        if b and (idx.min() < 0 or idx.max() >= self._n):
            raise IndexError(f"tile index out of [0, {self._n}): "
                             f"{idx.min()}..{idx.max()}")
        img_shape = ((b, self.h, self.w) if self.c == 0
                     else (b, self.h, self.w, self.c))
        imgs = np.empty(img_shape, np.float32)
        if self._label_kind == 0:
            labels = np.empty((b,), np.int64)
        else:
            labels = np.empty((b, self.h, self.w), np.float32)
        with self._lock:
            if self._h is None:
                raise ValueError("store is closed")
            self._lib.r2l_fill_batch(
                self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                b, imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.c_void_p), self.n_threads)
        return imgs, labels

    def __getitem__(self, idx):
        imgs, labels = self.gather([idx])
        return imgs[0], (int(labels[0]) if self._label_kind == 0
                         else labels[0])

    def close(self):
        with self._lock:
            if self._h is not None:
                self._lib.r2l_close(self._h)
                self._h = None

    def __del__(self):
        # a half-built store (open failed) has no handle to close
        if getattr(self, "_h", None) is not None:
            self.close()
