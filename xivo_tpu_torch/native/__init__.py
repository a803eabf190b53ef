"""Native (C++) IO runtime: build on first use + ctypes bindings (port of
``xivo_tpu/native/__init__.py``).

``xivo_io.cpp`` (this package's own copy of the reference's source) holds
the csv parser, the PGM/PNG decoders and the SPSC image prefetcher. It is
compiled with g++ at the first call that needs it into
``xivo_tpu_torch/_build/``, the file name carrying a hash of the source
as ``ops/_build.py`` does for the CUDA sources. ``get_lib`` returns None
when no compiler is available; ``io/loader.py`` then decodes in Python,
as the reference's loader does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "xivo_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lock = threading.Lock()
_lib = None


def _build() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libxivo_io_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp, "-lz"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path = _build()
        except Exception:
            return None
        lib = ctypes.CDLL(path)
        lib.xivo_parse_imu_csv.restype = ctypes.c_int
        lib.xivo_parse_imu_csv.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        lib.xivo_load_pgm.restype = ctypes.c_int
        lib.xivo_load_pgm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.xivo_load_image.restype = ctypes.c_int
        lib.xivo_load_image.argtypes = lib.xivo_load_pgm.argtypes
        lib.xivo_prefetcher_create.restype = ctypes.c_void_p
        lib.xivo_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.xivo_prefetcher_next.restype = ctypes.c_int
        lib.xivo_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.xivo_prefetcher_destroy.restype = None
        lib.xivo_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _need_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def parse_imu_csv(path: str, max_rows: int = 1_000_000):
    """(N, 7) array [ts_s, gx, gy, gz, ax, ay, az] via the native parser."""
    lib = _need_lib()
    out = np.empty((max_rows, 7), np.float64)
    n = lib.xivo_parse_imu_csv(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows)
    if n < 0:
        raise IOError(f"failed to open {path}")
    return out[:n].copy()


def _decode(fn, what: str, path: str, max_pixels: int):
    buf = np.empty((max_pixels,), np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    st = fn(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_pixels, ctypes.byref(w), ctypes.byref(h))
    if st != 0:
        raise IOError(f"{what} decode failed ({st}) for {path}")
    return buf[:w.value * h.value].reshape(h.value, w.value).copy()


def load_pgm(path: str, max_pixels: int = 4096 * 4096):
    return _decode(_need_lib().xivo_load_pgm, "pgm", path, max_pixels)


def load_image(path: str, max_pixels: int = 4096 * 4096):
    """Native grayscale decode, PGM or PNG by extension (cv::imread
    IMREAD_GRAYSCALE analogue; PNG via zlib, BT.601 luma for color)."""
    return _decode(_need_lib().xivo_load_image, "image", path, max_pixels)


class ImagePrefetcher:
    """Background-thread image decoder (EstimatorProcess/SPSC analogue)."""

    def __init__(self, paths, capacity: int = 8,
                 max_pixels: int = 2048 * 2048):
        lib = _need_lib()
        self._lib = lib
        self._max_pixels = max_pixels
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._handle = lib.xivo_prefetcher_create(arr, len(paths),
                                                  capacity, max_pixels)
        self._n = len(paths)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        buf = np.empty((self._max_pixels,), np.float32)
        w = ctypes.c_int()
        h = ctypes.c_int()
        st = self._lib.xivo_prefetcher_next(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(w), ctypes.byref(h))
        self._i += 1
        if st == -100:
            raise StopIteration
        if st != 0:
            raise IOError(f"decode failed ({st})")
        return buf[:w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.xivo_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
