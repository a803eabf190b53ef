"""Build and load the port's hand-written CUDA sources (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at the first CUDA call that needs it (never at
import), into ``xivo_tpu_torch/_build/``; the file name carries a hash of
the source, so an edited source is rebuilt. The libraries are loaded with
``ctypes``: every pointer and the stream pass as ``c_void_p``, every C
entry returns a ``cudaError_t`` as int.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of xivo_tpu_torch "
                       "are built from source at first use")


def build(name: str) -> str:
    """Compile csrc/<name>.cu for sm_90a (once per source content) and
    return the shared library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


class Library:
    """One source's compiled library: built and loaded once per process;
    its ``init`` entry (if any) run once per device."""

    def __init__(self, name: str, signatures: dict, init: str = None):
        self.name = name
        self._signatures = signatures     # {C function: [ctypes arg types]}
        self._init = init
        self._lib = None
        self._ready = set()
        self._lock = threading.Lock()

    def get(self, device: torch.device):
        with self._lock:
            if self._lib is None:
                self._lib = self._load(build(self.name))
            if self._init and device.index not in self._ready:
                with torch.cuda.device(device):
                    err = getattr(self._lib, self._init)()
                if err != 0:
                    raise RuntimeError(f"{self.name}: kernel set-up failed "
                                       f"(CUDA error {err})")
            self._ready.add(device.index)
            return self._lib

    def _load(self, path):
        lib = ctypes.CDLL(path)
        sigs = dict(self._signatures)
        if self._init:
            sigs[self._init] = []
        for fname, argtypes in sigs.items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


class Kernel:
    """A wrapper's launch counter: ``launches`` grows by one at each
    kernel launch, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launched(self, err: int):
        """Count a launch, or raise if the launch was refused (too many
        threads or too much shared memory: the kernel never ran)."""
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed "
                               f"(error {err})")
        self.launches += 1


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
