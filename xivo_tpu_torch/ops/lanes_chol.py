"""Batched Cholesky / Cholesky+inverse / triangular inverse (port of
``xivo_tpu/ops/lanes_chol.py``).

Three wrappers, one hand-written CUDA kernel each (``csrc/lanes_chol.cu``):

* ``chol_lanes(G)``      -> L        replaces ``_chol_lanes_kernel``
* ``chol_inv_lanes(G)``  -> (L, L^-1) replaces ``_chol_inv_lanes_kernel``
* ``tri_inv_lanes(L)``   -> L^-1     replaces ``_tri_inv_lanes_kernel``

All take (B, m, m) and keep the reference's numerical contract: a pivot
at or below 1e-30 zeroes its column of L (its row of L^-1), so
exactly-zero rows and columns stay exactly zero; upper triangles are zero.

Dispatch is by the tensor's device alone. A CPU tensor takes the plain
PyTorch version beside each kernel (which mirrors the reference's
``_chol_fallback``/``_tri_inv_fallback``); a CUDA tensor launches the
kernel or raises. The kernels are built with ``nvcc`` at the first CUDA
call (never at import) into ``xivo_tpu_torch/_build/`` and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_FLOOR = 1e-30
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "lanes_chol.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build")


# ---------------------------------------------------------------------------
# plain versions (CPU path; the yardstick the kernels are checked against)
# ---------------------------------------------------------------------------

def chol_plain(G):
    """Masked Cholesky: unit pivot on rows whose diagonal is dead,
    re-zeroed after (``_chol_fallback``). Never raises on an indefinite
    input; like the reference it returns NaN there."""
    keep = torch.diagonal(G, dim1=-2, dim2=-1) > _FLOOR
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    Gm = torch.where(keep[..., :, None] & keep[..., None, :], G, eye)
    L, info = torch.linalg.cholesky_ex(Gm, check_errors=False)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    return torch.where(keep[..., :, None], L, 0.0)


def tri_inv_plain(L):
    """Inverse of lower-triangular L with positive or dead diagonal
    (``_tri_inv_fallback``): dead rows of the inverse are zero."""
    keep = torch.diagonal(L, dim1=-2, dim2=-1) > _FLOOR
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Lm = torch.where(keep[..., :, None] & keep[..., None, :], L, eye)
    inv = torch.linalg.solve_triangular(Lm, eye.expand(L.shape), upper=False)
    return torch.where(keep[..., :, None], inv, 0.0)


def chol_inv_plain(G):
    L = chol_plain(G)
    return L, tri_inv_plain(L)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

class _Library:
    """The compiled kernel library: built and loaded once per process, its
    kernels' shared-memory limits set once per device."""

    def __init__(self):
        self._lib = None
        self._ready = set()
        self._lock = threading.Lock()

    def get(self, device: torch.device):
        with self._lock:
            if self._lib is None:
                self._lib = self._load(build())
            if device.index not in self._ready:
                with torch.cuda.device(device):
                    err = self._lib.xivo_lanes_chol_init()
                if err != 0:
                    raise RuntimeError(
                        f"lanes_chol: kernel set-up failed (CUDA error {err})")
                self._ready.add(device.index)
            return self._lib

    @staticmethod
    def _load(path):
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xivo_lanes_chol_init.argtypes = []
        lib.xivo_chol_f32.argtypes = [p, p, i, i, p]
        lib.xivo_chol_inv_f32.argtypes = [p, p, p, i, i, p]
        lib.xivo_tri_inv_f32.argtypes = [p, p, i, i, p]
        for fn in (lib.xivo_lanes_chol_init, lib.xivo_chol_f32,
                   lib.xivo_chol_inv_f32, lib.xivo_tri_inv_f32):
            fn.restype = i
        return lib


_LIB = _Library()


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of xivo_tpu_torch "
                       "are built from source at first use")


def build() -> str:
    """Compile csrc/lanes_chol.cu for sm_90a (once per source content) and
    return the shared library's path."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(_BUILD_DIR, f"liblanes_chol_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


class Kernel:
    """A wrapper's launch counter: ``launches`` grows by one at each
    kernel launch, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


CHOL = Kernel("chol_lanes")
CHOL_INV = Kernel("chol_inv_lanes")
TRI_INV = Kernel("tri_inv_lanes")
KERNELS = (CHOL, CHOL_INV, TRI_INV)


def _check_input(X):
    if X.dtype != torch.float32:
        raise TypeError(f"CUDA kernel takes float32, got {X.dtype}")
    if X.dim() != 3 or X.shape[-1] != X.shape[-2]:
        raise ValueError(f"expected (B, m, m), got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _launched(err: int, kernel: Kernel):
    """Count a launch, or raise: also where m is too large for one block's
    shared memory (the launch is then invalid)."""
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed (error {err})")
    kernel.launches += 1


def _stream(X):
    return torch.cuda.current_stream(X.device).cuda_stream


def chol_lanes(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (B, m, m) PSD matrices (masked-pivot contract)."""
    if G.device.type == "cpu":
        return chol_plain(G)
    B, m, _ = G.shape
    _check_input(G)
    out = torch.empty_like(G)
    with torch.cuda.device(G.device):
        err = _LIB.get(G.device).xivo_chol_f32(
            G.data_ptr(), out.data_ptr(), B, m, _stream(G))
    _launched(err, CHOL)
    return out


def chol_inv_lanes(G: torch.Tensor):
    """(L, L^-1) of (B, m, m) PSD matrices in one fused pass."""
    if G.device.type == "cpu":
        return chol_inv_plain(G)
    B, m, _ = G.shape
    _check_input(G)
    L = torch.empty_like(G)
    Linv = torch.empty_like(G)
    with torch.cuda.device(G.device):
        err = _LIB.get(G.device).xivo_chol_inv_f32(
            G.data_ptr(), L.data_ptr(), Linv.data_ptr(), B, m, _stream(G))
    _launched(err, CHOL_INV)
    return L, Linv


def tri_inv_lanes(L: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, m, m) lower-triangular matrices with positive or dead
    (zero) diagonals; only the lower triangle of L is read."""
    if L.device.type == "cpu":
        return tri_inv_plain(L)
    B, m, _ = L.shape
    _check_input(L)
    out = torch.empty_like(L)
    with torch.cuda.device(L.device):
        err = _LIB.get(L.device).xivo_tri_inv_f32(
            L.data_ptr(), out.data_ptr(), B, m, _stream(L))
    _launched(err, TRI_INV)
    return out
