"""ASL/EuRoC/TUM-VI dataset loading (port of ``xivo_tpu/io/loader.py``).

Port of the reference DataLoader (src/loader.{h,cpp}): csv-indexed image
+ IMU streams merged and sorted by timestamp, with the directory
conventions of TUM-VI / EuRoC / xivo / void datasets
(src/loader.cpp:14-150). Image decoding is host-side, in the
reference's order: ``.npy`` with numpy; ``.pgm``/``.ppm`` and ``.png``
with the port's native decoder (``xivo_tpu_torch/native``) when it is
built, else in Python (PNM) or with PIL.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np


@dataclass
class ImageMsg:
    ts: float              # seconds
    path: str
    _img: Optional[np.ndarray] = None

    def image(self) -> np.ndarray:
        if self._img is not None:
            return self._img
        return load_image(self.path)


@dataclass
class IMUMsg:
    ts: float
    gyro: np.ndarray
    accel: np.ndarray


Msg = Union[ImageMsg, IMUMsg]


def load_image(path: str) -> np.ndarray:
    """Grayscale float32 image loader (replaces cv::imread)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        img = np.load(path)
    elif ext in (".pgm", ".ppm"):
        # prefer the native decoder (xivo_tpu_torch/native) when built
        try:
            from .. import native
            if native.get_lib() is not None:
                return native.load_pgm(path)
        except Exception:
            pass
        img = _load_pnm(path)
    else:
        if ext == ".png":
            # prefer the native zlib decoder when built
            try:
                from .. import native
                if native.get_lib() is not None:
                    return native.load_image(path)
            except Exception:
                pass
        try:
            from PIL import Image
            img = np.asarray(Image.open(path))
            if img.dtype in (np.uint16, np.int32, np.uint32):
                # cv::IMREAD_GRAYSCALE contract (matches the native
                # decoders): 16-bit sources rescale to 0..255 so fixed
                # intensity thresholds (FAST) are independent of the
                # dataset's PNG bit depth
                img = img.astype(np.float32) / 257.0
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                f"no decoder available for {path}; install pillow or use "
                "npy/pgm") from e
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        # BT.601 luma — keep the PIL fallback bit-compatible with the
        # native decoder (cv::IMREAD_GRAYSCALE convention)
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2])
    return img


def _load_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"P5", b"P2"):
            raise ValueError(f"unsupported PNM magic {magic!r}")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxv = int(f.readline())
        if magic == b"P5":
            dt = np.uint8 if maxv < 256 else ">u2"
            out = np.frombuffer(f.read(), dt).reshape(h, w).astype(
                np.float32)
            # 16-bit rescales to 0..255 (cv::IMREAD_GRAYSCALE contract,
            # same as the native decoder)
            return out / 257.0 if maxv >= 256 else out
        data = np.fromstring(f.read(), sep=" ")  # pragma: no cover
        return data.reshape(h, w).astype(np.float32)


def _read_csv(path: str) -> List[List[str]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([c.strip() for c in line.split(",")])
    return rows


def load_asl(image_dir: str, imu_dir: str) -> List[Msg]:
    """ASL format: <dir>/data.csv + <image_dir>/data/<filename>.

    Timestamps are nanoseconds in the csv; converted to float seconds.
    """
    entries: List[Msg] = []
    for row in _read_csv(os.path.join(image_dir, "data.csv")):
        ts = int(row[0]) * 1e-9
        entries.append(ImageMsg(ts=ts, path=os.path.join(
            image_dir, "data", row[1])))
    for row in _read_csv(os.path.join(imu_dir, "data.csv")):
        ts = int(row[0]) * 1e-9
        gyro = np.asarray([float(x) for x in row[1:4]])
        accel = np.asarray([float(x) for x in row[4:7]])
        entries.append(IMUMsg(ts=ts, gyro=gyro, accel=accel))
    entries.sort(key=lambda m: m.ts)
    return entries


def dataset_dirs(root: str, dataset: str, seq: str,
                 cam_id: int = 0) -> tuple:
    """Directory conventions per dataset family (src/loader.cpp:14-150)."""
    d = dataset.lower()
    if d in ("tumvi",):
        base = os.path.join(root, f"dataset-{seq}_512_16", "mav0")
        return (os.path.join(base, f"cam{cam_id}"),
                os.path.join(base, "imu0"))
    if d in ("euroc",):
        base = os.path.join(root, seq, "mav0")
        return (os.path.join(base, f"cam{cam_id}"),
                os.path.join(base, "imu0"))
    # xivo/void-style: root/seq/{cam0,imu0}
    base = os.path.join(root, seq)
    return (os.path.join(base, f"cam{cam_id}"),
            os.path.join(base, "imu0"))


def load_dataset(root: str, dataset: str, seq: str,
                 cam_id: int = 0) -> List[Msg]:
    image_dir, imu_dir = dataset_dirs(root, dataset, seq, cam_id)
    return load_asl(image_dir, imu_dir)


def load_mocap_tumvi(root: str, seq: str) -> np.ndarray:
    """TUM-VI mocap ground truth: (N, 8) [ts, tx ty tz, qx qy qz qw]."""
    base = os.path.join(root, f"dataset-{seq}_512_16", "mav0",
                        "mocap0", "data.csv")
    rows = _read_csv(base)
    out = []
    for r in rows:
        out.append([int(r[0]) * 1e-9] + [float(x) for x in r[1:8]])
    return np.asarray(out)
