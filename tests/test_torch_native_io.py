"""The port's native IO library (``xivo_tpu_torch/native``: its own copy of
``xivo_io.cpp``, built with g++ into ``xivo_tpu_torch/_build/``) on the
eight cases of ``tests/test_native_io.py``, with the same checks; the
PGM decode also equal to the JAX package's Python decoder. The
reference's own library is not loaded: it builds into the JAX package's
directory, where ``tests/test_native_io.py`` may be building it in
another worker at the same time."""
import os

import numpy as np
import pytest

from xivo_tpu.io.loader import _load_pnm as jax_load_pnm
from xivo_tpu_torch import native

from test_native_io import write_pgm


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no compiler available")
    return lib


def test_built_from_the_ports_own_source(lib):
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libxivo_io_")
    assert native.BUILD_DIR.endswith(os.path.join("xivo_tpu_torch",
                                                  "_build"))
    assert os.path.exists(native._SRC)


def test_parse_imu_csv(lib, tmp_path):
    p = tmp_path / "data.csv"
    rows = ["#ts,gx,gy,gz,ax,ay,az"]
    vals = np.random.default_rng(0).standard_normal((50, 6))
    for i in range(50):
        ns = 1000000000 + i * 5000000
        rows.append(",".join([str(ns)] + [f"{v:.9f}" for v in vals[i]]))
    p.write_text("\n".join(rows) + "\n")
    out = native.parse_imu_csv(str(p))
    assert out.shape == (50, 7)
    assert np.allclose(out[:, 0], 1.0 + np.arange(50) * 0.005)
    assert np.allclose(out[:, 1:], vals, atol=1e-9)


def test_load_pgm(lib, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (48, 64)).astype(np.uint8)
    p = str(tmp_path / "img.pgm")
    write_pgm(p, img)
    out = native.load_pgm(p)
    assert np.array_equal(out, img.astype(np.float32))
    img16 = rng.integers(0, 65535, (32, 40)).astype(np.uint16)
    p2 = str(tmp_path / "img16.pgm")
    write_pgm(p2, img16, maxv=65535)
    out16 = native.load_pgm(p2)
    assert np.allclose(out16, img16.astype(np.float32) / 257.0, atol=1e-3)
    assert out16.max() <= 255.0
    np.testing.assert_allclose(out16, jax_load_pnm(p2), rtol=0, atol=1e-4)


def test_prefetcher_streams_in_order(lib, tmp_path):
    rng = np.random.default_rng(2)
    imgs, paths = [], []
    for i in range(20):
        img = rng.integers(0, 255, (24, 32)).astype(np.uint8)
        p = str(tmp_path / f"f{i}.pgm")
        write_pgm(p, img)
        imgs.append(img)
        paths.append(p)
    pf = native.ImagePrefetcher(paths, capacity=4)
    got = list(pf)
    pf.close()
    assert len(got) == 20
    for a, b in zip(got, imgs):
        assert np.array_equal(a, b.astype(np.float32))


def test_native_matches_python_loader(lib, tmp_path):
    from xivo_tpu_torch.io.loader import _load_pnm
    img = np.random.default_rng(3).integers(0, 255, (16, 20)).astype(
        np.uint8)
    p = str(tmp_path / "x.pgm")
    write_pgm(p, img)
    assert np.array_equal(native.load_pgm(p), _load_pnm(p))
    assert np.array_equal(native.load_pgm(p), jax_load_pnm(p))


def _png(tmp_path, name, img, mode):
    from PIL import Image
    p = str(tmp_path / name)
    Image.fromarray(img, mode=mode).save(p)
    return p


def test_load_png_gray8(lib, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 53), np.uint8)
    p = _png(tmp_path, "g8.png", img, "L")
    out = native.load_image(p)
    assert out.shape == (37, 53)
    assert np.array_equal(out, img.astype(np.float32))


def test_load_png_gray16(lib, tmp_path, monkeypatch):
    img = np.random.default_rng(1).integers(0, 65536, (16, 24), np.uint16)
    p = _png(tmp_path, "g16.png", img, "I;16")
    out = native.load_image(p)
    assert np.allclose(out, img.astype(np.float32) / 257.0, atol=1e-3)
    assert out.max() <= 255.0
    from xivo_tpu_torch.io.loader import load_image as py_load
    monkeypatch.setattr(native, "get_lib", lambda: None)  # the PIL path
    assert np.allclose(py_load(p), out, atol=1e-3)


def test_load_png_rgb_luma(lib, tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (20, 30, 3), np.uint8)
    p = _png(tmp_path, "rgb.png", img, "RGB")
    out = native.load_image(p)
    luma = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).astype(np.float32)
    assert np.allclose(out, luma, atol=0.51)


def test_loader_prefers_native_png(lib, tmp_path, monkeypatch):
    from xivo_tpu_torch.io.loader import load_image
    img = ((np.arange(64).reshape(8, 8) * 3) % 256).astype(np.uint8)
    p = _png(tmp_path, "x.png", img, "L")
    calls = []
    decode = native.load_image
    monkeypatch.setattr(native, "load_image",
                        lambda path: calls.append(path) or decode(path))
    out = load_image(p)
    assert calls == [p]
    assert np.array_equal(out, img.astype(np.float32))
