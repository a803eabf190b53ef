"""The port's I/O (``io/loader.py``, ``io/savers.py``, ``sim/asl.py``) and
its replay app against the JAX package's, on the CPU.

* ``sim.asl.write_dots_dataset`` writes ``tests/test_io.py::
  build_synthetic_asl``'s dataset: the csv files byte for byte, the
  images equal;
* the loader gives the reference loader's messages, images (``.npy``,
  8- and 16-bit ``.pgm``, 8- and 16-bit and RGB ``.png``, through the
  Python decoders), dataset directories and mocap rows, exactly;
* each writer writes the reference writer's file byte for byte from the
  same estimator (the port's, after a short run), and
  ``load_tracker_dump`` reads it back to the same arrays; the state dump
  agrees exactly but for the rotation logs (each package's ``so3.log``,
  within 1e-15);
* ``python -m xivo_tpu_torch.apps.vio -device cpu`` replays the first
  frames of the dots dataset (IMG_CFG in the square-root form, read from
  a JSON file) into the trajectory that the estimator writes when driven
  in-process, byte for byte, and prints ``scripts/vio.py``'s summary.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from xivo_tpu.io import loader as jax_loader
from xivo_tpu.io import savers as jax_savers
from xivo_tpu_torch.api import Estimator
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.io import loader, savers
from xivo_tpu_torch.sim.asl import write_dots_dataset
from xivo_tpu_torch.sim.configs import IMG_CFG

from test_io import build_synthetic_asl
from test_native_io import write_pgm
from test_torch_api import SQRT, cfgs, feed, messages

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(the reference's dataset dir, the port's)."""
    ref = tmp_path_factory.mktemp("ref")
    build_synthetic_asl(str(ref))
    port = tmp_path_factory.mktemp("port")
    write_dots_dataset(str(port), config_from_json(IMG_CFG))
    return ref, port


@pytest.fixture(scope="module")
def est():
    """The port's estimator after 0.5 s of ``run_short``'s stream."""
    tc = cfgs(**SQRT)[1]
    e = Estimator(tc, device="cpu")
    feed(e, messages(tc, T=0.5))
    assert e.num_instate_features() > 0
    return e


def test_dots_dataset_matches_reference(datasets):
    ref, port = datasets
    for sub in ("cam0", "imu0"):
        assert (port / "seq" / sub / "data.csv").read_bytes() == \
            (ref / "seq" / sub / "data.csv").read_bytes()
    names = sorted(os.listdir(ref / "seq" / "cam0" / "data"))
    assert sorted(os.listdir(port / "seq" / "cam0" / "data")) == names
    assert len(names) == 20
    for n in names:
        np.testing.assert_array_equal(
            np.load(port / "seq" / "cam0" / "data" / n),
            np.load(ref / "seq" / "cam0" / "data" / n))


def test_load_asl_matches_reference(datasets):
    ref, _ = datasets
    dirs = [str(ref / "seq" / "cam0"), str(ref / "seq" / "imu0")]
    got, want = loader.load_asl(*dirs), jax_loader.load_asl(*dirs)
    assert len(got) == len(want) == 220
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__ and g.ts == w.ts
        if isinstance(g, loader.IMUMsg):
            np.testing.assert_array_equal(g.gyro, w.gyro)
            np.testing.assert_array_equal(g.accel, w.accel)
        else:
            assert g.path == w.path
            np.testing.assert_array_equal(g.image(), w.image())


def _image(path, kind, rng):
    if kind == "npy":
        np.save(path, rng.random((12, 17)).astype(np.float32) * 255)
    elif kind.startswith("pgm"):
        maxv = 255 if kind == "pgm8" else 65535
        write_pgm(path, rng.integers(0, maxv, (24, 31)), maxv)
    else:
        from PIL import Image
        img = {"png8": (rng.integers(0, 256, (37, 53), np.uint8), "L"),
               "png16": (rng.integers(0, 65536, (16, 24), np.uint16),
                         "I;16"),
               "png_rgb": (rng.integers(0, 256, (20, 30, 3), np.uint8),
                           "RGB")}[kind]
        Image.fromarray(*img).save(path)


@pytest.mark.parametrize("kind", ["npy", "pgm8", "pgm16", "png8", "png16",
                                  "png_rgb"])
def test_load_image_matches_reference(tmp_path, monkeypatch, kind):
    """The Python decoders, with neither package's native library (the
    port's native decoder is held in ``test_torch_native_io.py``; the
    reference's builds into the JAX package's directory, where
    ``tests/test_native_io.py`` may be building it at the same time)."""
    import xivo_tpu.native as jax_native
    import xivo_tpu_torch.native as port_native
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(port_native, "get_lib", lambda: None)
    ext = {"npy": ".npy", "pgm8": ".pgm", "pgm16": ".pgm"}.get(kind, ".png")
    path = str(tmp_path / f"img{ext}")
    _image(path, kind, np.random.default_rng(len(kind)))
    got = loader.load_image(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_loader.load_image(path))


def test_dataset_dirs_and_mocap(tmp_path):
    for ds in ("tumvi", "euroc", "xivo"):
        assert loader.dataset_dirs("/r", ds, "room1", 1) == \
            jax_loader.dataset_dirs("/r", ds, "room1", 1)
    d = tmp_path / "dataset-room1_512_16" / "mav0" / "mocap0"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = [",".join([str(10 ** 9 + 5 * 10 ** 7 * i)]
                     + [f"{x:.9f}" for x in rng.standard_normal(7)])
            for i in range(9)]
    (d / "data.csv").write_text("#ts,px,py,pz,qx,qy,qz,qw\n"
                                + "\n".join(rows) + "\n")
    got = loader.load_mocap_tumvi(str(tmp_path), "room1")
    assert got.shape == (9, 8)
    np.testing.assert_array_equal(
        got, jax_loader.load_mocap_tumvi(str(tmp_path), "room1"))


@pytest.mark.parametrize("writer", ["TrajectoryWriter", "CovDumpWriter",
                                    "TrackerDumpWriter"])
def test_writers_match_reference(tmp_path, est, writer):
    """The same estimator through both packages' writers: the same
    bytes (every value comes from the estimator's accessors)."""
    files = []
    for mod, tag in ((savers, "port"), (jax_savers, "ref")):
        path = str(tmp_path / tag / "out.txt")
        w = getattr(mod, writer)(path)
        for k in range(3):
            ts = 0.5 + 0.05 * k
            if writer == "TrajectoryWriter":
                w.add(ts, *est.gsb())
            else:
                w.add(ts, est)
        if writer != "TrackerDumpWriter":
            w.write()
        files.append(open(path, "rb").read())
    assert files[0] == files[1] and len(files[0]) > 100
    if writer == "TrackerDumpWriter":
        got = savers.load_tracker_dump(str(tmp_path / "port" / "out.txt"))
        want = jax_savers.load_tracker_dump(str(tmp_path / "ref" / "out.txt"))
        assert got.keys() == want.keys() and len(got["fid"]) > 0
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_state_dump_matches_reference(tmp_path, est):
    """The reference's writer reads the unbatched state's motion fields;
    it gets the port estimator's, as numpy."""
    from types import SimpleNamespace
    X = est.state.X
    shim = SimpleNamespace(
        state=SimpleNamespace(X=type(X)(*(t[0].numpy() for t in X))),
        num_instate_features=est.num_instate_features,
        num_instate_groups=est.num_instate_groups, Pstate=est.Pstate)
    out = []
    for mod, e, tag in ((savers, est, "port"), (jax_savers, shim, "ref")):
        path = str(tmp_path / f"{tag}.json")
        w = mod.StateDumpWriter(path, save_cov=True)
        w.add(0.5, e)
        w.write()
        out.append(json.load(open(path)))
    got, want = out
    for g, w in zip(got, want):
        for k in ("Wsb", "Wbc"):
            np.testing.assert_allclose(g.pop(k), w.pop(k), rtol=0,
                                       atol=1e-15)
        assert g == w


def test_replay_app_on_dots_dataset(datasets, tmp_path):
    _, port = datasets
    raw = dict(IMG_CFG, **SQRT)
    cfg_path = tmp_path / "img_cfg.json"
    cfg_path.write_text(json.dumps(raw))
    out = tmp_path / "traj.txt"
    r = subprocess.run(
        [sys.executable, "-m", "xivo_tpu_torch.apps.vio", "-cfg",
         str(cfg_path), "-root", str(port), "-dataset", "xivo", "-seq",
         "seq", "-out", str(out), "-device", "cpu", "-max_frames", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("frames=3 wall=")
    assert "misordered_dropped=0 td=+0.0000s -> " in r.stdout

    # the same replay through the estimator in-process
    e = Estimator(raw, device="cpu")
    assert e.cfg.covariance_form == "sqrt"
    w = savers.TrajectoryWriter(str(tmp_path / "inproc.txt"))
    n = 0
    for m in loader.load_dataset(str(port), "xivo", "seq"):
        if isinstance(m, loader.IMUMsg):
            e.InertialMeas(m.ts, m.gyro, m.accel)
        elif n < 3:
            e.VisualMeas(m.ts, m.image())
            w.add(m.ts, *e.gsb())
            n += 1
    w.write()
    assert out.read_bytes() == (tmp_path / "inproc.txt").read_bytes()
    vals = np.loadtxt(out)
    assert vals.shape == (3, 8) and np.isfinite(vals).all()
