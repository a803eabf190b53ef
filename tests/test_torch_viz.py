"""The port's viewers and geometry helpers against the JAX package's, on
the CPU: ``write_graphviz`` writes the reference's text for the same
estimator state, ``plot_tracks`` and ``plot_trajectory`` draw the
reference's images (the same PNG bytes), ``Estimator.Visualize`` draws
the track canvas and, with ``live=True``, refreshes one ``LiveViewer``
across calls, and ``geom/se3`` composes, inverts and applies poses as the
reference does (within 1e-15). The host side's modules import neither
JAX nor the JAX package, and neither matplotlib nor PIL until a figure
or a PNG needs them (the card's machine has neither).
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from xivo_tpu import viz as jax_viz
from xivo_tpu.geom import se3 as jax_se3
from xivo_tpu_torch import viz
from xivo_tpu_torch.filter.state import tree_map
from xivo_tpu_torch.geom import se3

from test_torch_io import est  # noqa: F401  (the module fixture)

torch.set_num_threads(2)


def reference_view(e):
    """The port estimator as the reference's viewers read it: the state
    without its batch axis, as numpy."""
    return SimpleNamespace(state=tree_map(lambda t: t[0].numpy(), e.state),
                           cfg=e.cfg, gsb=e.gsb,
                           num_instate_features=e.num_instate_features,
                           num_instate_groups=e.num_instate_groups)


def test_graphviz_matches_reference(tmp_path, est):
    got = viz.write_graphviz(est, str(tmp_path / "port.dot"))
    want = jax_viz.write_graphviz(reference_view(est),
                                  str(tmp_path / "ref.dot"))
    text = open(got).read()
    assert text == open(want).read()
    assert text.startswith("graph vio {") and "doublecircle" in text
    assert "[style=bold]" in text


def test_plots_match_reference(tmp_path, est):
    p = viz.plot_tracks(est, str(tmp_path / "tracks.png"))
    q = jax_viz.plot_tracks(reference_view(est), str(tmp_path / "ref.png"))
    assert open(p, "rb").read() == open(q, "rb").read()
    ts = np.arange(10) * 0.1
    T = np.random.default_rng(0).standard_normal((10, 3))
    p = viz.plot_trajectory(ts, T, T + 0.1, str(tmp_path / "traj.png"))
    q = jax_viz.plot_trajectory(ts, T, T + 0.1, str(tmp_path / "rtraj.png"))
    assert open(p, "rb").read() == open(q, "rb").read()


def test_visualize(tmp_path, est):
    p = est.Visualize(str(tmp_path / "canvas.png"))
    assert os.path.getsize(p) > 1000
    v = est.Visualize(str(tmp_path / "live0.png"), live=True)
    assert est.Visualize(str(tmp_path / "live1.png"), live=True) is v
    assert v.n_refreshed == 2 and len(v._trace) == 2
    np.testing.assert_array_equal(v._trace[-1], est.gsb()[1])
    assert len(v._landmarks) == est.num_instate_features()
    assert os.path.exists(tmp_path / "live1.png")
    v.close()
    est._live_viewer = None


def test_se3_matches_reference():
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(0)
    R = Rotation.from_rotvec(rng.standard_normal((2, 4, 3))).as_matrix()
    T = rng.standard_normal((2, 4, 3))
    X = rng.standard_normal((2, 4, 3))
    a, b = se3.SE3(torch.from_numpy(R[0]), torch.from_numpy(T[0])), \
        se3.SE3(torch.from_numpy(R[1]), torch.from_numpy(T[1]))
    ja, jb = jax_se3.SE3(jnp.asarray(R[0]), jnp.asarray(T[0])), \
        jax_se3.SE3(jnp.asarray(R[1]), jnp.asarray(T[1]))
    for got, want in (((a * b).R, (ja * jb).R), ((a * b).T, (ja * jb).T),
                      (a.inverse().R, ja.inverse().R),
                      (a.inverse().T, ja.inverse().T),
                      (a.act(torch.from_numpy(X[0])),
                       ja.act(jnp.asarray(X[0])))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-15)
    e = se3.identity(torch.float64)
    assert torch.equal(e.R, torch.eye(3, dtype=torch.float64))
    assert torch.equal(e.T, torch.zeros(3, dtype=torch.float64))


def test_host_side_imports_no_jax_nor_plotting():
    code = (
        "import sys\n"
        "import xivo_tpu_torch.api, xivo_tpu_torch.io, xivo_tpu_torch.eval\n"
        "import xivo_tpu_torch.eval.geometry, xivo_tpu_torch.native\n"
        "import xivo_tpu_torch.eval.estimator_data, xivo_tpu_torch.viz\n"
        "import xivo_tpu_torch.viz_live, xivo_tpu_torch.apps.vio\n"
        "import xivo_tpu_torch.sim.asl, xivo_tpu_torch.geom.se3\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'xivo_tpu', 'matplotlib', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
