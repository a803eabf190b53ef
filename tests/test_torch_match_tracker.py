"""The MATCH tracker and the other detector/descriptor choices through the
port's frame steps, against the JAX package on the CPU.

* ``vio_frame_image`` with the MATCH tracker, the ORB detector and
  descriptor and homography outlier rejection: 6 frames of two sequences
  of the image tests' stream (``run_both``: IMG_CFG's 320 x 240 camera,
  tiny Dims, float64 filter, the reference's homography draws rebuilt
  from its key each frame). In frames 3 and 4 the image's left strip is
  moved 8 px down, so that the tracks matched there leave the homography
  of the rest and are rejected. Ids, track states, descriptor words and
  counts exactly; tracks and poses within the image tests' tolerances.
* ``tracker_only_frame`` walks, 6 frames of two sequences from one
  initial state, compared frame by frame (ids, track states and words
  exactly, positions within 5e-6 px): the MATCH tracker with
  ``"differential": false`` and the BRISK detector and descriptor; and
  the LK tracker with GFTT, FREAK and the dropped-track rescue, the image
  turned 25 degrees about its center in frame 3: LK loses some tracks
  in the turn, and the rescue revives a few of them by their
  rotation-invariant words (more ids are carried into frame 3 than
  without it). That walk stops at the turn (4 frames), where the tracks
  that run all of LK's iterations part by up to 6.0e-6 px, and holds
  positions within 2^-15 px (one float32 ulp at 256-512 px).
* The reference's ``test_match_mode_tracks_through_large_motion`` on the
  port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from xivo_tpu.frontend.tracker import \
    tracker_only_frame as jax_tracker_only_frame
from xivo_tpu.frontend import init_frontend as jax_init_frontend
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.state import TS_DROPPED, TS_TRACKED
from xivo_tpu_torch.frontend.tracker import tracker_only_frame
from xivo_tpu_torch.geom import so3
from xivo_tpu_torch.runner import batch_frontend_states, batch_states
from xivo_tpu_torch.sim.configs import IMG_CFG, make_world
from xivo_tpu_torch.sim.render import render_dots

from test_torch_image_pipeline import (POS_TOL, check_outputs, check_tables,
                                       exact_crops, image_cfgs, port_stream,
                                       run_both)

torch.set_num_threads(2)
FRAMES = 6


def displaced(image):
    """(B, T, H, W) images with columns 0-79 moved 8 px down in frames 3
    and 4."""
    image = image.copy()
    image[:, 3:5, 8:, :80] = image[:, 3:5, :-8, :80]
    return image


def test_match_tracker_matches_reference():
    jc, tc = image_cfgs(tracker_type="MATCH", detector="ORB",
                        descriptor="orb", do_outlier_rejection=True)
    (js, jf, jo), (ts, tf, to) = run_both(jc, tc, frames=FRAMES,
                                          edit=displaced)
    check_outputs(jo, to, frames=FRAMES)
    check_tables(js, ts, jf, tf)
    rej = np.asarray(jo.num_tracker_outlier_rejected)
    assert rej[:, 3].min() > 0, rej
    assert int(jo.num_tracked[:, 1:].min()) > 0
    assert int(jo.num_instate_features[:, -1].min()) > 0


def turned(image):
    """(B, T, H, W) images turned 25 degrees about their center from frame
    3 on."""
    from scipy.ndimage import rotate
    image = image.copy()
    image[:, 3:] = rotate(image[:, 3:], 25.0, axes=(-1, -2), reshape=False,
                          order=1, mode="nearest")
    return image


def walk_tracker_only(jc, tc, edit=None, seeds=(1, 2), pos_tol=POS_TOL,
                      frames=FRAMES):
    """`frames` frames of ``tracker_only_frame`` in both packages from one
    initial state; every frame's track tables compared (positions within
    `pos_tol` px). Returns the port's per-frame (fid, track) (B, T, NF)."""
    streams = [port_stream(tc, frames, sd)[0].image for sd in seeds]
    images = np.stack(streams)
    if edit is not None:
        images = edit(images)
    B = len(seeds)
    js = jax_batch_states(jc, B)
    jf = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(),
                      jax_init_frontend(jc))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tf = interop.frontend_from_numpy(jax.tree.map(np.asarray, jf), "cpu")
    step = jax.jit(jax.vmap(lambda s, f, im: jax_tracker_only_frame(
        jc, s, f, im)))
    fids, tracks = [], []
    for t in range(frames):
        with exact_crops():
            js, jf = step(js, jf, jnp.asarray(images[:, t]))
        ts, tf = tracker_only_frame(tc, ts, tf, torch.from_numpy(
            images[:, t]))
        jfr, tfr = js.features, ts.features
        for name in ("fid", "track", "status", "desc", "lifetime"):
            np.testing.assert_array_equal(
                getattr(tfr, name).numpy(),
                np.asarray(getattr(jfr, name)).astype(np.int64),
                err_msg=f"frame {t} {name}")
        np.testing.assert_allclose(tfr.xp.numpy(), np.asarray(jfr.xp),
                                   rtol=0, atol=pos_tol)
        assert int(ts.next_fid.min()) == int(np.asarray(js.next_fid).min())
        fids.append(tfr.fid.numpy())
        tracks.append(tfr.track.numpy())
    return np.stack(fids, 1), np.stack(tracks, 1)


def test_tracker_only_match_without_differential_matches_reference():
    jc, tc = image_cfgs(tracker_type="MATCH", detector="BRISK",
                        descriptor="brisk", differential=False)
    assert not tc.differential_match
    fid, track = walk_tracker_only(jc, tc)
    # tracks held from frame to frame under their ids
    kept = (fid[:, 1:] == fid[:, :-1]) & (track[:, 1:] == TS_TRACKED)
    assert kept.sum(axis=-1)[:, 1:].min() > 5


def carried_ids(fid, track, t):
    """Per sequence, the ids tracked in frame t that frame t - 1 held."""
    return [int(np.isin(np.where(tr == TS_TRACKED, a, -2), b[b >= 0]).sum())
            for a, b, tr in zip(fid[:, t], fid[:, t - 1], track[:, t])]


def test_tracker_only_lk_gftt_freak_rescue_matches_reference():
    jc, tc = image_cfgs(detector="GFTT", descriptor="freak",
                        match_dropped_tracks=True)
    # LK's float32 sums, taken in another order, part by up to 6.0e-6 px
    # on the tracks that run all 30 iterations in the turn (measured; 1.3e-4
    # px a frame later, so the walk stops at the turn): held within one
    # float32 ulp at 256-512 px
    fid, track = walk_tracker_only(jc, tc, edit=turned, pos_tol=2.0 ** -15,
                                   frames=4)
    # the rescue revives tracks that LK lost in the turn: without it, fewer
    # ids are carried into frame 3
    _, off = image_cfgs(detector="GFTT", descriptor="freak")
    images = turned(np.stack([port_stream(off, 4, sd)[0].image
                              for sd in (1, 2)]))
    s, f = batch_states(off, 2, device="cpu"), \
        batch_frontend_states(off, 2, device="cpu")
    hist = []
    for t in range(4):
        s, f = tracker_only_frame(off, s, f, torch.from_numpy(images[:, t]))
        hist.append((s.features.fid.numpy(), s.features.track.numpy()))
    fid0, track0 = (np.stack(x, 1) for x in zip(*hist))
    with_rescue = carried_ids(fid, track, 3)
    without = carried_ids(fid0, track0, 3)
    assert all(a > b > 0 for a, b in zip(with_rescue, without)), \
        (with_rescue, without)


def test_match_mode_tracks_through_large_motion():
    """Mutual-best descriptor matching keeps track identity across a jump
    far beyond the LK pyramid's range, and unmatched detections spawn new
    tracks only up to num_features_max (``tests/test_tracker_extras.py::
    test_match_mode_tracks_through_large_motion`` on the port)."""
    cfg = config_from_json(IMG_CFG, dtype="float64", tracker_type="MATCH")
    s = batch_states(cfg, 1, device="cpu")
    fes = batch_frontend_states(cfg, 1, device="cpu")
    Xs = make_world(300, seed=7)
    K = np.array([[200.0, 0, 160], [0, 200, 120], [0, 0, 1]])
    Rbc = so3.exp(torch.tensor(cfg.X_Wbc, dtype=torch.float64)).numpy()
    Tbc = np.asarray(cfg.X_Tbc)
    img0 = render_dots(Xs, Rbc, np.zeros(3), K, 320, 240)
    s, fes = tracker_only_frame(cfg, s, fes, torch.from_numpy(img0)[None])
    fid0 = s.features.fid[0].numpy().copy()
    n0 = int((fid0 >= 0).sum())
    assert 10 < n0 <= cfg.num_features_max

    img1 = render_dots(Xs, Rbc, Tbc + np.array([2.5, 0.0, 0.0]), K, 320,
                       240)
    s, fes = tracker_only_frame(cfg, s, fes, torch.from_numpy(img1)[None])
    fid = s.features.fid[0].numpy()
    track = s.features.track[0].numpy()
    persisted = (fid >= 0) & np.isin(fid, fid0[fid0 >= 0]) \
        & (track == TS_TRACKED)
    assert persisted.sum() >= 10, persisted.sum()
    live = s.features.active[0].numpy() & (track != TS_DROPPED)
    assert int(live.sum()) <= cfg.num_features_max
