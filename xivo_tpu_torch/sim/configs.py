"""Canonical benchmark/test world configurations.

Single source of truth for the PCW filter-mode config and the
image-mode (TUM-VI-shaped) config, imported by BOTH the test suite and
bench.py so the bench never measures a world the tests don't cover
(round-4 verdict item 6: production metrics must not couple to test
modules).

Parity: the knob surface mirrors the reference's cfg/pcw.json /
cfg/tumvi_cam0.json (see filter/config.py for per-knob anchors).
"""
import numpy as np

PCW_CFG = {
    "simulation": True,
    "integration_method": "PrinceDormand",
    "PrinceDormand": {"stepsize": 0.002},
    "use_MH_gating": True,
    "max_group_lifetime": 60,
    "group_degrees_fixed": 6,
    "gravity": [0, 0, -9.8],
    "X": {"Wsb": [0, 0, 0], "Tsb": [0, 0, 0], "Vsb": [0, 0, 0],
          "bg": [0, 0, 0], "ba": [0, 0, 0],
          "Wbc": [-1.57079633, 0, 0], "Tbc": [0, 0, 0], "Wsg": [0, 0]},
    "P": {"Wsb": 0.001, "Tsb": 0.001, "Vsb": 0.5, "bg": 1e-10, "ba": 1e-10,
          "Wbc": 1e-10, "Tbc": 1e-10, "Wsg": 1e-10},
    "Qmodel": {"Wsb": 0.01, "Wbc": 0, "Wsg": 0},
    "Qimu": {"gyro": [5e-3] * 3, "gyro_bias": [0.0] * 3,
             "accel": [5e-2] * 3, "accel_bias": [0.0] * 3},
    "initial_z": 2.5, "initial_std_x": 1.0, "initial_std_y": 1.0,
    "initial_std_z": 0.5,
    "visual_meas_std": 1.0,
    "max_depth": 30.0, "min_depth": 0.05,
    "subfilter": {"visual_meas_std": 3.5, "ready_steps": 2,
                  "MH_thresh": 8.991},
    "min_inliers": 15, "MH_thresh": 100.0, "MH_adjust_factor": 1.15,
    "num_gauge_xy_features": 3,
    "camera_cfg": {"model": "pinhole", "rows": 480, "cols": 640,
                   "fx": 275, "fy": 275, "cx": 320, "cy": 240},
    "tracker_cfg": {"num_features_min": 150, "num_features_max": 200,
                    "max_pixel_displacement": 500},
}

# image-mode world (FAST + LK + EKF on rendered frames); the TUM-VI
# regime of BASELINE configs 1/3
IMG_CFG = dict(PCW_CFG)
IMG_CFG["tracker_cfg"] = {
    "tracker_type": "LK", "detector": "FAST",
    "num_features_min": 40, "num_features_max": 60,
    "max_pixel_displacement": 64, "mask_size": 15, "margin": 8,
    "use_prediction": False, "extract_descriptor": True,
    "KLT": {"win_size": 15, "max_level": 3, "max_iter": 30, "eps": 0.01},
    "FAST": {"threshold": 15.0},
}
IMG_CFG["camera_cfg"] = {"model": "pinhole", "rows": 240, "cols": 320,
                         "fx": 200, "fy": 200, "cx": 160, "cy": 120}
IMG_CFG["initial_z"] = 8.0
IMG_CFG["max_depth"] = 40.0
# parallax-gated admission (see VIOConfig.max_depth_var_for_admission):
# depths here bootstrap from a rough prior, so features wait until the
# subfilter has actually observed their depth
IMG_CFG["max_depth_var_for_admission"] = 0.01

# the image benchmark's world (scripts/bench_image.py::build_frames, the
# pinhole variant): IMG_CFG on a 512x512 camera with the TUM-VI KLT
# settings, run at IMG_BENCH_DIMS (a 128-row track table, D = 228)
IMG_BENCH_CFG = dict(IMG_CFG)
IMG_BENCH_CFG["camera_cfg"] = {"model": "pinhole", "rows": 512, "cols": 512,
                               "fx": 191.0, "fy": 191.0, "cx": 256.0,
                               "cy": 256.0}
IMG_BENCH_CFG["tracker_cfg"] = dict(
    IMG_CFG["tracker_cfg"],
    KLT={"win_size": 15, "max_level": 4, "max_iter": 15, "eps": 0.01})
IMG_BENCH_DIMS = {"nf_rows": 128, "ng_rows": 64}

# the room1-shaped 512x512 EQUIDISTANT camera (TUM-VI fisheye regime,
# cfg/tumvi_cam0.json) — the distortion-model-bearing variant of the
# bench image stage (round-4 verdict item 6)
EQUIDISTANT_512_CAM = {
    "model": "equidistant", "rows": 512, "cols": 512,
    "fx": 191.0, "fy": 191.0, "cx": 256.0, "cy": 256.0,
    "k0": 0.0034, "k1": 0.0008, "k2": -0.0007, "k3": 0.0001,
    "max_iter": 8,
}


def make_world(n=500, seed=0):
    """Random landmark cloud in front of the default image-mode camera."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-12, 12, n), rng.uniform(4, 25, n),
                     rng.uniform(-8, 8, n)], axis=1)


# the recommended accuracy config's switches (bench.py::stage_consistency):
# OOS (MSCKF-style) updates, pose cloning and pose-only first-estimate
# Jacobians (fej_feature_block stays False)
ACCURACY = {"use_OOS": True, "clone_frame_groups": True, "use_fej": True}


def accuracy_config(world=None, **over):
    """The recommended accuracy config as ``bench.py::stage_consistency``
    builds it: ``world`` (PCW_CFG by default) in float32 with simulated
    depth initialization, the square-root form and fast propagation, and
    the ACCURACY switches; ``over`` goes on top."""
    from ..filter.config import config_from_json
    kw = dict(dtype="float32", sim_initialize_depths=True,
              propagation_mode="fast", covariance_form="sqrt", **ACCURACY)
    kw.update(over)
    return config_from_json(PCW_CFG if world is None else world, **kw)


# the other filter options on the square-root path, together:
# tests/test_sqrt_form.py::test_e2e_sqrt_with_options's set (OOS, FEJ, the
# correlated init, 1-point RANSAC, Huber) plus OC-EKF on both sides, depth
# refinement and online camera calibration
OPTIONS = {"use_OOS": True, "use_fej": True,
           "approximate_init_covariance": True, "use_huber": True,
           "use_1pt_RANSAC": True, "use_oc": True, "use_oc_meas": True,
           "use_depth_opt": True, "online_camera_calib": True}
# PCW_CFG with initial intrinsics stds, so that online camera calibration
# has something to estimate (tests/test_calibration.py's)
PCW_CALIB_CFG = dict(PCW_CFG, P={**PCW_CFG["P"], "FC": [25.0, 10.0],
                                 "distortion": 1e-8})


def options_config(**over):
    """PCW_CALIB_CFG in float32 with simulated depth initialization, the
    square-root form, fast propagation and every OPTIONS switch on;
    ``over`` goes on top."""
    from ..filter.config import config_from_json
    kw = dict(dtype="float32", sim_initialize_depths=True,
              propagation_mode="fast", covariance_form="sqrt", **OPTIONS)
    kw.update(over)
    return config_from_json(PCW_CALIB_CFG, **kw)
