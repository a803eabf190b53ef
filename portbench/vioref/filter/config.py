"""Filter configuration (a copy of ``xivo_tpu/filter/config.py``, cut to
what the benchmark's configurations run).

Parses the reference's JSON config surface (``cfg/pcw.json``; parsed by
the Estimator ctor, ``src/estimator.cpp:100-417``) into a frozen
dataclass, field for field as the program parses it, for the fields the
frozen filter reads. An option that turns on a path this copy does not
carry (OOS, 1-point RANSAC, Huber, observability constraints, first
estimates, triangulation, depth refinement, correlated initialization,
online calibration, the mapper, homography outlier rejection, a camera
other than the pinhole, a propagation other than the fast mode, the dense
covariance) is refused here, never ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .layout import Dims

# options of the program whose paths this copy does not carry: each must
# be absent or off, at the top level of the JSON or as an override
NOT_CARRIED = ("use_1pt_RANSAC", "use_huber", "use_oc", "use_oc_meas",
               "use_fej", "oos_fej", "fej_feature_block",
               "triangulate_pre_subfilter", "use_depth_opt",
               "approximate_init_covariance", "use_OOS",
               "clone_frame_groups", "online_temporal_calib",
               "online_imu_calib", "online_camera_calib", "use_mapper")


@dataclasses.dataclass(frozen=True)
class SubfilterOptions:
    Rtri: float = 3.5 ** 2
    MH_thresh: float = 5.991
    ready_steps: int = 5


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    dims: Dims = Dims()
    dtype: str = "float32"

    # fast propagation (src/estimator.cpp:579-588): a static grid of
    # fast_substeps uniform substeps of at most `stepsize` an interval
    stepsize: float = 0.002
    propagation_mode: str = "fast"
    covariance_form: str = "sqrt"
    fast_substeps: int = 4

    # measurement gating (src/update.cpp)
    use_MH_gating: bool = True
    min_inliers: int = 5
    MH_thresh: float = 5.991
    MH_adjust_factor: float = 1.1
    mh_relax_rounds: int = 20        # static bound on threshold-relaxation loop
    # rebuild the Jacobians after ownership transfers within the frame
    recompute_stale_jacobians: bool = True

    subfilter: SubfilterOptions = SubfilterOptions()
    remove_outlier_counter: float = 10.0
    max_group_admissions: int = 4
    max_depth_var_for_admission: float = float("inf")
    comparison_score_type: str = "DepthUncertainty"
    strict_criteria_timesteps: int = 5
    num_gauge_xy_features: int = 3
    group_degrees_fixed: int = 4
    max_group_lifetime: int = 1
    feature_owner_change_cov_factor: float = 1.5

    init_z: float = 2.5
    init_std_x: float = 1.0          # pixels (divided by focal length at build)
    init_std_y: float = 1.0
    init_std_z: float = 0.5
    min_z: float = 0.05
    max_z: float = 5.0
    adaptive_depth_beta: float = 0.99
    adaptive_depth_min_lifetime: int = 5
    visual_meas_std: float = 1.0

    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.8)
    imu_tk_convention: bool = False
    sim_initialize_depths: bool = False

    # initial nominal state
    X_Wsb: Tuple = (0.0, 0.0, 0.0)
    X_Tsb: Tuple = (0.0, 0.0, 0.0)
    X_Vsb: Tuple = (0.0, 0.0, 0.0)
    X_bg: Tuple = (0.0, 0.0, 0.0)
    X_ba: Tuple = (0.0, 0.0, 0.0)
    X_Wbc: Tuple = (0.0, 0.0, 0.0)
    X_Tbc: Tuple = (0.0, 0.0, 0.0)
    X_Wsg: Tuple = (0.0, 0.0)
    X_td: float = 0.0
    Cg: Tuple = tuple(np.eye(3).ravel())
    Ca: Tuple = tuple(np.eye(3).ravel())

    # initial standard deviations
    P_Wsb: float = 0.0001
    P_Tsb: float = 0.0001
    P_Vsb: float = 1.0
    P_bg: float = 1e-4
    P_ba: float = 1e-3
    P_Wbc: float = 0.0001
    P_Tbc: Tuple = (0.0001,) * 3
    P_Wsg: float = 0.01

    # process noise
    Qmodel_Wsb: float = 0.0
    Qmodel_Wbc: float = 0.0
    Qmodel_Wsg: float = 0.0
    Qmodel_Tbc: float = 0.0
    Qimu_gyro: Tuple = (1e-3,) * 3
    Qimu_accel: Tuple = (1e-2,) * 3
    Qimu_gyro_bias: Tuple = (1e-4,) * 3
    Qimu_accel_bias: Tuple = (1e-5,) * 3

    cam_model: str = "pinhole"
    cam_params: Tuple = (480, 640, 275.0, 275.0, 320.0, 240.0)  # rows, cols, fx, fy, cx, cy

    # the point-cloud tracker (src/tracker.cpp:632-702)
    max_pixel_displacement: float = 64.0
    num_features_max: int = 200

    def __post_init__(self):
        if self.comparison_score_type not in (
                "DepthUncertainty", "CovarianceDiagNorm",
                "CovarianceDiagNormPlusOutlierCount"):
            raise ValueError(
                f"invalid comparison_score_type "
                f"{self.comparison_score_type!r}")
        if (self.propagation_mode, self.covariance_form) != ("fast", "sqrt"):
            raise ValueError(
                "the frozen filter carries the fast propagation and the "
                "square-root form alone; got propagation_mode="
                f"{self.propagation_mode!r}, covariance_form="
                f"{self.covariance_form!r}")
        if self.cam_model != "pinhole":
            raise ValueError(f"the frozen filter carries the pinhole camera "
                             f"alone; got {self.cam_model!r}")

    @property
    def R(self):
        return self.visual_meas_std ** 2


def _vec(j, key, default=None):
    v = j.get(key, default)
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _rotvec(j, key):
    """Rotation config entry: a tangent 3-vector (a 3x3 matrix, which the
    program also takes, is refused here)."""
    a = np.asarray(j.get(key, (0.0, 0.0, 0.0)), dtype=np.float64)
    if a.shape == (3, 3):
        raise ValueError(f"{key} as a matrix is not carried")
    return tuple(a.reshape(-1)[:3])


def config_from_json(cfg: dict, dims: Optional[Dims] = None,
                     **overrides) -> VIOConfig:
    """Build a VIOConfig from a reference-format JSON dict, as the program
    does (``src/estimator.cpp:100-417``), refusing ``NOT_CARRIED``."""
    on = [k for k in NOT_CARRIED if {**cfg, **overrides}.get(k)]
    tracker = cfg.get("tracker_cfg", {})
    if tracker.get("do_outlier_rejection"):
        on.append("tracker_cfg.do_outlier_rejection")
    if cfg.get("mapper_cfg", {}).get("detectLoopClosures"):
        on.append("mapper_cfg.detectLoopClosures")
    if tracker.get("tracker_type", "POINTCLOUD") != "POINTCLOUD":
        on.append("tracker_cfg.tracker_type")
    if on:
        raise ValueError(f"options not carried by the frozen filter: {on}")

    X = cfg.get("X", {})
    P = cfg.get("P", {})
    Qm = cfg.get("Qmodel", {})
    Qi = cfg.get("Qimu", {})
    sub = cfg.get("subfilter", {})
    adi = cfg.get("adaptive_initial_depth", {})
    cam = cfg.get("camera_cfg", {})
    imu_calib = cfg.get("imu_calib", {})

    def q3(key, default):
        v = Qi.get(key, default)
        if not isinstance(v, (list, tuple)):
            v = [v] * 3
        return tuple(v)

    Ca = np.asarray(imu_calib.get("Car", np.eye(3).tolist()), dtype=np.float64)
    Ca = Ca @ np.diag(imu_calib.get("Cas", [1.0, 1.0, 1.0]))
    Cg = np.asarray(imu_calib.get("Cgr", np.eye(3).tolist()), dtype=np.float64)
    Cg = Cg @ np.diag(imu_calib.get("Cgs", [1.0, 1.0, 1.0]))

    Tbc_std = P.get("Tbc", 0.0001)
    if not isinstance(Tbc_std, (list, tuple)):
        Tbc_std = (Tbc_std,) * 3

    kw = dict(
        dims=dims or Dims(),
        stepsize=cfg.get("PrinceDormand", {}).get(
            "stepsize", cfg.get("RK4", {}).get("stepsize", 0.002)),
        use_MH_gating=cfg.get("use_MH_gating", True),
        min_inliers=cfg.get("min_inliers", 5),
        MH_thresh=cfg.get("MH_thresh", 5.991),
        MH_adjust_factor=cfg.get("MH_adjust_factor", 1.1),
        subfilter=SubfilterOptions(
            Rtri=sub.get("visual_meas_std", 3.5) ** 2,
            MH_thresh=sub.get("MH_thresh", 5.991),
            ready_steps=sub.get("ready_steps", 5)),
        remove_outlier_counter=cfg.get("remove_outlier_counter", 10),
        strict_criteria_timesteps=cfg.get("strict_criteria_timesteps", 5),
        num_gauge_xy_features=cfg.get("num_gauge_xy_features", 3),
        group_degrees_fixed=cfg.get("group_degrees_fixed", 4),
        max_group_lifetime=cfg.get("max_group_lifetime", 1),
        feature_owner_change_cov_factor=cfg.get(
            "filter_owner_change_cov_factor", 1.5),
        init_z=cfg.get("initial_z", 2.5),
        init_std_x=cfg.get("initial_std_x", 1.0),
        init_std_y=cfg.get("initial_std_y", 1.0),
        init_std_z=cfg.get("initial_std_z", 0.5),
        min_z=cfg.get("min_depth", 0.05),
        max_z=cfg.get("max_depth", 5.0),
        adaptive_depth_beta=adi.get("median_weight", 0.99),
        adaptive_depth_min_lifetime=adi.get("minimum_feature_lifetime", 5),
        visual_meas_std=cfg.get("visual_meas_std", 1.0),
        gravity=_vec(cfg, "gravity", (0.0, 0.0, -9.8)),
        imu_tk_convention=cfg.get("imu_tk_convention", False),
        X_Wsb=_rotvec(X, "Wsb"), X_Tsb=_vec(X, "Tsb", (0.0,) * 3),
        X_Vsb=_vec(X, "Vsb", (0.0,) * 3), X_bg=_vec(X, "bg", (0.0,) * 3),
        X_ba=_vec(X, "ba", (0.0,) * 3), X_Wbc=_rotvec(X, "Wbc"),
        X_Tbc=_vec(X, "Tbc", (0.0,) * 3),
        X_Wsg=tuple(X.get("Wsg", (0.0, 0.0))[:2]),
        X_td=X.get("td", 0.0),
        Cg=tuple(Cg.ravel()), Ca=tuple(Ca.ravel()),
        P_Wsb=P.get("Wsb", 0.0001), P_Tsb=P.get("Tsb", 0.0001),
        P_Vsb=P.get("Vsb", 1.0), P_bg=P.get("bg", 1e-4),
        P_ba=P.get("ba", 1e-3), P_Wbc=P.get("Wbc", 0.0001),
        P_Tbc=tuple(Tbc_std), P_Wsg=P.get("Wsg", 0.01),
        Qmodel_Wsb=Qm.get("Wsb", 0.0), Qmodel_Wbc=Qm.get("Wbc", 0.0),
        Qmodel_Wsg=Qm.get("Wsg", 0.0), Qmodel_Tbc=Qm.get("Tbc", 0.0),
        Qimu_gyro=q3("gyro", 1e-3), Qimu_accel=q3("accel", 1e-2),
        Qimu_gyro_bias=q3("gyro_bias", 1e-4),
        Qimu_accel_bias=q3("accel_bias", 1e-5),
        cam_model=cam.get("model", "pinhole").lower(),
        cam_params=(cam.get("rows", 480), cam.get("cols", 640),
                    cam.get("fx", 275.0), cam.get("fy", 275.0),
                    cam.get("cx", 320.0), cam.get("cy", 240.0)),
        max_pixel_displacement=tracker.get("max_pixel_displacement", 64.0),
        num_features_max=tracker.get("num_features_max", 200),
    )
    # generic passthrough: any flat top-level key naming a VIOConfig field
    # (extension knobs such as max_depth_var_for_admission)
    valid = set(VIOConfig.__dataclass_fields__)
    for k, v in cfg.items():
        if k in valid and k not in kw:
            kw[k] = tuple(v) if isinstance(v, list) else v
    kw.update({k: v for k, v in overrides.items() if k not in NOT_CARRIED})
    cfg_out = VIOConfig(**kw)
    # size the static fast-propagation substep grid so the configured
    # stepsize is honored at the dataset's IMU rate
    if "fast_substeps" not in {**cfg, **overrides} and cfg_out.stepsize > 0:
        imu_rate = cfg.get("imu_rate", 200.0)  # Hz; reference datasets >=100
        need = int(np.ceil(1.0 / (imu_rate * cfg_out.stepsize)))
        if need > cfg_out.fast_substeps:
            cfg_out = dataclasses.replace(cfg_out, fast_substeps=need)
    return cfg_out
