"""Filter configuration (a copy of ``xivo_tpu/filter/config.py``).

The PyTorch port keeps its own copy so that it never imports the JAX
package; ``tests/test_torch_pipeline.py`` holds the two field for field
equal. Parses the reference's JSON config surface (fully enumerated in
``cfg/tumvi_cam0.json`` / ``cfg/pcw.json``; parsed by the Estimator ctor,
``src/estimator.cpp:100-417``) into a frozen dataclass. Everything that
was a compile-time flag in the reference (USE_ONLINE_*_CALIB,
EKF_MAX_FEATURES/GROUPS, ...) is a runtime field here; array-shaping
fields live in ``Dims`` and specialize the jitted program.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional, Tuple

import numpy as np

from .layout import Dims


def load_json_with_comments(path: str) -> dict:
    """The reference's configs contain // comments (jsoncpp extension)."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return json.loads(text)


@dataclasses.dataclass(frozen=True)
class SubfilterOptions:
    Rtri: float = 3.5 ** 2
    MH_thresh: float = 5.991
    ready_steps: int = 5


@dataclasses.dataclass(frozen=True)
class TriangulateOptions:
    method: str = "l1_angular"
    zmin: float = 0.05
    zmax: float = 5.0
    max_theta_thresh: float = 0.1 * np.pi / 180
    beta_thresh: float = 0.25 * np.pi / 180


@dataclasses.dataclass(frozen=True)
class RefinementOptions:
    two_view: bool = False
    use_hessian: bool = False
    max_iters: int = 5
    eps: float = 1e-4
    damping: float = 1e-3
    max_res_norm: float = 2.0
    Rtri: float = 3.5 ** 2


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    dims: Dims = Dims()
    dtype: str = "float32"

    # integration (src/estimator.cpp:579-588, src/princedormand.cpp)
    integration_method: str = "PrinceDormand"
    stepsize: float = 0.002
    max_substeps: int = 10           # static bound on substeps per IMU sample
    # adaptive Prince-Dormand stepsize (src/princedormand.cpp:28-59; with
    # the REAL embedded error, which the reference leaves commented out)
    pd_control_stepsize: bool = False
    pd_tolerance: float = 1e-3
    pd_min_scale: float = 0.125
    pd_max_scale: float = 4.0
    # "reference": per-substep joint X/F/P integration (PD45/RK4 parity)
    # "fast": discrete transition composition, one P application per frame
    # "batched": all substeps at once + associative scans (TPU-fastest)
    propagation_mode: str = "reference"
    # covariance representation:
    #   "full" — dense P with Joseph-form updates (reference parity,
    #            src/estimator.cpp:1257-1288)
    #   "sqrt" — Cholesky-factor P = S S^T (filter/sqrt_form.py): PSD by
    #            construction in float32/bfloat16, one QR re-compression
    #            per frame, factor downdates instead of Joseph — the
    #            TPU-native design named by SURVEY.md §7.3. Requires
    #            propagation_mode="fast" (needs the per-frame discrete
    #            transition Phi/Qd).
    covariance_form: str = "full"
    total_substeps: int = 64         # static global substep budget/frame
    # fast mode: >0 = static fully-unrolled substep grid per interval
    # (n = clip(ceil(dt/h0), 1, fast_substeps) uniform steps, fusable
    # straight-line graph); 0 = data-dependent while-loop
    fast_substeps: int = 4

    # calibration enables (compile flags in the reference)
    online_temporal_calib: bool = False
    online_imu_calib: bool = False
    online_camera_calib: bool = False

    # outlier rejection (src/estimator.cpp:372-390)
    use_MH_gating: bool = True
    min_inliers: int = 5
    MH_thresh: float = 5.991
    MH_adjust_factor: float = 1.1
    mh_relax_rounds: int = 20        # static bound on threshold-relaxation loop
    use_1pt_RANSAC: bool = False
    # Huber-on-innovation R inflation (reference defines HuberOnInnovation,
    # src/estimator.cpp:1290-1306, but never calls it; gated option here)
    use_huber: bool = False
    outlier_thresh: float = 1.1
    # True (default): rebuild Jacobians on structure-change frames before
    # FilterUpdate. False = reference parity (UpdateStep reuses the
    # gating-time Jacobians after transfers/discards, src/manager.cpp) —
    # measured to degrade online camera-intrinsics convergence here
    # (cx 319.6 vs 321.2 toward a 322 truth on the calib_rich sim), so
    # the faithful-but-worse behavior is opt-in.
    recompute_stale_jacobians: bool = True
    # OC-EKF: observability-constrained propagation (use with
    # propagation_mode="fast"; measurement-side counterpart is use_fej).
    # Improvement over the reference (no consistency machinery there).
    use_oc: bool = False
    # measurement-side OC: project H rows onto the observable subspace
    # (H N = 0 at first estimates; filter/update.py::oc_project_rows).
    # Complements use_oc (transition-side) — with partially-applied FEJ
    # the raw rows leak linearization-drift-sized information into the
    # global translation/yaw directions.
    use_oc_meas: bool = False
    ransac_thresh: float = 5.0
    ransac_prob: float = 0.95
    ransac_Chi2: float = 5.89
    ransac_hyps: int = 32            # static hypothesis count (vmapped)

    # subfilter / triangulation / refinement
    subfilter: SubfilterOptions = SubfilterOptions()
    triangulation: TriangulateOptions = TriangulateOptions()
    refinement: RefinementOptions = RefinementOptions()
    triangulate_pre_subfilter: bool = False
    use_depth_opt: bool = False
    remove_outlier_counter: float = 10.0

    # admission (src/options.cpp, src/manager.cpp:332-566)
    # bound on new groups admitted per frame: the reference loops until
    # slots run out (only relevant in the first seconds); a small static
    # bound keeps the compiled admission loop short on TPU
    max_group_admissions: int = 4
    # correlated feature-initialization covariance (the reference's
    # APPROXIMATE_INIT_COVARIANCE compile flag): write cross-covariance
    # between a newly admitted feature and the extrinsics/group poses
    # its estimate was filtered through
    approximate_init_covariance: bool = False
    # chunk width of the correlated-init jacobian sweep: the congruence
    # only needs J rows for THIS frame's admission cohort (a handful in
    # steady state), yet the straight implementation sweeps all
    # n_features x n_groups observation jacobians every frame — measured
    # as the bulk of the approximate_init_covariance device cost
    # (ARCHITECTURE round-5). The cohort is compacted and processed in
    # while_loop chunks of this width (exact: chunks write only feature
    # rows of P/S, and the dense-form P_o re-read per chunk IS the
    # cross-chunk pairwise term). 0 = full-width single pass.
    init_corr_chunk: int = 8
    # first-estimates Jacobians (improvement over the reference):
    # cloned-pose blocks of the measurement Jacobian are evaluated at
    # the states' FIRST estimates (frozen at creation) so the
    # unobservable directions gain no spurious information — the
    # standard FEJ consistency fix for EKF-VIO. With the default
    # fej_feature_block=False this is POSE-ONLY FEJ, which the round-5
    # study measured as the dominant stack on both evaluation worlds
    # (with use_OOS: PCW bench ATE 0.0084 vs 0.0090 base; tube NEES
    # 4.8 / ATE 0.039 vs 10.5 / 0.057 for full FEJ + correlated init).
    # Runtime cost is ~zero (+0.04 s/rep, profile_fej). Defaults off
    # for reference parity; the recommended accuracy config turns it
    # on together with use_OOS + clone_frame_groups (see bench.py).
    use_fej: bool = False
    # with use_fej: also linearize the OOS (MSCKF) rows at the groups'
    # first pose estimates — the standard MSCKF-FEJ discipline for
    # designs whose global directions are otherwise unpinned. Here the
    # gauge fixing already pins them, and the tube-world study measures
    # OOS-FEJ as neutral-to-slightly-worse (NEES 4.8 vs 4.4 off, ATE
    # equal) while the doubled jacobian chain costs ~2 s/rep on device
    # — so it defaults off (same verdict as use_oc_meas, round-4)
    oos_fej: bool = False
    # with use_fej: evaluate the feature block at its first estimate
    # too. The feature state is parameterized RELATIVE to its ref group
    # (bearing + log-depth in the ref camera frame), so it is invariant
    # to the global unobservable directions — the structural HTr/HTg
    # cancellation in the chain holds at ANY x — and first-estimating
    # it buys no observability protection, only linearization error.
    # Measured (round-5): pose-only FEJ (False) + OOS dominates every
    # other stack on BOTH study worlds — tube NEES 4.8 / ATE 0.039 (vs
    # 10.5 / 0.057 full-FEJ) and PCW bench ATE 0.0084 (vs 0.0128 for
    # the full-FEJ + init-cov stack; base is 0.0090)
    fej_feature_block: bool = False
    # parallax-gated admission (improvement over the reference): only
    # admit features whose subfilter depth variance (log-depth) has
    # dropped below this bound — i.e. whose depth has become observable.
    # inf reproduces the reference's admit-after-ready_steps behavior.
    max_depth_var_for_admission: float = float("inf")
    # admission-ranking score (Criteria::CandidateComparison,
    # src/options.cpp:35-61): DepthUncertainty | CovarianceDiagNorm |
    # CovarianceDiagNormPlusOutlierCount
    comparison_score_type: str = "DepthUncertainty"
    strict_criteria_timesteps: int = 5
    num_gauge_xy_features: int = 3
    collinear_cross_prod_thresh: float = 1e-3
    group_degrees_fixed: int = 4

    # lifetime management
    max_group_lifetime: int = 1
    feature_owner_change_cov_factor: float = 1.5

    # depth init (src/estimator.cpp:345-361)
    init_z: float = 2.5
    init_std_x: float = 1.0          # pixels (divided by focal length at build)
    init_std_y: float = 1.0
    init_std_z: float = 0.5
    init_std_x_badtri: float = 1.0
    init_std_y_badtri: float = 1.0
    init_std_z_badtri: float = 0.5
    min_z: float = 0.05
    max_z: float = 5.0
    adaptive_depth_beta: float = 0.99
    adaptive_depth_min_lifetime: int = 5

    # measurement noise
    visual_meas_std: float = 1.0
    oos_meas_std: float = 3.5
    lc_meas_std: float = 4.0

    # OOS / MSCKF (gated off in the reference; first-class here)
    use_OOS: bool = False
    OOS_min_observations: int = 5
    # static per-frame budget of OOS features (the update needs a fixed
    # shape). Candidates are ranked by observation count (most-informed
    # first); overflow beyond the cap is NOT silent — StepOutputs
    # reports num_oos_dropped per frame. Size it so drops are rare for
    # your churn rate: candidates are features dying in ONE frame with
    # >= OOS_min_observations instate observations.
    oos_feature_cap: int = 8
    # MSCKF-style pose cloning: every frame's group joins the EKF
    # window (oldest featureless clone marginalized when full). Always
    # on with use_OOS — without clones no feature can accumulate
    # OOS_min_observations instate observations and the OOS update is a
    # permanent no-op. Available separately for sliding-window studies.
    clone_frame_groups: bool = False
    # QR measurement compression when a stacked update has more rows
    # than error-state columns (the reference's present-but-unused
    # use_compression, src/helpers.cpp:77-101)
    use_compression: bool = True
    # reference default 1.5 (src/estimator.cpp:116-117): compression
    # costs a (rows, D+1) Gram + Cholesky, so it only pays when the
    # stack is genuinely taller than the state — the CAP*2G = 240-row
    # OOS stack (~1.05x D) measured FASTER uncompressed on v5e
    # (7251 vs 7093 f/s, round-5)
    compression_trigger_ratio: float = 1.5

    # mapper / loop closure (USE_MAPPER + mapper_cfg in the reference)
    use_mapper: bool = False
    detect_loop_closures: bool = True
    map_capacity: int = 20000
    lc_nn_dist_thresh: int = 30
    lc_ransac_thresh: float = 0.03
    lc_min_matches: int = 5
    # chi-square gate on loop-closure innovation rows (2 dof) —
    # robustness beyond the reference (which applies matched rows
    # ungated); 0 disables for strict parity
    lc_MH_thresh: float = 13.8
    # merge-on-retirement landmark fusion (Feature::Merge parity,
    # src/feature.cpp:187-208 + src/mapper.cpp:158-222): a re-retired
    # landmark fuses into its map match instead of duplicating
    map_merge_on_retire: bool = True
    map_merge_radius: float = 0.5
    # keyframe-style map insertion (improvement over the reference's
    # retire-on-death-only mapper): every N frames the CURRENT instate
    # features are snapshotted into the map with their live descriptors.
    # On smooth trajectories tracks survive whole revisit loops, so the
    # death-only map is both sparse and worst-viewpoint (descriptors
    # captured at the moment tracking FAILS); periodic snapshots give
    # the map viewpoint coverage along the path. 0 = off.
    lc_keyframe_every: int = 0
    # loop-closure targets must be at least this many frames old:
    # a just-inserted entry restates information the filter still
    # carries, and closing against it double-counts. 0 = off.
    lc_min_age_frames: int = 0
    # carry anchor-pose Jacobian blocks on LC rows when the matched
    # landmark's anchor group is still instate (ComputeLCJacobian's
    # matched-group derivative, src/oos.cpp:92-145). Off by default:
    # the map stores WORLD-frame landmarks, so the predicted
    # measurement is computed from fixed world coordinates and does
    # not actually move with the live anchor pose — carrying the
    # anchor block without re-expressing the landmark in the live
    # anchor claims a dependence the innovation does not have, and
    # every closure with a live anchor injects a spurious anchor-pose
    # correction (A/B in scripts/run_longhorizon_mapped.py)
    lc_anchor_rows: bool = False

    # out-of-order message buffering (src/estimator.h:556-561,
    # MESSAGE_BUFFER_SIZE default 10; drained in src/estimator.cpp:
    # 923-941): messages are timestamp-heap-ordered and executed only
    # once the buffer holds more than this many; stragglers older than
    # the executed clock are dropped. 0 = immediate dispatch (dataset
    # replay feeds pre-sorted streams); live/sensor mode wants ~10.
    message_buffer_size: int = 0

    # IMU clamp
    clamp_signals: bool = False
    max_accel: Tuple[float, float, float] = (20.0, 20.0, 20.0)
    max_gyro: Tuple[float, float, float] = (10.0, 10.0, 10.0)

    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.8)
    gravity_init_counter: int = 20
    imu_tk_convention: bool = False
    simulation: bool = False
    # initialize new features at ground-truth depth in simulation (the
    # pyxivo `InitWithSimDepths` hook, pybind11/pyxivo.cpp:385)
    sim_initialize_depths: bool = False

    # initial nominal state & uncertainties (as std-devs; squared on build)
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

    P_Wsb: float = 0.0001
    P_Tsb: float = 0.0001
    P_Vsb: float = 1.0
    P_bg: float = 1e-4
    P_ba: float = 1e-3
    P_Wbc: float = 0.0001
    P_Tbc: Tuple[float, float, float] = (0.0001, 0.0001, 0.0001)
    P_Wsg: float = 0.01
    P_td: float = 0.0
    P_Cg: float = 0.0
    P_Ca: float = 0.0
    P_FC: Tuple[float, float] = (0.0, 0.0)
    P_distortion: float = 0.0

    Qmodel_Wsb: float = 0.0
    Qmodel_Wbc: float = 0.0
    Qmodel_Wsg: float = 0.0
    # extrinsic-translation random walk: models linearization-drift
    # error in the camera-IMU translation (the measured tube-world bias
    # floor, tests/test_consistency.py) so its covariance keeps a floor
    # instead of collapsing below the bias -- the NEES-honest option
    # the reference's Qmodel (src/estimator.cpp:590) lacks
    Qmodel_Tbc: float = 0.0

    Qimu_gyro: Tuple[float, float, float] = (1e-3,) * 3
    Qimu_accel: Tuple[float, float, float] = (1e-2,) * 3
    Qimu_gyro_bias: Tuple[float, float, float] = (1e-4,) * 3
    Qimu_accel_bias: Tuple[float, float, float] = (1e-5,) * 3

    # camera
    cam_model: str = "pinhole"
    cam_params: Tuple = (480, 640, 275.0, 275.0, 320.0, 240.0)  # rows, cols, fx, fy, cx, cy [, ...]

    # tracker
    max_pixel_displacement: float = 64.0
    num_features_min: int = 120
    num_features_max: int = 200
    tracker_type: str = "POINTCLOUD"   # POINTCLOUD | LK | MATCH
    use_prediction: bool = False
    mask_size: int = 15
    margin: int = 8
    klt_win_size: int = 15
    klt_max_level: int = 5
    klt_max_iter: int = 30
    klt_eps: float = 0.01
    detector: str = "FAST"             # FAST | GFTT
    fast_threshold: float = 20.0
    extract_descriptor: bool = True
    # binary descriptor family: "brief" | "orb" | "freak"
    # (reference descriptor factory, src/tracker.cpp:36-97)
    descriptor_type: str = "brief"
    descriptor_distance_thresh: int = -1
    match_dropped_tracks: bool = False
    # MATCH mode: refresh stored descriptor every frame (cfg "differential",
    # src/tracker.cpp:426-428)
    differential_match: bool = True
    do_outlier_rejection: bool = False
    homography_reproj_thresh: float = 3.0

    def __post_init__(self):
        # every construction path (JSON, direct ctor, dataclasses.replace)
        # must hit this invariant: only _propagate_frame_fast applies the
        # OC transition correction, so other modes would silently skip it
        if self.use_oc and self.propagation_mode != "fast":
            raise ValueError(
                "use_oc requires propagation_mode='fast' (the OC correction "
                "applies to the per-frame transition, which only the fast "
                "mode materializes)")
        if self.comparison_score_type not in (
                "DepthUncertainty", "CovarianceDiagNorm",
                "CovarianceDiagNormPlusOutlierCount"):
            raise ValueError(
                f"invalid comparison_score_type "
                f"{self.comparison_score_type!r}")
        if self.covariance_form not in ("full", "sqrt"):
            raise ValueError(
                f"covariance_form must be 'full' or 'sqrt', got "
                f"{self.covariance_form!r}")
        if self.covariance_form == "sqrt" and self.propagation_mode != "fast":
            raise ValueError(
                "covariance_form='sqrt' requires propagation_mode='fast' "
                "(the factor propagation consumes the per-frame discrete "
                "transition Phi and accumulated Qd, which only the fast "
                "mode materializes)")

    @property
    def R(self):
        return self.visual_meas_std ** 2

    @property
    def Rlc(self):
        return self.lc_meas_std ** 2


def _vec(j, key, default=None):
    v = j.get(key, default)
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _rotvec(j, key):
    """Rotation config entry: tangent 3-vector OR a full 3x3 rotation
    matrix (the reference's TUM-VI configs give Wbc as a matrix,
    cfg/tumvi_cam0.json:60-63; parsed either way by GetVectorFromJson /
    the Estimator ctor)."""
    v = j.get(key, (0.0, 0.0, 0.0))
    a = np.asarray(v, dtype=np.float64)
    if a.shape == (3, 3):
        import torch
        from ..geom import so3
        return tuple(so3.log(torch.as_tensor(a)).tolist())
    return tuple(a.reshape(-1)[:3])


def config_from_json(cfg: dict, dims: Optional[Dims] = None,
                     **overrides) -> VIOConfig:
    """Build a VIOConfig from a reference-format JSON dict.

    Field mapping mirrors the Estimator ctor (src/estimator.cpp:100-417).
    """
    X = cfg.get("X", {})
    P = cfg.get("P", {})
    Qm = cfg.get("Qmodel", {})
    Qi = cfg.get("Qimu", {})
    sub = cfg.get("subfilter", {})
    tri = cfg.get("triangulation", {})
    dop = cfg.get("depth_opt", {})
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

    cam_extra = []
    model = cam.get("model", "pinhole").lower()
    if model == "radtan":
        cam_extra = [cam.get("p1", 0.0), cam.get("p2", 0.0), cam.get("k1", 0.0),
                     cam.get("k2", 0.0), cam.get("k3", 0.0)]
    elif model in ("equi", "equidistant"):
        # the reference's TUM-VI configs write the distortion as a
        # "k0123" list (cfg/tumvi_cam0.json:191); flat k0..k3 also valid
        if "k0123" in cam:
            cam_extra = list(cam["k0123"])[:4]
        else:
            cam_extra = [cam.get(k, 0.0) for k in ("k0", "k1", "k2", "k3")]
    elif model == "atan":
        cam_extra = [cam.get("w", 0.0)]

    Tbc_std = P.get("Tbc", 0.0001)
    if not isinstance(Tbc_std, (list, tuple)):
        Tbc_std = (Tbc_std,) * 3

    kw = dict(
        dims=dims or Dims(),
        integration_method=cfg.get("integration_method", "PrinceDormand"),
        pd_control_stepsize=cfg.get("PrinceDormand", {}).get(
            "control_stepsize", False),
        pd_tolerance=cfg.get("PrinceDormand", {}).get("tolerance", 1e-3),
        pd_min_scale=cfg.get("PrinceDormand", {}).get(
            "min_scale_factor", 0.125),
        pd_max_scale=cfg.get("PrinceDormand", {}).get(
            "max_scale_factor", 4.0),
        stepsize=cfg.get("PrinceDormand", {}).get(
            "stepsize", cfg.get("RK4", {}).get("stepsize", 0.002)),
        use_MH_gating=cfg.get("use_MH_gating", True),
        min_inliers=cfg.get("min_inliers", 5),
        MH_thresh=cfg.get("MH_thresh", 5.991),
        MH_adjust_factor=cfg.get("MH_adjust_factor", 1.1),
        use_1pt_RANSAC=cfg.get("use_1pt_RANSAC", False),
        use_huber=cfg.get("use_huber", False),
        outlier_thresh=cfg.get("outlier_thresh", 1.1),
        ransac_thresh=cfg.get("1pt_RANSAC_thresh", 5.0),
        ransac_prob=cfg.get("1pt_RANSAC_prob", 0.95),
        ransac_Chi2=cfg.get("1pt_RANSAC_Chi2", 5.89),
        subfilter=SubfilterOptions(
            Rtri=sub.get("visual_meas_std", 3.5) ** 2,
            MH_thresh=sub.get("MH_thresh", 5.991),
            ready_steps=sub.get("ready_steps", 5)),
        triangulation=TriangulateOptions(
            method=tri.get("method", "l1_angular"),
            zmin=tri.get("zmin", 0.05), zmax=tri.get("zmax", 5.0),
            max_theta_thresh=tri.get("max_theta_thresh", 0.1) * np.pi / 180,
            beta_thresh=tri.get("beta_thesh", 0.25) * np.pi / 180),
        refinement=RefinementOptions(
            two_view=dop.get("two_view", False),
            use_hessian=dop.get("use_hessian", False),
            max_iters=dop.get("max_iters", 5), eps=dop.get("eps", 1e-4),
            damping=dop.get("damping", 1e-3),
            max_res_norm=dop.get("max_res_norm", 2.0),
            Rtri=sub.get("visual_meas_std", 3.5) ** 2),
        triangulate_pre_subfilter=cfg.get("triangulate_pre_subfilter", False),
        use_depth_opt=cfg.get("use_depth_opt", False),
        remove_outlier_counter=cfg.get("remove_outlier_counter", 10),
        strict_criteria_timesteps=cfg.get("strict_criteria_timesteps", 5),
        num_gauge_xy_features=cfg.get("num_gauge_xy_features", 3),
        collinear_cross_prod_thresh=cfg.get("collinear_cross_prod_thresh", 1e-3),
        group_degrees_fixed=cfg.get("group_degrees_fixed", 4),
        max_group_lifetime=cfg.get("max_group_lifetime", 1),
        feature_owner_change_cov_factor=cfg.get(
            "filter_owner_change_cov_factor", 1.5),
        init_z=cfg.get("initial_z", 2.5),
        init_std_x=cfg.get("initial_std_x", 1.0),
        init_std_y=cfg.get("initial_std_y", 1.0),
        init_std_z=cfg.get("initial_std_z", 0.5),
        init_std_x_badtri=cfg.get("initial_std_x_badtri", 1.0),
        init_std_y_badtri=cfg.get("initial_std_y_badtri", 1.0),
        init_std_z_badtri=cfg.get("initial_std_z_badtri", 0.5),
        min_z=cfg.get("min_depth", 0.05),
        max_z=cfg.get("max_depth", 5.0),
        adaptive_depth_beta=adi.get("median_weight", 0.99),
        adaptive_depth_min_lifetime=adi.get("minimum_feature_lifetime", 5),
        visual_meas_std=cfg.get("visual_meas_std", 1.0),
        oos_meas_std=cfg.get("oos_meas_std", 3.5),
        lc_meas_std=cfg.get("loop_closure_meas_std", 4.0),
        use_OOS=cfg.get("use_OOS", False),
        OOS_min_observations=cfg.get("OOS_update_min_observations", 5),
        clamp_signals=cfg.get("clamp_signals", False),
        max_accel=_vec(cfg, "max_accel", (20.0,) * 3),
        max_gyro=_vec(cfg, "max_gyro", (10.0,) * 3),
        gravity=_vec(cfg, "gravity", (0.0, 0.0, -9.8)),
        gravity_init_counter=cfg.get("gravity_init_counter", 20),
        imu_tk_convention=cfg.get("imu_tk_convention", False),
        simulation=cfg.get("simulation", False),
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
        P_td=P.get("td", 0.0), P_Cg=P.get("Cg", 0.0), P_Ca=P.get("Ca", 0.0),
        P_FC=tuple(P["FC"]) if isinstance(P.get("FC"), (list, tuple))
        else (P.get("FC", 0.0), P.get("FC", 0.0)),
        P_distortion=P.get("distortion", 0.0),
        Qmodel_Wsb=Qm.get("Wsb", 0.0), Qmodel_Wbc=Qm.get("Wbc", 0.0),
        Qmodel_Wsg=Qm.get("Wsg", 0.0), Qmodel_Tbc=Qm.get("Tbc", 0.0),
        Qimu_gyro=q3("gyro", 1e-3), Qimu_accel=q3("accel", 1e-2),
        Qimu_gyro_bias=q3("gyro_bias", 1e-4),
        Qimu_accel_bias=q3("accel_bias", 1e-5),
        cam_model=model,
        cam_params=tuple([cam.get("rows", 480), cam.get("cols", 640),
                          cam.get("fx", 275.0), cam.get("fy", 275.0),
                          cam.get("cx", 320.0), cam.get("cy", 240.0)]
                         + cam_extra),
        max_pixel_displacement=cfg.get("tracker_cfg", {}).get(
            "max_pixel_displacement", 64.0),
        num_features_min=cfg.get("tracker_cfg", {}).get("num_features_min", 120),
        num_features_max=cfg.get("tracker_cfg", {}).get("num_features_max", 200),
        tracker_type=cfg.get("tracker_cfg", {}).get("tracker_type",
                                                    "POINTCLOUD"),
        use_prediction=cfg.get("tracker_cfg", {}).get("use_prediction", False),
        mask_size=cfg.get("tracker_cfg", {}).get("mask_size", 15),
        margin=cfg.get("tracker_cfg", {}).get("margin", 8),
        klt_win_size=cfg.get("tracker_cfg", {}).get("KLT", {}).get(
            "win_size", 15),
        klt_max_level=cfg.get("tracker_cfg", {}).get("KLT", {}).get(
            "max_level", 5),
        klt_max_iter=cfg.get("tracker_cfg", {}).get("KLT", {}).get(
            "max_iter", 30),
        klt_eps=cfg.get("tracker_cfg", {}).get("KLT", {}).get("eps", 0.01),
        detector=cfg.get("tracker_cfg", {}).get("detector", "FAST"),
        fast_threshold=cfg.get("tracker_cfg", {}).get("FAST", {}).get(
            "threshold", 20.0),
        extract_descriptor=cfg.get("tracker_cfg", {}).get(
            "extract_descriptor", True),
        descriptor_type=cfg.get("tracker_cfg", {}).get(
            "descriptor", "brief").lower(),
        descriptor_distance_thresh=cfg.get("tracker_cfg", {}).get(
            "descriptor_distance_thresh", -1),
        match_dropped_tracks=cfg.get("tracker_cfg", {}).get(
            "match_dropped_tracks", False),
        differential_match=cfg.get("tracker_cfg", {}).get(
            "differential", True),
        do_outlier_rejection=cfg.get("tracker_cfg", {}).get(
            "do_outlier_rejection", False),
        homography_reproj_thresh=cfg.get("tracker_cfg", {}).get(
            "outlier_rejection", {}).get("RANSAC_reproj_thresh", 3.0),
        use_mapper=bool(cfg.get("mapper_cfg", {})) and cfg.get(
            "mapper_cfg", {}).get("detectLoopClosures", False),
        detect_loop_closures=cfg.get("mapper_cfg", {}).get(
            "detectLoopClosures", True),
        lc_nn_dist_thresh=int(cfg.get("mapper_cfg", {}).get(
            "nn_dist_thresh", 30)),
        lc_ransac_thresh=cfg.get("mapper_cfg", {}).get("RANSAC", {}).get(
            "threshold", 0.03),
    )
    # generic passthrough: any flat top-level key naming a VIOConfig field
    # (covers extension knobs like max_depth_var_for_admission,
    # propagation_mode, use_OOS overrides in JSON configs)
    valid = set(VIOConfig.__dataclass_fields__)
    for k, v in cfg.items():
        if k in valid and k not in kw:
            kw[k] = tuple(v) if isinstance(v, list) else v
    kw.update(overrides)
    cfg_out = VIOConfig(**kw)
    # size the static fast-propagation substep grid so the configured
    # stepsize is honored at the dataset's IMU rate: an interval longer
    # than fast_substeps*stepsize would otherwise silently integrate
    # coarser than configured (e.g. 100 Hz IMU + 2 ms stepsize needs 5
    # substeps, not the old fixed 4)
    if "fast_substeps" not in {**cfg, **overrides} and cfg_out.stepsize > 0:
        imu_rate = cfg.get("imu_rate", 200.0)  # Hz; reference datasets >=100
        need = int(np.ceil(1.0 / (imu_rate * cfg_out.stepsize)))
        if need > cfg_out.fast_substeps:
            cfg_out = dataclasses.replace(cfg_out, fast_substeps=need)
    return cfg_out
