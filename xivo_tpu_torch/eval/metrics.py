"""Trajectory evaluation: ATE (Horn alignment) and RPE (port of
``xivo_tpu/eval/metrics.py``, a numpy copy).

Port of the reference's evaluation protocol — the TUM-RGBD benchmark
scripts it vendors (scripts/tum_rgbd_benchmark_tools/evaluate_ate.py,
evaluate_rpe.py) and the in-C++ metrics (src/metrics.cpp:8-130,
src/geometry.cpp:66-80). numpy, host-side.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def associate(t_est, t_gt, max_difference=0.001):
    """Timestamp association with the TUM protocol's GLOBAL best-pair
    semantics (scripts/tum_rgbd_benchmark_tools/associate.py:76-105):
    enumerate ALL candidate pairs with |dt| strictly below
    max_difference, sort them by (|dt|, t_first, t_second), and take
    pairs greedily without reusing either side. This differs from
    first-come nearest-neighbor matching on jittery stamps — an earlier
    estimate must not steal a GT stamp that a later estimate matches
    more closely. Returns (i_est, i_gt) index pairs sorted by i_est.
    """
    t_est = np.asarray(t_est, float)
    t_gt = np.asarray(t_gt, float)
    # candidate generation: GT stamps within the window of each estimate
    # (sorted GT assumed, as produced by every loader here); equivalent
    # to the reference's full cross product filtered by the window.
    lo = np.searchsorted(t_gt, t_est - max_difference, side="left")
    hi = np.searchsorted(t_gt, t_est + max_difference, side="right")
    cand = []
    for i, t in enumerate(t_est):
        for k in range(lo[i], hi[i]):
            d = abs(t_gt[k] - t)
            if d < max_difference:
                cand.append((d, t, t_gt[k], i, k))
    cand.sort()
    used_e, used_g = set(), set()
    pairs = []
    for d, te, tg, i, k in cand:
        if i not in used_e and k not in used_g:
            used_e.add(i)
            used_g.add(k)
            pairs.append((i, k))
    pairs.sort()
    return pairs


def horn_align(P_est, P_gt) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form rigid alignment (Horn; evaluate_ate.py:align).

    Returns (R, t) minimizing || R P_est + t - P_gt ||. No scale (the
    TUM ATE script aligns SE3 only; VIO is metric).
    """
    mu_e = P_est.mean(axis=0)
    mu_g = P_gt.mean(axis=0)
    E = P_est - mu_e
    G = P_gt - mu_g
    W = E.T @ G
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(t_est, T_est, t_gt, T_gt, max_difference=0.001):
    """Absolute trajectory error after Horn alignment (m).

    Returns (rmse, n_pairs, aligned_errors).
    """
    pairs = associate(np.asarray(t_est), np.asarray(t_gt), max_difference)
    if not pairs:
        return np.nan, 0, np.zeros(0)
    ie = [p[0] for p in pairs]
    ig = [p[1] for p in pairs]
    Pe = np.asarray(T_est)[ie]
    Pg = np.asarray(T_gt)[ig]
    R, t = horn_align(Pe, Pg)
    err = (Pe @ R.T + t) - Pg
    e = np.linalg.norm(err, axis=1)
    return float(np.sqrt(np.mean(e ** 2))), len(pairs), e


def rpe(t_est, R_est, T_est, t_gt, R_gt, T_gt, delta=1.0,
        max_difference=0.001):
    """Relative pose error at fixed time delta (evaluate_rpe.py
    --fixed_delta --delta 1 --delta_unit s).

    Returns (trans_rmse_m, rot_rmse_deg, n_pairs).
    """
    pairs = associate(np.asarray(t_est), np.asarray(t_gt), max_difference)
    if len(pairs) < 2:
        return np.nan, np.nan, 0
    ie = np.asarray([p[0] for p in pairs])
    ig = np.asarray([p[1] for p in pairs])
    te = np.asarray(t_est)[ie]

    trans_err, rot_err = [], []
    for a in range(len(pairs)):
        tb = te[a] + delta
        b = np.searchsorted(te, tb)
        if b >= len(pairs) or abs(te[b] - tb) > 0.05:
            continue
        # relative motions
        Re1, Te1 = np.asarray(R_est)[ie[a]], np.asarray(T_est)[ie[a]]
        Re2, Te2 = np.asarray(R_est)[ie[b]], np.asarray(T_est)[ie[b]]
        Rg1, Tg1 = np.asarray(R_gt)[ig[a]], np.asarray(T_gt)[ig[a]]
        Rg2, Tg2 = np.asarray(R_gt)[ig[b]], np.asarray(T_gt)[ig[b]]
        dRe = Re1.T @ Re2
        dTe = Re1.T @ (Te2 - Te1)
        dRg = Rg1.T @ Rg2
        dTg = Rg1.T @ (Tg2 - Tg1)
        Er = dRg.T @ dRe
        Et = dRg.T @ (dTe - dTg)
        trans_err.append(np.linalg.norm(Et))
        ang = np.arccos(np.clip((np.trace(Er) - 1) / 2, -1, 1))
        rot_err.append(np.degrees(ang))
    if not trans_err:
        return np.nan, np.nan, 0
    return (float(np.sqrt(np.mean(np.square(trans_err)))),
            float(np.sqrt(np.mean(np.square(rot_err)))), len(trans_err))
