"""Gauss-Newton depth refinement over a feature's observation set (port of
``xivo_tpu/filter/refine.py``; Feature::RefineDepth,
src/feature.cpp:299-460).

Minimizes the reprojection error of the local state x = (X/Z, Y/Z, log Z)
over the groups that observed the feature (its reference excluded), with
revert-on-worse iterations, a residual-norm acceptance gate and, with
``use_hessian``, the inverse Hessian as the new covariance. Every feature
of every sequence at once, against the whole group table with an
observation mask.

Differences from the reference, none of which waits for the device:

* the damped 3 x 3 step solves ``H + damping I`` (SPD) in closed form by
  the adjugate, where the reference takes ``lstsq``: the same solution;
* ``use_hessian`` inverts the Hessian by the adjugate where the reference
  takes ``pinv``: equal on a nonsingular H. A numerically singular H
  (det(H) <= 3 eps tr(H)^3, e.g. the rank-2 H of a single observation)
  keeps the subfilter covariance, where ``pinv`` would give a covariance
  with zero variance along the unobserved direction (ROADMAP C);
* the ``fori_loop`` of max_iters + 1 steps is a fixed loop whose stopped
  features keep their values.
"""
from __future__ import annotations

import torch

from ..cam import models as cam_mod
from ..ops.dense import adjugate3, constant
from .config import RefinementOptions
from .features import project_persp, unproject_logz
from .propagate import mv


def refine_depth(cam_kind: int, intrin, X, Rsbr, Tsbr, groups_R, groups_T,
                 obs_mask, obs_xp, x0, Psub0, opts: RefinementOptions):
    """Returns (x, Psub, ok), each with the leading dims (B, NF).

    intrin (B, 9); X the motion state (B, ...); Rsbr (B, NF, 3, 3), Tsbr
    (B, NF, 3) the reference group poses; groups_R (B, NG, 3, 3), groups_T
    (B, NG, 3) the group table; obs_mask (B, NF, NG) the group rows that
    observed each feature (reference excluded by the caller), obs_xp
    (B, NF, NG, 2) those observations; x0 (B, NF, 3), Psub0 (B, NF, 3, 3).
    """
    dtype, dev = x0.dtype, x0.device
    n_obs = torch.sum(obs_mask.to(dtype), dim=-1)
    Rbc = X.Rbc[:, None]
    Rsc = Rsbr @ Rbc                                        # (B, NF, 3, 3)
    Tsc = mv(Rsbr, X.Tbc[:, None]) + Tsbr
    Rcs = (groups_R @ Rbc).transpose(-1, -2)                # (B, NG, 3, 3)
    Tcg = mv(groups_R, X.Tbc[:, None]) + groups_T           # (B, NG, 3)
    icam = intrin[:, None, None]
    invC = 1.0 / opts.Rtri
    front = constant((0.0, 0.0, 1.0), dtype, dev)

    def residuals(x):
        """The masked normal equations and residual-norm sum at x."""
        Xc, dXc_dx = unproject_logz(x)
        Xs = mv(Rsc, Xc) + Tsc
        dXs_dx = Rsc @ dXc_dx
        Xcn = torch.einsum("bgij,bfgj->bfgi", Rcs,
                           Xs[:, :, None] - Tcg[:, None])   # (B, NF, NG, 3)
        dXcn_dx = torch.einsum("bgij,bfjk->bfgik", Rcs, dXs_dx)
        safe = obs_mask & (Xcn[..., 2] > 1e-6)
        xcn, dxcn_dXcn = project_persp(
            torch.where(safe[..., None], Xcn, front))
        xp_pred, dxp_dxcn, _ = cam_mod.project_with_jac(cam_kind, icam, xcn)
        w = safe.to(dtype)
        J = (dxp_dxcn @ dxcn_dXcn @ dXcn_dx) * w[..., None, None]
        r = (xp_pred - obs_xp) * w[..., None]
        H = invC * torch.einsum("bfgij,bfgik->bfjk", J, J)
        b = invC * torch.einsum("bfgij,bfgi->bfj", J, r)
        return H, b, torch.sum(torch.linalg.vector_norm(r, dim=-1), dim=-1)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    x = x_best = x0
    res_best = torch.full_like(n_obs, torch.inf)
    H_best = eye3.expand(Psub0.shape)
    done = torch.zeros_like(obs_mask[..., 0])
    for _ in range(opts.max_iters + 1):
        H, b, res = residuals(x)
        worse = res > res_best                  # revert-on-worse
        co, det = adjugate3(H + opts.damping * eye3)
        delta = mv(co, b) / det[..., None]
        x_new = x - delta
        small = torch.amax(torch.abs(delta), dim=-1) < opts.eps
        stop = done | worse | small
        keep = worse | done
        x_best = torch.where(keep[..., None], x_best, x)
        res_best = torch.where(keep, res_best, res)
        H_best = torch.where(keep[..., None, None], H_best, H)
        x = torch.where(stop[..., None], x_best, x_new)
        done = stop

    # the reference gates the SUM of residual norms; scaled by n_obs as
    # the group table's capacity makes the raw sum depend on occupancy
    ok = (res_best <= opts.max_res_norm * torch.clamp(n_obs, min=1.0)) \
        & (n_obs >= 1)
    if opts.use_hessian:
        co, det = adjugate3(H_best)
        tr = torch.diagonal(H_best, dim1=-2, dim2=-1).sum(-1)
        eps = torch.finfo(dtype).eps
        regular = torch.abs(det) > 3.0 * eps * torch.abs(tr) ** 3
        Hp = co / torch.where(regular, det, torch.ones_like(det))[..., None,
                                                                  None]
        good = regular & torch.isfinite(Hp).all(-1).all(-1)
        Psub = torch.where(good[..., None, None], Hp, Psub0)
    else:
        Psub = Psub0
    return torch.where(ok[..., None], x_best, x0), Psub, ok
