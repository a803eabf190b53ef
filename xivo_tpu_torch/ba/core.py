"""Bundle adjustment: Schur-complement Levenberg-Marquardt (port of
``xivo_tpu/ba/core.py``; its docstring gives the design).

The problem is dense fixed-capacity tables with a leading batch axis B:
K keyframe poses (camera-to-world), Lm landmarks, an (Lm, K) observation
mask and normalized-plane measurements. Each LM iteration builds every
residual and Jacobian at once, reduces the landmark blocks (3x3
inversions), forms the reduced camera system S = U - W V^-1 W^T densely
and solves it by Cholesky. The reference's ``lax.scan`` is a Python loop
whose accept/reject is a select, with no host branch.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geom import so3


class BAProblem(NamedTuple):
    Rs: torch.Tensor     # (B,K,3,3) camera-to-world rotations
    Ts: torch.Tensor     # (B,K,3)
    Xs: torch.Tensor     # (B,Lm,3) landmarks (world)
    obs: torch.Tensor    # (B,Lm,K,2) normalized-plane measurements
    mask: torch.Tensor   # (B,Lm,K) bool
    fixed: torch.Tensor  # (B,K) bool, gauge-fixed poses


def _residual_jac(R, T, X):
    """Residual chain world -> camera -> plane for broadcast (pose,
    landmark) pairs: R (..., 3, 3), T (..., 3), X (..., 3), Xc = R^T (X - T).
    Returns (xn (..., 2), front, J_w, J_t (..., 2, 3), J_point (..., 2, 3))
    for the right-multiplicative perturbation R exp(w), T + t."""
    Rt = R.transpose(-1, -2)
    Xc = (Rt @ (X - T)[..., None])[..., 0]
    z = Xc[..., 2]
    front = z > 1e-6
    zs = torch.where(front, z, torch.ones_like(z))
    xn = Xc[..., :2] / zs[..., None]
    zero = torch.zeros_like(zs)
    dxn_dXc = torch.stack([
        torch.stack([1.0 / zs, zero, -Xc[..., 0] / (zs * zs)], -1),
        torch.stack([zero, 1.0 / zs, -Xc[..., 1] / (zs * zs)], -1)], -2)
    return (xn, front, dxn_dXc @ so3.hat(Xc), dxn_dXc @ (-Rt),
            dxn_dXc @ Rt)


def _pairs(p: BAProblem):
    """The (pose, landmark) pairs broadcast to (B, Lm, K, ...)."""
    return p.Rs[:, None], p.Ts[:, None], p.Xs[:, :, None]


def _build_normal_eq(p: BAProblem, huber_thresh: float):
    """Every residual block with its Huber weight: (r, J_pose (2, 6),
    J_point (2, 3), use, chi2), each (B, Lm, K, ...)."""
    xn, front, Jw, Jt, Jx = _residual_jac(*_pairs(p))
    r = xn - p.obs
    use = p.mask & front
    nrm = torch.linalg.vector_norm(r, dim=-1) + 1e-12
    w = torch.where(nrm > huber_thresh, huber_thresh / nrm,
                    torch.ones_like(nrm)) * use.to(r.dtype)
    Jp = torch.cat([Jw, Jt], dim=-1)
    return (r * w[..., None], Jp * w[..., None, None], Jx * w[..., None, None],
            use, nrm ** 2 * use)


def chi2_only(p: BAProblem, huber_thresh: float):
    """(total chi2, active-observation count), each (B,): the residual-only
    sweep of the LM accept test (raw squared norms of the used residuals;
    the count rejects a step that drops pairs behind a camera)."""
    Rs, Ts, Xs = _pairs(p)
    Xc = (Rs.transpose(-1, -2) @ (Xs - Ts)[..., None])[..., 0]
    z = Xc[..., 2]
    front = z > 1e-6
    xn = Xc[..., :2] / torch.where(front, z, torch.ones_like(z))[..., None]
    use = p.mask & front
    nrm = torch.linalg.vector_norm(xn - p.obs, dim=-1) + 1e-12
    return (torch.sum(nrm ** 2 * use, dim=(1, 2)),
            torch.sum(use.to(torch.int64), dim=(1, 2)))


# LM accept hysteresis: a step must beat the current chi2 by this relative
# margin (the reference's ACCEPT_MARGIN)
ACCEPT_MARGIN = 1e-5


def normal_blocks(p: BAProblem, lam, huber_thresh: float):
    """The landmark-eliminated normal equations of the landmarks p holds,
    at lambda = lam (B,): (U (B,K,6,6), S_red (B,K,6,K,6), b_red (B,K,6),
    chi2 (B,) at p, and (W, Vinv, bl) for the back-substitution). Every
    term but the last is a sum over landmarks, so shards of them add up
    (``dist/ba.py``)."""
    dtype, dev = p.Xs.dtype, p.Xs.device
    r, Jp, Jx, use, chi2 = _build_normal_eq(p, huber_thresh)
    total_chi2 = torch.sum(chi2, dim=(1, 2))

    U = torch.einsum("blkri,blkrj->bkij", Jp, Jp)           # (B,K,6,6)
    V = torch.einsum("blkri,blkrj->blij", Jx, Jx)           # (B,Lm,3,3)
    W = torch.einsum("blkri,blkrj->blkij", Jp, Jx)          # (B,Lm,K,6,3)
    bp = -torch.einsum("blkri,blkr->bki", Jp, r)            # (B,K,6)
    bl = -torch.einsum("blkri,blkr->bli", Jx, r)            # (B,Lm,3)

    V = V + lam[:, None, None, None] * torch.eye(3, dtype=dtype, device=dev)
    Vinv = torch.linalg.inv_ex(V).inverse

    # S_red = sum_l W_l Vinv_l W_l^T, b_red = bp - sum_l W_l Vinv_l bl_l
    WVi = torch.einsum("blkij,bljm->blkim", W, Vinv)         # (B,Lm,K,6,3)
    S_red = torch.einsum("blkim,blqjm->bkiqj", WVi, W)       # (B,K,6,K,6)
    b_red = bp - torch.einsum("blkim,blm->bki", WVi, bl)
    return U, S_red, b_red, total_chi2, (W, Vinv, bl)


def solve_reduced(fixed, U, S_red, b_red, lam):
    """The pose step dp (B,K,6) of the reduced camera system
    S = U + lam I (block diagonal) - S_red, S dp = b_red, by Cholesky."""
    B, K = fixed.shape
    dtype, dev = U.dtype, U.device
    Ud = U + lam[:, None, None, None] * torch.eye(6, dtype=dtype, device=dev)
    S = torch.einsum("kq,bkij->bkiqj",
                     torch.eye(K, dtype=dtype, device=dev), Ud)
    S = (S - S_red).reshape(B, 6 * K, 6 * K)
    b = b_red.reshape(B, 6 * K)

    # gauge: zero rows/cols of fixed poses, unit diagonal
    fixvec = torch.repeat_interleave(fixed, 6, dim=1)
    keep = (~fixvec).to(dtype)
    S = S * keep[:, :, None] * keep[:, None, :] \
        + torch.diag_embed(fixvec.to(dtype))
    b = b * keep

    Lc, info = torch.linalg.cholesky_ex(S)
    dp = torch.cholesky_solve(b[..., None], Lc)[..., 0]
    # a failed factorization gives NaN, as the reference's cho_factor does,
    # so the accept test rejects the step
    return torch.where((info == 0)[:, None], dp, torch.nan).reshape(B, K, 6)


def apply_step(p: BAProblem, dp, W, Vinv, bl) -> BAProblem:
    """p moved by the pose step dp and its landmarks' back-substituted
    steps dl = Vinv (bl - W^T dp) (observed landmarks only)."""
    Wtdp = torch.einsum("blkij,bki->blj", W, dp)
    dl = (Vinv @ (bl - Wtdp)[..., None])[..., 0]
    Rs = so3.project(p.Rs @ so3.exp(dp[..., :3]))
    Ts = p.Ts + dp[..., 3:]
    seen = torch.any(p.mask, dim=2)                          # only observed
    Xs = p.Xs + dl * seen[..., None].to(p.Xs.dtype)
    return p._replace(Rs=Rs, Ts=Ts, Xs=Xs)


def ba_iteration(p: BAProblem, damping, huber_thresh: float):
    """One damped Gauss-Newton step at lambda = damping (B,). Returns (the
    stepped problem, chi2 (B,) at the input p)."""
    lam = damping.to(p.Xs.dtype)
    U, S_red, b_red, chi2, back = normal_blocks(p, lam, huber_thresh)
    dp = solve_reduced(p.fixed, U, S_red, b_red, lam)
    return apply_step(p, dp, *back), chi2


def levenberg_marquardt(p: BAProblem, iters: int, damping: float,
                        iteration, chi2) -> Tuple[BAProblem, torch.Tensor]:
    """The adaptive LM loop of ``solve`` over given pieces:
    iteration(p, lam) -> (stepped p, chi2 at p) and chi2(p) -> (chi2,
    active count), each (B,)."""
    B = p.mask.shape[0]
    lam = torch.full((B,), damping, dtype=p.Xs.dtype, device=p.Xs.device)
    hist = []
    for _ in range(iters):
        p_try, chi2_cur = iteration(p, lam)
        chi2_try, n_try = chi2(p_try)
        _, n_cur = chi2(p)
        accept = (chi2_try < chi2_cur * (1.0 - ACCEPT_MARGIN)) \
            & (n_try >= n_cur)
        p = BAProblem(*(torch.where(
            accept.reshape((B,) + (1,) * (new.dim() - 1)), new, old)
            for new, old in zip(p_try, p)))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e6))
        hist.append(chi2_cur)
    return p, torch.stack(hist, dim=1)


def solve(p: BAProblem, iters: int = 10, damping: float = 1e-4,
          huber_thresh: float = 1e9) -> Tuple[BAProblem, torch.Tensor]:
    """Adaptive Levenberg-Marquardt (Optimizer::Solve's fixed budget,
    src/optimizer.cpp:140-162): a step is accepted only if it lowers chi2
    by ACCEPT_MARGIN and loses no active observation (lambda /= 2), else
    the parameters stay and lambda *= 10. Returns (problem, chi2 history
    (B, iters) at each iteration's input point)."""
    return levenberg_marquardt(
        p, iters, damping,
        lambda q, lam: ba_iteration(q, lam, huber_thresh),
        lambda q: chi2_only(q, huber_thresh))
