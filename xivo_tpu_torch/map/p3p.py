"""Batched P3P + RANSAC for loop-closure geometric verification (port of
``xivo_tpu/map/p3p.py``).

Grunert's formulation, as the reference: the pairwise-distance quartic
for every hypothesis at once, then absolute orientation from the three
recovered camera-frame points. Two changes of means, not of results:

* the reference takes the quartic's roots as the eigenvalues of its
  companion matrix (``jnp.linalg.eigvals``) and the rotation from a 3x3
  SVD. On CUDA, PyTorch's ``eig``/``eigvals`` wait for the host. The port
  solves the quartic in closed form (Ferrari, in complex arithmetic, the
  resolvent cubic by Cardano) and polishes each root with Newton steps,
  with the reference's real-root test |imag| < 1e-6; the roots may come in
  another order than LAPACK's. The rotation comes from a fixed-sweep
  one-sided Jacobi SVD of the 3x3 cross-covariance;
* randomness enters as a tensor of uniforms (B, n_hyps, N), one draw per
  hypothesis and point, in place of the reference's
  ``jax.random.uniform`` per hypothesis key (``p3p.py:115-118``).

Every function takes leading batch dimensions.
"""
from __future__ import annotations

import cmath

import torch

from ..ops.dense import constant

N_HYPS = 64             # RANSAC hypotheses (the reference's default)
_NEWTON_STEPS = 3
_JACOBI_SWEEPS = 6
_CUBE_ROOTS_OF_ONE = tuple(cmath.exp(2j * cmath.pi * k / 3) for k in range(3))


def _cbrt(z):
    """A complex cube root (the principal one; 0 at 0)."""
    r = torch.abs(z)
    return torch.where(r > 0, torch.polar(r ** (1.0 / 3.0),
                                          torch.angle(z) / 3.0),
                       torch.zeros_like(z))


def _quartic_roots(c4, c3, c2, c1, c0):
    """The four complex roots (..., 4) of c4 x^4 + ... + c0 (c4 clamped as
    the reference clamps it) and a mask of the real ones; the real parts
    where real, 1.0 elsewhere, as the reference's ``_quartic_roots``."""
    c4s = torch.where(torch.abs(c4) < 1e-12, torch.full_like(c4, 1e-12), c4)
    cdt = torch.complex128 if c4.dtype == torch.float64 else torch.complex64
    a, b, c, d = (x.to(cdt) for x in (c3 / c4s, c2 / c4s, c1 / c4s,
                                      c0 / c4s))
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    # resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8: Cardano
    A, Bc, C = p, p * p / 4.0 - r, -q * q / 8.0
    P = Bc - A * A / 3.0
    Q = 2.0 * A ** 3 / 27.0 - A * Bc / 3.0 + C
    disc = torch.sqrt(Q * Q / 4.0 + P ** 3 / 27.0)
    w1, w2 = -Q / 2.0 + disc, -Q / 2.0 - disc
    S = _cbrt(torch.where(torch.abs(w1) >= torch.abs(w2), w1, w2))
    ms = []
    for k in range(3):
        Sk = S * constant(_CUBE_ROOTS_OF_ONE, cdt, c4.device)[k]
        T = torch.where(torch.abs(Sk) > 0, -P / (3.0 * Sk),
                        torch.zeros_like(Sk))
        ms.append(Sk + T - A / 3.0)
    m = torch.stack(ms, -1)
    # the resolvent root of largest modulus keeps sqrt(2m) away from 0
    pick = torch.argmax(torch.abs(m), dim=-1, keepdim=True)
    m = torch.gather(m, -1, pick)[..., 0]
    s2m = torch.sqrt(2.0 * m)
    s2m = torch.where(torch.abs(s2m) > 0, s2m, torch.ones_like(s2m) * 1e-30)
    roots = []
    for s1 in (1.0, -1.0):
        inner = torch.sqrt(-(2.0 * p + 2.0 * m + s1 * 2.0 * q / s2m))
        for s2 in (1.0, -1.0):
            roots.append((s1 * s2m + s2 * inner) / 2.0 - a / 4.0)
    x = torch.stack(roots, -1)
    # Newton polish on the monic quartic
    a4, b4, c4_, d4 = (v[..., None] for v in (a, b, c, d))
    for _ in range(_NEWTON_STEPS):
        f = (((x + a4) * x + b4) * x + c4_) * x + d4
        df = ((4.0 * x + 3.0 * a4) * x + 2.0 * b4) * x + c4_
        ok = torch.abs(df) > 0
        x = x - torch.where(ok, f / torch.where(ok, df, torch.ones_like(df)),
                            torch.zeros_like(f))
    real = torch.abs(x.imag) < 1e-6
    return torch.where(real, x.real, torch.ones_like(x.real)), real


def _svd3(W):
    """Left singular vectors u (3 columns, ..., 3), singular values
    (descending) and right singular vectors v of 3x3 matrices W, by
    one-sided Jacobi: fixed sweeps of plane rotations that make the
    columns of W V orthogonal; then u_i = (W V)_i / sigma_i."""
    x = [W[..., :, k] for k in range(3)]
    one = torch.ones_like(W[..., 0, 0])
    zero = torch.zeros_like(one)
    v = [torch.stack([one if r == k else zero for r in range(3)], -1)
         for k in range(3)]
    for _ in range(_JACOBI_SWEEPS):
        for i, j in ((0, 1), (0, 2), (1, 2)):
            alpha = torch.sum(x[i] * x[i], -1)
            beta = torch.sum(x[j] * x[j], -1)
            gamma = torch.sum(x[i] * x[j], -1)
            rot = torch.abs(gamma) > 0
            zeta = (beta - alpha) / (2.0 * torch.where(rot, gamma, one))
            t = torch.where(zeta >= 0, one, -one) / (
                torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(rot, t, zero)
            c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
            s = c * t[..., None]
            x[i], x[j] = c * x[i] - s * x[j], s * x[i] + c * x[j]
            v[i], v[j] = c * v[i] - s * v[j], s * v[i] + c * v[j]
    X = torch.stack(x, -1)
    V = torch.stack(v, -1)
    sig = torch.linalg.vector_norm(X, dim=-2)                   # (..., 3)
    order = torch.argsort(sig, dim=-1, descending=True, stable=True)
    sig = torch.gather(sig, -1, order)
    idx = order[..., None, :].expand(X.shape)
    tiny = 1e-300 if W.dtype == torch.float64 else 1e-30
    U = torch.gather(X, -1, idx) / torch.clamp(sig, min=tiny)[..., None, :]
    return U, sig, torch.gather(V, -1, idx)


def _horn_3pt(Pc, Pw):
    """Rigid transform (R, t) with Pc ~= R Pw + t from 3 correspondences
    (..., 3, 3): the reference's U diag(1, 1, sign det(U V^T)) V^T. Three
    centred points span at most a plane, so that is
    u1 v1^T + u2 v2^T + det(V) (u1 x u2) v3^T, which needs no third left
    singular vector."""
    mc = Pc.mean(dim=-2)
    mw = Pw.mean(dim=-2)
    W = (Pc - mc[..., None, :]).transpose(-1, -2) @ (Pw - mw[..., None, :])
    U, _, V = _svd3(W)
    u1, u2 = U[..., :, 0], U[..., :, 1]
    det_v = torch.sum(V[..., :, 0] * torch.linalg.cross(
        V[..., :, 1], V[..., :, 2], dim=-1), -1)
    u3 = det_v[..., None] * torch.linalg.cross(u1, u2, dim=-1)
    R = (u1[..., :, None] * V[..., None, :, 0]
         + u2[..., :, None] * V[..., None, :, 1]
         + u3[..., :, None] * V[..., None, :, 2])
    t = mc - (R @ mw[..., None])[..., 0]
    return R, t


def p3p_grunert(Xw, f):
    """P3P: world points Xw (..., 3, 3), unit bearings f (..., 3, 3) in the
    camera frame. Returns (R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4)):
    up to 4 pose hypotheses with Xc = R Xw + t."""
    def nrm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    a = nrm(Xw[..., 1, :] - Xw[..., 2, :])
    b = nrm(Xw[..., 0, :] - Xw[..., 2, :])
    c = nrm(Xw[..., 0, :] - Xw[..., 1, :])
    ca = torch.sum(f[..., 1, :] * f[..., 2, :], -1)
    cb = torch.sum(f[..., 0, :] * f[..., 2, :], -1)
    cc = torch.sum(f[..., 0, :] * f[..., 1, :], -1)

    a2, b2, c2 = a * a, b * b, c * c
    q = (a2 - c2) / b2
    p = (a2 + c2) / b2
    A4 = (q - 1.0) ** 2 - 4.0 * c2 / b2 * ca * ca
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - p) * ca * cc
                + 2.0 * c2 / b2 * ca * ca * cb)
    A2 = 2.0 * (q * q - 1.0 + 2.0 * q * q * cb * cb + 2.0 * (b2 - c2) / b2
                * ca * ca - 4.0 * p * ca * cb * cc
                + 2.0 * (b2 - a2) / b2 * cc * cc)
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * a2 / b2 * cc * cc * cb
                - (1.0 - p) * ca * cc)
    A0 = (1.0 + q) ** 2 - 4.0 * a2 / b2 * cc * cc

    v, vok = _quartic_roots(A4, A3, A2, A1, A0)                # (..., 4)

    def e(x):
        return x[..., None]

    q4, cb4, cc4, ca4, b24 = e(q), e(cb), e(cc), e(ca), e(b2)
    den = 2.0 * (cc4 - v * ca4)
    u = ((-1.0 + q4) * v * v - 2.0 * q4 * cb4 * v + 1.0 + q4) \
        / torch.where(torch.abs(den) < 1e-9, torch.full_like(den, 1e-9), den)
    s1sq = b24 / (1.0 + v * v - 2.0 * v * cb4)
    good = vok & (s1sq > 1e-9)
    s1 = torch.sqrt(torch.clamp(s1sq, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    good = good & (s2 > 0) & (s3 > 0)
    fe = f[..., None, :, :]                                  # (..., 1, 3, 3)
    Pc = torch.stack([s1[..., None] * fe[..., 0, :],
                      s2[..., None] * fe[..., 1, :],
                      s3[..., None] * fe[..., 2, :]], dim=-2)  # (..., 4, 3, 3)
    Xw4 = Xw[..., None, :, :].expand(Pc.shape)
    R, t = _horn_3pt(Pc, Xw4)
    res = torch.linalg.vector_norm(
        (Xw4 @ R.transpose(-1, -2) + t[..., None, :]) - Pc, dim=(-2, -1))
    good = good & (res < 1e-3 * (s1 + s2 + s3))
    return R, t, good


def pnp_ransac(uniforms, Xw, bearings, valid, inlier_thresh: float = 0.03,
               min_inliers: int = 5):
    """Vectorized P3P RANSAC (cf. cvl::pnp_ransac in mapper.cpp).

    uniforms (B, n_hyps, N) in [0, 1): each hypothesis samples the three
    valid points of smallest draw (the reference's ``argsort(r)[:3]``);
    Xw (B, N, 3) world points; bearings (B, N, 3) unit rays in the camera
    frame; valid (B, N). inlier_thresh bounds the normalized-plane
    reprojection residual. Returns (R, t, inlier_mask, ok) of the best
    hypothesis: Xc = R Xw + t."""
    dtype = Xw.dtype
    nvalid = torch.sum(valid.to(torch.int64), -1)
    r = uniforms.to(dtype) + (~valid).to(dtype)[:, None, :] * 10.0
    idx = torch.topk(r, 3, dim=-1, largest=False, sorted=True).indices
    gidx = idx[..., None].expand(idx.shape + (3,))              # (B, H, 3, 3)
    Xs = torch.gather(Xw[:, None].expand(r.shape + (3,)), 2, gidx)
    fs = torch.gather(bearings[:, None].expand(r.shape + (3,)), 2, gidx)
    R4, t4, ok4 = p3p_grunert(
        Xs, fs / torch.linalg.vector_norm(fs, dim=-1, keepdim=True))

    # score every (hypothesis, root): (B, H, 4, N)
    Xc = Xw[:, None, None] @ R4.transpose(-1, -2) + t4[..., None, :]
    z = Xc[..., 2]
    front = z > 1e-6
    zn = torch.where(front, z, torch.ones_like(z))
    proj = Xc[..., :2] / zn[..., None]
    bz = bearings[..., 2:3]
    meas = bearings[..., :2] / torch.where(torch.abs(bz) < 1e-9,
                                           torch.full_like(bz, 1e-9), bz)
    err = torch.linalg.vector_norm(proj - meas[:, None, None], dim=-1)
    inl = valid[:, None, None] & front & (err < inlier_thresh)
    counts = torch.sum(inl.to(torch.int64), -1) * ok4.to(torch.int64)
    best = torch.argmax(counts, dim=-1)                          # (B, H)
    cnt_h = torch.gather(counts, -1, best[..., None])[..., 0]
    b = torch.argmax(cnt_h, dim=-1)                              # (B,)
    bb = torch.arange(b.shape[0], device=b.device)
    root = best[bb, b]
    ok = (cnt_h[bb, b] >= min_inliers) & (nvalid >= 3)
    return R4[bb, b, root], t4[bb, b, root], inl[bb, b, root], ok
