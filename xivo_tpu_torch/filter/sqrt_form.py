"""Square-root (Cholesky-factor) covariance algebra (port of
``xivo_tpu/filter/sqrt_form.py``; its module docstring derives the
algebra).

``s.P`` holds a general factor S of shape (B, D, D + 3F) with
P = S S^T. Once a frame, ``factor_propagate_absorb`` applies the motion
transition and re-compresses the factor by ONE Gram + masked Cholesky
(kernel ``chol_lanes``); each measurement update is a one-shot downdate
built on the fused Cholesky+inverse (``chol_inv_lanes``) and a triangular
inverse (``tri_inv_lanes``). Every matmul here is a true float32 (or
float64) product: the port never enables TF32.

``factor_from_cov`` (a factor from a dense covariance, kernel
``chol_blocked``), ``noise_factor`` and ``factor_propagate`` (the
round-2 flow that wrote a factored process noise into slack columns) are
off the filter's path; the reference keeps them for its unit tests.
"""
from __future__ import annotations

import torch

from ..ops import chol, lanes_chol
from ..ops.dense import constant
from . import layout as L

# stacks wider than this are processed as sequential block downdates
# (the reference's _MAX_INV_UNROLL)
MAX_DOWNDATE_ROWS = 128


def slack_cols(dims) -> int:
    """Intra-frame factor workspace: one 3-column band per feature slot."""
    return 3 * dims.n_features


def factor_cols(dims) -> int:
    return dims.full + slack_cols(dims)


def is_sqrt(cfg) -> bool:
    return cfg.covariance_form == "sqrt"


def feature_band(dims, slot_index):
    """Slack-column band owned by a feature slot (static offsets)."""
    return dims.full + 3 * slot_index


def cov_full(P):
    """Dense covariance from a factor (identity on a square P)."""
    if P.shape[-1] == P.shape[-2]:
        return P
    return P @ P.transpose(-1, -2)


def factor_from_cov(P_full, dims):
    """Masked Cholesky of a dense (D, D) or (..., D, D) covariance ->
    factor padded with the slack columns. Rows/cols whose diagonal is not
    above 0 (frozen calibration states, empty slots, gauge-fixed entries)
    get a unit diagonal for the factorization and are zeroed after, so
    they stay exactly zero. The whole batch is one launch of B7."""
    D = P_full.shape[-1]
    keep = torch.diagonal(P_full, dim1=-2, dim2=-1) > 0
    eye = torch.eye(D, dtype=P_full.dtype, device=P_full.device)
    Pm = torch.where(keep[..., :, None] & keep[..., None, :], P_full, eye)
    S = chol.cholesky_psd(Pm)
    S = torch.where(keep[..., :, None], S, 0.0)
    return torch.nn.functional.pad(S, (0, slack_cols(dims)))


def factor_zero_rows(S, keep):
    """Zeroing row i of S zeroes row AND column i of P = S S^T."""
    return S * keep.to(S.dtype)[..., :, None]


def factor_diag(S):
    """diag(S S^T) without forming P."""
    return torch.sum(S * S, dim=-1)


def cov_diag(P):
    """diag(P) of a dense P or of a factor's S S^T."""
    if P.shape[-1] == P.shape[-2]:
        return torch.diagonal(P, dim1=-2, dim2=-1)
    return factor_diag(P)


def factor_innovation_blocks(S, H):
    """Per-feature 2x2 blocks of H P H^T: H (B, 2F, D) -> (S00, S01, S11),
    each (B, F)."""
    D = H.shape[-1]
    V = H @ S[..., :D, :]                              # (B, 2F, Dc)
    Vb = V.reshape(V.shape[:-2] + (-1, 2, V.shape[-1]))
    blk = Vb @ Vb.transpose(-1, -2)                    # (B, F, 2, 2)
    return blk[..., 0, 0], blk[..., 0, 1], blk[..., 1, 1]


def sqrt_update(S, H, inn, diagR, row_valid):
    """Factor-form EKF update with per-row validity (B, m): invalid rows
    get zero H/inn and unit R and contribute nothing. Returns
    (err (B, D), S_new). Stacks wider than MAX_DOWNDATE_ROWS run as
    sequential block downdates, each block's innovation corrected by the
    error accumulated so far (exact with diagonal R)."""
    dtype = S.dtype
    m = H.shape[-2]
    rv = row_valid.to(dtype)
    Hm = H * rv[..., :, None]
    innm = inn * rv
    Rm = torch.where(row_valid, diagR, torch.ones((), dtype=dtype,
                                                 device=S.device))
    if m <= MAX_DOWNDATE_ROWS:
        return _sqrt_downdate_block(S, Hm, innm, Rm)

    nblk = -(-m // MAX_DOWNDATE_ROWS)
    bs = -(-m // nblk)
    err = torch.zeros(S.shape[:-1], dtype=dtype, device=S.device)
    for k in range(nblk):
        sl = slice(k * bs, min((k + 1) * bs, m))
        inn_k = innm[..., sl] - (Hm[..., sl, :] @ err[..., None])[..., 0]
        err_k, S = _sqrt_downdate_block(S, Hm[..., sl, :], inn_k,
                                        Rm[..., sl])
        err = err + err_k
    return err, S


def _sqrt_downdate_block(S, Hm, innm, Rm):
    """One masked-row factor downdate (pre-masked inputs):
    W = L^-1 H S, S+ = S - (S W^T) (L + diag sqrt R)^-1 (H S)."""
    V = Hm @ S                                               # (B, m, Dc)
    Sinn = V @ V.transpose(-1, -2) + torch.diag_embed(Rm)
    Lc, Linv = lanes_chol.chol_inv_lanes(Sinn.contiguous())
    W = Linv @ V                                             # L^-1 V
    y = (Linv @ innm[..., None])[..., 0]                     # L^-1 inn
    SWt = S @ W.transpose(-1, -2)                            # (B, D, m)
    err = (SWt @ y[..., None])[..., 0]
    LRinv = lanes_chol.tri_inv_lanes(
        (Lc + torch.diag_embed(torch.sqrt(Rm))).contiguous())
    Z = LRinv @ V
    return err, S - SWt @ Z


def chol_unrolled(A, floor):
    """Straight-line Cholesky for small static n: n column steps of
    outer-product updates; pivots clamp at floor."""
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    cols = []
    X = A
    for j in range(n):
        pivot = torch.sqrt(torch.clamp(X[..., j, j], min=floor))
        col = X[..., :, j] / pivot[..., None]
        col = col * (idx >= j)
        cols.append(col)
        X = X - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def chol3x3(P3):
    """Batched 3x3 Cholesky with relative jitter (subfilter covariances)."""
    rel = 1e-14 if P3.dtype == torch.float64 else 1e-7
    tr = torch.diagonal(P3, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    eye = torch.eye(3, dtype=P3.dtype, device=P3.device)
    return chol_unrolled(P3 + (rel * tr + 1e-30) * eye, 1e-30)


def noise_rows(cfg) -> tuple:
    """Static motion-error rows that can carry process noise: the
    IMU-noise image {Wsb, Tsb, Vsb, bg, ba} plus the Qmodel-enabled
    blocks. Every other row of Qd is exactly zero (frozen calibration
    states keep zero covariance)."""
    rows = (list(range(L.WSB, L.WSB + 3)) + list(range(L.TSB, L.TSB + 3))
            + list(range(L.VSB, L.VSB + 3)) + list(range(L.BG, L.BG + 3))
            + list(range(L.BA, L.BA + 3)))
    if cfg.Qmodel_Wbc > 0:
        rows += list(range(L.WBC, L.WBC + 3))
    if cfg.Qmodel_Wsg > 0:
        rows += list(range(L.WSG, L.WSG + 2))
    return tuple(sorted(rows))


def noise_factor(cfg, Qd):
    """(..., MOTION, MOTION) factor of the accumulated process noise: the
    Cholesky of the noise rows' block with a relative jitter, embedded at
    those rows, so noise-free rows stay exactly zero. Reads nothing back
    to the host."""
    dtype, dev = Qd.dtype, Qd.device
    rows = noise_rows(cfg)
    k = len(rows)
    idx = constant(rows, torch.int64, dev)
    sub = Qd[..., idx[:, None], idx]
    rel = 1e-12 if dtype == torch.float64 else 1e-6
    eps = rel * torch.diagonal(sub, dim1=-2, dim2=-1).sum(-1) / k + 1e-30
    eye = torch.eye(k, dtype=dtype, device=dev)
    Ls = chol_unrolled(sub + eps[..., None, None] * eye, eps * 0.5)
    Lq = Qd.new_zeros(Qd.shape[:-2] + (L.MOTION, L.MOTION))
    Lq[..., idx[:, None], idx] = Ls
    return Lq


def factor_propagate(cfg, S, Phi, Qd):
    """The round-2 propagation (the filter runs factor_propagate_absorb):
    S[:m] <- Phi S[:m], then the noise factor written into columns
    [D, D + MOTION), which the caller keeps zero and re-compresses
    later."""
    m = L.MOTION
    D = cfg.dims.full
    S = torch.cat([Phi @ S[..., :m, :], S[..., m:, :]], dim=-2)
    S[..., :m, D:D + m] = noise_factor(cfg, Qd)
    return S


def factor_recompress(S, D: int, Qd=None):
    """Squeeze the (B, D, D+C) factor into D lower-triangular columns and
    re-zero the slack: Gram (+ the frame's process noise Qd on the motion
    block) + relative diagonal jitter + masked Cholesky (kernel B1)."""
    G = S @ S.transpose(-1, -2)
    if Qd is not None:
        m = L.MOTION
        G = torch.cat([torch.cat([G[..., :m, :m] + Qd, G[..., :m, m:]], -1),
                       G[..., m:, :]], -2)
    rel = 1e-12 if S.dtype == torch.float64 else 1e-6
    Gj = G + torch.diag_embed(rel * torch.diagonal(G, dim1=-2, dim2=-1))
    Lc = lanes_chol.chol_lanes(Gj.contiguous())
    return torch.nn.functional.pad(Lc, (0, S.shape[-1] - D))


def factor_propagate_absorb(cfg, S, Phi, Qd):
    """Start-of-frame factor propagation with noise absorption:
    S[:m] <- Phi S[:m], then factor_recompress with Qd."""
    m = L.MOTION
    S = torch.cat([Phi @ S[..., :m, :], S[..., m:, :]], dim=-2)
    return factor_recompress(S, cfg.dims.full, Qd=Qd)
