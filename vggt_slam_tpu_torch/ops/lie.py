"""SO(3), SE(3), Sim(3), SL(4) (counterpart of vggt_slam_tpu/ops/lie.py):
batched torch, f32 or f64, without data-dependent control flow (for
torch.func Jacobians); right retraction X @ exp(xi), quaternions (w, x,
y, z), SL(4)'s basis the 12 off-diagonal E_ij (row-major), then
diag(1,-1,0,0), diag(0,1,-1,0), diag(0,0,1,-1).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


# Quaternions / SO(3)

def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) (w, x, y, z) with w >= 0 (branchless
    Shepperd: the best-conditioned of four candidates)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                     m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                     m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21,
                     1.0 - m00 - m11 + m22], -1),
    ], dim=-2)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = pivots.argmax(-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = so3_hat(w)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return _eye(3, w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) -> so(3), stable near 0 and near pi (atan2 angle)."""
    cos_t = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
             ).clamp(-1.0, 1.0)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin2 = 0.25 * (vee * vee).sum(-1)
    sin_t = torch.sqrt(sin2 + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    small = sin2 < 1e-12
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.where(small, 1.0, sin_t)))
    w_generic = scale[..., None] * vee

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = ((diag + 1.0) * 0.5).clamp_min(0.0)
    axis = torch.sqrt(axis2 + 1e-32)
    k = axis2.argmax(-1)
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    one = torch.ones_like(s01)
    sx = torch.where(k == 0, one, torch.where(k == 1, s01, s02))
    sy = torch.where(k == 1, one, torch.where(k == 0, s01, s12))
    sz = torch.where(k == 2, one, torch.where(k == 0, s02, s12))
    signs = torch.stack([sx, sy, sz], dim=-1)
    axis = axis * torch.where(signs == 0, 1.0, signs)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-32)
    near_pi = cos_t < (-1.0 + 1e-6)
    return torch.where(near_pi[..., None], axis * theta[..., None], w_generic)


# SE(3): xi = (rho, omega)

def _so3_left_jacobian(w):
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = so3_hat(w)
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return _eye(3, w) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(w):
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = so3_hat(w)
    small = theta2 < 1e-8
    half = theta * 0.5
    cot = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                      (1.0 - half * torch.cos(half)
                       / (torch.sin(half) + 1e-32)) / (theta2 + 1e-32))
    return _eye(3, w) - 0.5 * W + cot[..., None, None] * (W @ W)


def _compose(M33, t, like):
    """[[M, t], [0, 1]] from (..., 3, 3) and (..., 3)."""
    top = torch.cat([M33, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=like.dtype,
                         device=like.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi):
    rho, w = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", _so3_left_jacobian(w), rho)
    return _compose(so3_exp(w), t, xi)


def se3_log(T):
    w = so3_log(T[..., :3, :3])
    rho = torch.einsum("...ij,...j->...i", _so3_left_jacobian_inv(w),
                       T[..., :3, 3])
    return torch.cat([rho, w], dim=-1)


def se3_inverse(T):
    """Closed-form SE(3) inverse of (..., 4, 4) or (..., 3, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return _compose(Rt, ti, T)


# Sim(3): xi = (rho, omega, lambda)

def _sim3_W(w, lam):
    W = so3_hat(w)
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    s = torch.exp(lam)
    small_lam = lam.abs() < 1e-6
    small_theta = theta2 < 1e-8
    A_den = lam * lam + theta2
    s_cos = s * torch.cos(theta)
    s_sin = s * torch.sin(theta)
    lam_safe = torch.where(small_lam, 1.0, lam)
    C = torch.where(small_lam, 1.0 + lam / 2.0 + lam * lam / 6.0,
                    (s - 1.0) / lam_safe)
    A = torch.where(
        small_theta,
        torch.where(small_lam, 0.5 + lam / 3.0,
                    (s * (lam - 1.0) + 1.0) / (lam_safe * lam_safe)),
        (s_sin * lam + (1.0 - s_cos) * theta)
        / (torch.where(small_theta, 1.0, theta) * A_den + 1e-32))
    B = torch.where(
        small_theta,
        torch.where(small_lam, 1.0 / 6.0 + lam / 8.0,
                    (s * (0.5 * lam * lam - lam + 1.0) - 1.0)
                    / lam_safe ** 3),
        (C - ((s_cos - 1.0) * lam + s_sin * theta) / (A_den + 1e-32))
        / (theta2 + 1e-32))
    return (C[..., None, None] * _eye(3, w) + A[..., None, None] * W
            + B[..., None, None] * (W @ W))


def sim3_exp(xi):
    rho, w, lam = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_W(w, lam), rho)
    sR = torch.exp(lam)[..., None, None] * so3_exp(w)
    return _compose(sR, t, xi)


def det33(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3) (elementwise ops only:
    torch.linalg.det's forward derivative under vmap is not reliable)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def sim3_log(T):
    sR = T[..., :3, :3]
    s = det33(sR) ** (1.0 / 3.0)
    w = so3_log(sR / s[..., None, None])
    lam = torch.log(s)
    rho = torch.linalg.solve(_sim3_W(w, lam), T[..., :3, 3][..., None])[..., 0]
    return torch.cat([rho, w, lam[..., None]], dim=-1)


# General 4x4 matrix exp/log (SL(4))

# 2x2 minors of rows (0, 1) ("s") and rows (2, 3) ("c") over the column
# pairs below, and the adjugate of a 4x4 matrix as signed products of one
# entry and one minor: entry k of the row-major adjugate is
# sum(sign * M[row, col] * minor) over its three terms (the reference's
# closed form, vggt_slam_tpu/ops/lie.py inv44).
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_ADJ_TERMS = (
    ((1, 1, 1, "c5"), (-1, 1, 2, "c4"), (1, 1, 3, "c3")),
    ((-1, 0, 1, "c5"), (1, 0, 2, "c4"), (-1, 0, 3, "c3")),
    ((1, 3, 1, "s5"), (-1, 3, 2, "s4"), (1, 3, 3, "s3")),
    ((-1, 2, 1, "s5"), (1, 2, 2, "s4"), (-1, 2, 3, "s3")),
    ((-1, 1, 0, "c5"), (1, 1, 2, "c2"), (-1, 1, 3, "c1")),
    ((1, 0, 0, "c5"), (-1, 0, 2, "c2"), (1, 0, 3, "c1")),
    ((-1, 3, 0, "s5"), (1, 3, 2, "s2"), (-1, 3, 3, "s1")),
    ((1, 2, 0, "s5"), (-1, 2, 2, "s2"), (1, 2, 3, "s1")),
    ((1, 1, 0, "c4"), (-1, 1, 1, "c2"), (1, 1, 3, "c0")),
    ((-1, 0, 0, "c4"), (1, 0, 1, "c2"), (-1, 0, 3, "c0")),
    ((1, 3, 0, "s4"), (-1, 3, 1, "s2"), (1, 3, 3, "s0")),
    ((-1, 2, 0, "s4"), (1, 2, 1, "s2"), (-1, 2, 3, "s0")),
    ((-1, 1, 0, "c3"), (1, 1, 1, "c1"), (-1, 1, 2, "c0")),
    ((1, 0, 0, "c3"), (-1, 0, 1, "c1"), (1, 0, 2, "c0")),
    ((-1, 3, 0, "s3"), (1, 3, 1, "s1"), (-1, 3, 2, "s0")),
    ((1, 2, 0, "s3"), (-1, 2, 1, "s1"), (1, 2, 2, "s0")),
)
_DET_TERMS = ((1, 0, 5), (-1, 1, 4), (1, 2, 3), (1, 3, 2), (-1, 4, 1),
              (1, 5, 0))   # det = sum(sign * s_i * c_j)


@functools.lru_cache(maxsize=None)
def _adj_tables_np():
    T = np.zeros((16, 16, 12))
    for k, terms in enumerate(_ADJ_TERMS):
        for sign, r, c, minor in terms:
            idx = int(minor[1]) + (6 if minor[0] == "c" else 0)
            T[k, 4 * r + c, idx] += sign
    Dm = np.zeros((6, 6))
    for sign, i, j in _DET_TERMS:
        Dm[i, j] = sign
    return T, Dm


@functools.lru_cache(maxsize=None)
def _adj_tables(dtype, device):
    T, Dm = _adj_tables_np()
    a = torch.as_tensor([p[0] for p in _PAIRS], device=device)
    b = torch.as_tensor([p[1] for p in _PAIRS], device=device)
    return (torch.as_tensor(T.reshape(16, 192).T, dtype=dtype,
                            device=device),
            torch.as_tensor(Dm, dtype=dtype, device=device), a, b)


def _minors44(M):
    """(s, c) 2x2 minors of rows (0,1) and (2,3), det, and the tables."""
    T, Dm, a, b = _adj_tables(M.dtype, M.device)
    s = M[..., 0, a] * M[..., 1, b] - M[..., 0, b] * M[..., 1, a]
    c = M[..., 2, a] * M[..., 3, b] - M[..., 2, b] * M[..., 3, a]
    det = torch.einsum("...i,ij,...j->...", s, Dm, c)
    return s, c, det, T


def det44(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 4, 4) (see det33)."""
    return _minors44(M)[2]


def inv44(M: torch.Tensor, refine: int = 1) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 4, 4) with `refine` Newton
    steps X <- X (2I - M X) restoring LU-level accuracy. Tensor-shaped
    (a few batched ops, not one per entry), so it stays cheap under
    torch.func transforms."""
    s, c, det, T = _minors44(M)
    sc = torch.cat([s, c], dim=-1)
    prods = M.reshape(M.shape[:-2] + (16, 1)) * sc[..., None, :]
    adj = prods.reshape(M.shape[:-2] + (192,)) @ T
    X = (adj / det[..., None]).reshape(M.shape)
    eye2 = 2.0 * _eye(4, M)
    for _ in range(refine):
        X = X @ (eye2 - M @ X)
    return X


def expm(A: torch.Tensor, squarings: int | None = None) -> torch.Tensor:
    """Matrix exponential: scaling below norm 0.25, 12-term Taylor, squaring
    (per-matrix counts, as the reference). `squarings` None derives the counts
    from the data (eager only: one host read); an int fixes them, free of
    data-dependent control flow under torch.func (the residuals pass 0: exp at
    a zero tangent)."""
    if squarings is None:
        norm = torch.linalg.norm(A, dim=(-2, -1), keepdim=True)
        n_sq = torch.ceil(torch.log2(norm.clamp_min(1e-30) / 0.25)
                          ).clamp(0, 30)
        n_max = int(n_sq.max()) if n_sq.numel() else 0
    else:
        n_sq = torch.full(A.shape[:-2] + (1, 1), float(squarings),
                          dtype=A.dtype, device=A.device)
        n_max = squarings
    As = A / (2.0 ** n_sq)
    out = _eye(A.shape[-1], A).expand(A.shape)
    term = out
    for k in range(1, 13):
        term = term @ As / k
        out = out + term
    for i in range(n_max):
        out = torch.where(i < n_sq, out @ out, out)
    return out


def _sqrtm_db(A: torch.Tensor, iters: int = 9) -> torch.Tensor:
    """Denman-Beavers matrix square root (fixed iterations)."""
    inv = inv44 if A.shape[-1] == 4 else torch.linalg.inv
    Y, Z = A, _eye(A.shape[-1], A).expand(A.shape)
    for _ in range(iters):
        Y, Z = 0.5 * (Y + inv(Z)), 0.5 * (Z + inv(Y))
    return Y


def logm(A: torch.Tensor, num_sqrt: int = 3,
         series_terms: int = 8) -> torch.Tensor:
    """Principal log: inverse scaling-and-squaring + Gregory series."""
    out = A
    for _ in range(num_sqrt):
        out = _sqrtm_db(out)
    eye = _eye(A.shape[-1], A)
    if A.shape[-1] == 4:
        B = (out - eye) @ inv44(out + eye)
    else:
        B = torch.linalg.solve((out + eye).transpose(-1, -2),
                               (out - eye).transpose(-1, -2)
                               ).transpose(-1, -2)
    B2 = B @ B
    acc = B / (2 * series_terms - 1)
    for k in range(series_terms - 1, 0, -1):
        acc = B / (2 * k - 1) + acc @ B2
    return acc * (2.0 * (2 ** num_sqrt))


# SL(4)

@functools.lru_cache(maxsize=None)
def _sl4_basis_np():
    basis = np.zeros((15, 4, 4), dtype=np.float64)
    k = 0
    for i in range(4):
        for j in range(4):
            if i != j:
                basis[k, i, j] = 1.0
                k += 1
    for d in range(3):
        basis[k, d, d] = 1.0
        basis[k, d + 1, d + 1] = -1.0
        k += 1
    Bpinv = np.linalg.pinv(basis.reshape(15, 16).T)   # (15, 16)
    return basis, Bpinv


@functools.lru_cache(maxsize=None)
def _sl4_consts(dtype, device):
    basis, Bpinv = _sl4_basis_np()
    return (torch.as_tensor(basis, dtype=dtype, device=device),
            torch.as_tensor(Bpinv, dtype=dtype, device=device))


def sl4_basis(dtype=torch.float32, device=None) -> torch.Tensor:
    return _sl4_consts(dtype, torch.device(device or "cpu"))[0]


def sl4_hat(xi: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...k,kij->...ij", xi,
                        _sl4_consts(xi.dtype, xi.device)[0])


def sl4_vee(M: torch.Tensor) -> torch.Tensor:
    Bpinv = _sl4_consts(M.dtype, M.device)[1]
    return torch.einsum("kf,...f->...k", Bpinv,
                        M.reshape(M.shape[:-2] + (16,)))


def sl4_exp(xi: torch.Tensor, squarings: int | None = None) -> torch.Tensor:
    return expm(sl4_hat(xi), squarings)


def sl4_normalize(H: torch.Tensor) -> torch.Tensor:
    """Scale so det = 1 (H / det^(1/4) with the sign kept)."""
    det = det44(H)
    scale = torch.sign(det) * det.abs() ** 0.25
    return H / (scale[..., None, None] + 1e-32)


def sl4_log(H: torch.Tensor) -> torch.Tensor:
    L = logm(sl4_normalize(H))
    tr = torch.diagonal(L, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 4.0
    return sl4_vee(L - tr * _eye(4, H))


MANIFOLD_DOF = {"se3": 6, "sim3": 7, "sl4": 15}


def manifold_exp(name: str, xi: torch.Tensor,
                 squarings: int | None = None) -> torch.Tensor:
    if name == "se3":
        return se3_exp(xi)
    if name == "sim3":
        return sim3_exp(xi)
    if name == "sl4":
        return sl4_exp(xi, squarings)
    raise ValueError(name)


def manifold_log(name: str, T: torch.Tensor) -> torch.Tensor:
    if name == "se3":
        return se3_log(T)
    if name == "sim3":
        return sim3_log(T)
    if name == "sl4":
        return sl4_log(T)
    raise ValueError(name)


def apply_homography(H: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) projective transforms to (..., N, 3) points, with
    the perspective divide."""
    Xt = torch.einsum("...ij,...nj->...ni", H[..., :3, :3], X) \
        + H[..., None, :3, 3]
    wd = torch.einsum("...j,...nj->...n", H[..., 3, :3], X) + H[..., None, 3, 3]
    return Xt / wd[..., None]
