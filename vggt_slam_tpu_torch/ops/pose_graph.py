"""Levenberg-Marquardt pose-graph optimization on SL(4)/Sim(3)/SE(3)
(counterpart of vggt_slam_tpu/ops/pose_graph.py): GTSAM residuals (r =
Log(Z^-1 X_i^-1 X_j), priors Log(Z^-1 X)) whitened by sqrt information,
right retraction, exact forward-mode Jacobians (jacfwd under vmap), nodes
and factors padded to buckets and masked, dense normal equations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from vggt_slam_tpu_torch.ops import lie


class GraphArrays(NamedTuple):
    """Padded factor graph, all on one device."""

    values: torch.Tensor          # (N, 4, 4) current estimates
    node_mask: torch.Tensor       # (N,) bool
    bet_i: torch.Tensor           # (E,) int64 from-node index
    bet_j: torch.Tensor           # (E,) int64 to-node index
    bet_meas: torch.Tensor        # (E, 4, 4) measured relative transform
    bet_sqrt_info: torch.Tensor   # (E, D) diagonal sqrt information
    bet_mask: torch.Tensor        # (E,) bool
    pri_node: torch.Tensor        # (P,) int64
    pri_meas: torch.Tensor        # (P, 4, 4)
    pri_sqrt_info: torch.Tensor   # (P, D)
    pri_mask: torch.Tensor        # (P,) bool


# Residuals are only ever evaluated at a zero tangent, where the scaled
# Taylor series of exp needs no squaring; a fixed count keeps them free of
# data-dependent control flow under vmap/jacfwd.
_EXP_AT_ZERO = 0


def _between_residual(manifold, Xi, Xj, Z, sqrt_info, di, dj):
    Xi = Xi @ lie.manifold_exp(manifold, di, _EXP_AT_ZERO)
    Xj = Xj @ lie.manifold_exp(manifold, dj, _EXP_AT_ZERO)
    err = lie.inv44(Z) @ (lie.inv44(Xi) @ Xj)
    return sqrt_info * lie.manifold_log(manifold, err)


def _prior_residual(manifold, X, Z, sqrt_info, d):
    X = X @ lie.manifold_exp(manifold, d, _EXP_AT_ZERO)
    return sqrt_info * lie.manifold_log(manifold, lie.inv44(Z) @ X)


def _masked(r, J, mask):
    m = mask.to(r.dtype)
    return r * m[:, None], J * m[:, None, None]


def _vmap(fn, *args, out_shapes):
    """vmap over the factor axis; an empty factor set gives empty outputs
    (vmap refuses a batch of size 0)."""
    if args[0].shape[0] == 0:
        like = args[0]
        return tuple(torch.zeros((0,) + s, dtype=like.dtype,
                                 device=like.device) for s in out_shapes)
    return vmap(fn)(*args)


def _linearize(manifold: str, g: GraphArrays):
    """Residuals and Jacobians of all factors at delta = 0."""
    D = lie.MANIFOLD_DOF[manifold]
    z1 = torch.zeros(D, dtype=g.values.dtype, device=g.values.device)
    z2 = torch.zeros(2 * D, dtype=g.values.dtype, device=g.values.device)

    def bet_fn(Xi, Xj, Z, s):
        def f(dd):
            return _between_residual(manifold, Xi, Xj, Z, s, dd[:D], dd[D:])
        return f(z2), jacfwd(f)(z2)                       # (D,), (D, 2D)

    def pri_fn(X, Z, s):
        def f(d):
            return _prior_residual(manifold, X, Z, s, d)
        return f(z1), jacfwd(f)(z1)                       # (D,), (D, D)

    r_bet, J_bet = _vmap(bet_fn, g.values[g.bet_i], g.values[g.bet_j],
                         g.bet_meas, g.bet_sqrt_info,
                         out_shapes=((D,), (D, 2 * D)))
    r_pri, J_pri = _vmap(pri_fn, g.values[g.pri_node], g.pri_meas,
                         g.pri_sqrt_info, out_shapes=((D,), (D, D)))
    r_bet, J_bet = _masked(r_bet, J_bet, g.bet_mask)
    r_pri, J_pri = _masked(r_pri, J_pri, g.pri_mask)
    return r_bet, J_bet, r_pri, J_pri


def _assemble(manifold: str, g: GraphArrays, r_bet, J_bet, r_pri, J_pri):
    D = lie.MANIFOLD_DOF[manifold]
    N = g.values.shape[0]
    dim = N * D
    ar = torch.arange(D, device=g.values.device)
    idx_bet = torch.cat([g.bet_i[:, None] * D + ar, g.bet_j[:, None] * D + ar],
                        dim=1)                            # (E, 2D)
    idx_pri = g.pri_node[:, None] * D + ar                # (P, D)
    H = torch.zeros(dim * dim, dtype=g.values.dtype, device=g.values.device)
    grad = torch.zeros(dim, dtype=g.values.dtype, device=g.values.device)
    for idx, J, r in ((idx_bet, J_bet, r_bet), (idx_pri, J_pri, r_pri)):
        blk = torch.einsum("eri,erj->eij", J, J)
        flat = (idx[:, :, None] * dim + idx[:, None, :]).reshape(-1)
        H.index_add_(0, flat, blk.reshape(-1))
        grad.index_add_(0, idx.reshape(-1),
                        torch.einsum("eri,er->ei", J, r).reshape(-1))
    H = H.view(dim, dim)
    nm = g.node_mask.repeat_interleave(D).to(H.dtype)
    return H + torch.diag(1.0 - nm), grad * nm


def _residuals(manifold: str, g: GraphArrays):
    D = lie.MANIFOLD_DOF[manifold]
    z = torch.zeros(D, dtype=g.values.dtype, device=g.values.device)
    (r_bet,) = _vmap(lambda Xi, Xj, Z, s: (_between_residual(
        manifold, Xi, Xj, Z, s, z, z),),
        g.values[g.bet_i], g.values[g.bet_j], g.bet_meas, g.bet_sqrt_info,
        out_shapes=((D,),))
    (r_pri,) = _vmap(lambda X, Z, s: (_prior_residual(
        manifold, X, Z, s, z),),
        g.values[g.pri_node], g.pri_meas, g.pri_sqrt_info,
        out_shapes=((D,),))
    return (r_bet * g.bet_mask.to(r_bet.dtype)[:, None],
            r_pri * g.pri_mask.to(r_pri.dtype)[:, None])


def total_error(manifold: str, g: GraphArrays) -> torch.Tensor:
    r_bet, r_pri = _residuals(manifold, g)
    return 0.5 * ((r_bet ** 2).sum() + (r_pri ** 2).sum())


def _active_factors(g: GraphArrays) -> GraphArrays:
    """The graph with its factor arrays cut to the unmasked entries. Masked
    factors contribute exactly zero to the normal equations; the reference
    evaluates them only to keep its compiled shapes static. Node arrays
    keep their bucket capacity."""
    bet = torch.nonzero(g.bet_mask).flatten()
    pri = torch.nonzero(g.pri_mask).flatten()
    return g._replace(
        bet_i=g.bet_i[bet], bet_j=g.bet_j[bet], bet_meas=g.bet_meas[bet],
        bet_sqrt_info=g.bet_sqrt_info[bet], bet_mask=g.bet_mask[bet],
        pri_node=g.pri_node[pri], pri_meas=g.pri_meas[pri],
        pri_sqrt_info=g.pri_sqrt_info[pri], pri_mask=g.pri_mask[pri])


def _retract_all(manifold: str, values, delta, node_mask):
    D = lie.MANIFOLD_DOF[manifold]
    d = delta.view(values.shape[0], D) * node_mask.to(values.dtype)[:, None]
    return values @ lie.manifold_exp(manifold, d)


@torch.no_grad()
def optimize(g: GraphArrays, manifold: str = "sl4", max_iters: int = 60,
             inner_tries: int = 4, lambda_init: float = 1e-5,
             lambda_factor: float = 10.0, abs_tol: float = 1e-12,
             rel_tol: float = 1e-10):
    """LM to convergence -> (values (N, 4, 4), final error): multiplicative
    damping on the Hessian diagonal, lambda /10 on an accepted step, x10 on a
    rejected one (in [1e-12, 1e10]), up to `inner_tries` a step; stops on no
    accepted step or a decrease below tolerance, as the reference."""
    g = _active_factors(g)
    values = g.values
    err = total_error(manifold, g)
    lam = lambda_init
    for _ in range(max_iters):
        prev = err
        accepted = False
        for _ in range(inner_tries):
            gg = g._replace(values=values)
            H, grad = _assemble(manifold, gg, *_linearize(manifold, gg))
            diag = torch.diagonal(H)
            H_damped = H + torch.diag(diag.clamp_min(1e-10)) * lam
            L, info = torch.linalg.cholesky_ex(H_damped)
            delta = torch.cholesky_solve(-grad[:, None], L)[:, 0]
            if not bool(torch.isfinite(delta).all()) or int(info) != 0:
                delta = torch.zeros_like(delta)
            new_values = _retract_all(manifold, values, delta, g.node_mask)
            new_err = total_error(manifold, g._replace(values=new_values))
            if bool(torch.isfinite(new_err)) and bool(new_err < err):
                values, err = new_values, new_err
                lam = max(lam / lambda_factor, 1e-12)
                accepted = True
                break
            lam = min(lam * lambda_factor, 1e10)
        decrease = float(prev - err)
        if (not accepted or decrease < abs_tol
                or decrease < rel_tol * max(float(prev), 1e-30)):
            break
    return values, err
