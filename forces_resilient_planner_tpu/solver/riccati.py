"""Block-tridiagonal KKT solve via Riccati recursion.

Solves the equality-constrained QP arising at each interior-point iteration:

    min  sum_i 1/2 [dxb_i; du_i]^T [Q_i S_i^T; S_i R_i] [dxb_i; du_i]
              + qx_i^T dxb_i + qu_i^T du_i
    s.t. dxb_{i+1} = A_i dxb_i + B_i du_i + c_i        (i = 0..N-2)
         dxb_0 = [dx0_fixed; dtheta],  dtheta free     (partially-fixed init)

where xb = [x(9), uprev(4)] is the augmented state and u the 4-dim input.
The partially-free initial state encodes FORCES' xinitidx = states-only
(mpc_generator_normal.m:49): stage-0 u_prev is a free decision variable.

This is the batched replacement for FORCES' 'symm_indefinite_fast' stagewise
factorization (mpc_generator_normal.m:66).  Sequential in N (N=20) via
lax.scan; batched across scenarios with vmap.  Also returns the costates
nu_i = P_i dxb_i + p_i, which are the equality multipliers the IPM needs.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.solver.nlp import NXB, NU

_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


class LQRSolution(NamedTuple):
    dxb: jnp.ndarray    # (N, 13)
    du: jnp.ndarray     # (N, 4)
    nu: jnp.ndarray     # (N, 13) costates
    dtheta: jnp.ndarray # (4,) stage-0 u_prev step


class LQRFactor(NamedTuple):
    """Reusable Riccati factorization of the KKT matrix (everything that
    depends only on (Q, R, S, A, B), not on the right-hand side).

    Backsolves against a stored factor cost O(N 13^2 B) vs O(N 13^3 B) for
    the factorization itself, which is what makes the Mehrotra
    predictor-corrector step (two RHS per IPM iteration) nearly free.
    Matches the factor/solve split inside FORCES' 'symm_indefinite_fast'
    stagewise solver (mpc_generator_normal.m:66).

    Shapes below are the single-problem ones; lane-major variants carry a
    trailing batch axis.
    """

    P: jnp.ndarray      # (N, 13, 13) cost-to-go Hessians (P[i] at stage i)
    K: jnp.ndarray      # (N-1, 4, 13) feedback gains
    cRh: jnp.ndarray    # (N-1, 10) packed Cholesky factors of Rh_i
    RiS: jnp.ndarray    # (4, 13) terminal R^{-1} S
    cRt: jnp.ndarray    # (10,) packed terminal Cholesky of R_{N-1}


def _chol4(A):
    """Unrolled Cholesky of a 4x4 SPD matrix.

    lax.linalg.cholesky on (batch, 4, 4) lowers to serialized scalar-ish
    code; unrolling to explicit elementwise formulas keeps the whole
    Riccati sweep elementwise with the batch dimension vectorized.
    Returns the lower factor entries as a tuple.
    """
    eps = jnp.asarray(1e-30, A.dtype)
    l00 = jnp.sqrt(jnp.maximum(A[..., 0, 0], eps))
    l10 = A[..., 1, 0] / l00
    l20 = A[..., 2, 0] / l00
    l30 = A[..., 3, 0] / l00
    l11 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l10 * l10, eps))
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l31 = (A[..., 3, 1] - l30 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l20 * l20 - l21 * l21, eps))
    l32 = (A[..., 3, 2] - l30 * l20 - l31 * l21) / l22
    l33 = jnp.sqrt(
        jnp.maximum(A[..., 3, 3] - l30 * l30 - l31 * l31 - l32 * l32, eps)
    )
    return (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33)


def spd_solve4(A, B):
    """Solve A X = B for SPD 4x4 A and B of shape (..., 4, k) via unrolled
    Cholesky + forward/back substitution (elementwise, batch-vectorized)."""
    (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33) = _chol4(A)
    b0, b1, b2, b3 = B[..., 0, :], B[..., 1, :], B[..., 2, :], B[..., 3, :]
    # forward: L y = b
    y0 = b0 / l00[..., None]
    y1 = (b1 - l10[..., None] * y0) / l11[..., None]
    y2 = (b2 - l20[..., None] * y0 - l21[..., None] * y1) / l22[..., None]
    y3 = (
        b3 - l30[..., None] * y0 - l31[..., None] * y1 - l32[..., None] * y2
    ) / l33[..., None]
    # backward: L^T x = y
    x3 = y3 / l33[..., None]
    x2 = (y2 - l32[..., None] * x3) / l22[..., None]
    x1 = (y1 - l21[..., None] * x2 - l31[..., None] * x3) / l11[..., None]
    x0 = (
        y0 - l10[..., None] * x1 - l20[..., None] * x2 - l30[..., None] * x3
    ) / l00[..., None]
    return jnp.stack([x0, x1, x2, x3], axis=-2)


def chol4_solve(f, Bm):
    """Substitution against packed factors f (..., 10); B (..., 4, k)."""
    l = [f[..., i, None] for i in range(10)]
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = l
    b0, b1, b2, b3 = Bm[..., 0, :], Bm[..., 1, :], Bm[..., 2, :], Bm[..., 3, :]
    y0 = b0 / l00
    y1 = (b1 - l10 * y0) / l11
    y2 = (b2 - l20 * y0 - l21 * y1) / l22
    y3 = (b3 - l30 * y0 - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) / l00
    return jnp.stack([x0, x1, x2, x3], axis=-2)


def lqr_factor(Q, R, S, A, B) -> LQRFactor:
    """Riccati factorization, single problem (shapes as in solve_lqr)."""
    cRt = jnp.stack(_chol4(R[-1]), axis=-1)                # (10,)
    RiS = chol4_solve(cRt, S[-1])                          # (4, 13)
    P_term = Q[-1] - _mm(S[-1].T, RiS)

    def backward(P, inp):
        Qi, Ri, Si, Ai, Bi = inp
        AtP = _mm(Ai.T, P)
        BtP = _mm(Bi.T, P)
        Qh = Qi + _mm(AtP, Ai)
        Rh = Ri + _mm(BtP, Bi)
        Sh = Si + _mm(BtP, Ai)
        fh = jnp.stack(_chol4(Rh), axis=-1)                # (10,)
        K = -chol4_solve(fh, Sh)
        Pn = Qh + _mm(Sh.T, K)
        Pn = 0.5 * (Pn + Pn.T)
        return Pn, (Pn, K, fh)

    _, (Ps, Ks, cRhs) = jax.lax.scan(
        backward, P_term, (Q[:-1], R[:-1], S[:-1], A, B), reverse=True
    )
    P_all = jnp.concatenate([Ps, P_term[None]], axis=0)
    return LQRFactor(P=P_all, K=Ks, cRh=cRhs, RiS=RiS, cRt=cRt)


def lqr_solve(fac: LQRFactor, A, B, c, qx, qu, dx0) -> LQRSolution:
    """Backsolve one RHS against a stored factorization (single problem).
    Same math as lqr_solve_ll; see there for the identities used."""
    Riqu = chol4_solve(fac.cRt, qu[-1][:, None])[:, 0]
    p_term = qx[-1] - _mm(fac.RiS.T, qu[-1][:, None])[:, 0]

    def backward(p, inp):
        P_next, Ki, cRhi, qxi, qui, Ai, Bi, ci = inp
        Pc = p + _mm(P_next, ci[:, None])[:, 0]
        qxh = qxi + _mm(Ai.T, Pc[:, None])[:, 0]
        quh = qui + _mm(Bi.T, Pc[:, None])[:, 0]
        k = -chol4_solve(cRhi, quh[:, None])[:, 0]
        pn = qxh + _mm(Ki.T, quh[:, None])[:, 0]
        return pn, (pn, k)

    inputs = (fac.P[1:], fac.K, fac.cRh, qx[:-1], qu[:-1], A, B, c)
    p0, (ps, ks) = jax.lax.scan(backward, p_term, inputs, reverse=True)
    p_all = jnp.concatenate([ps, p_term[None]], axis=0)

    P0 = fac.P[0]
    Ptt = P0[9:, 9:]
    rhs = -(p0[9:] + _mm(P0[:9, 9:].T, dx0[:, None])[:, 0])
    dtheta = spd_solve4(Ptt, rhs[:, None])[:, 0]
    dxb0 = jnp.concatenate([dx0, dtheta])

    def forward(dxb, inp):
        Ki, ki, Ai, Bi, ci = inp
        du = _mm(Ki, dxb[:, None])[:, 0] + ki
        nxt = _mm(Ai, dxb[:, None])[:, 0] + _mm(Bi, du[:, None])[:, 0] + ci
        return nxt, (dxb, du)

    dxb_last, (dxbs, dus) = jax.lax.scan(forward, dxb0, (fac.K, ks, A, B, c))
    du_term = -(Riqu + _mm(fac.RiS, dxb_last[:, None])[:, 0])
    dxb_all = jnp.concatenate([dxbs, dxb_last[None]], axis=0)
    du_all = jnp.concatenate([dus, du_term[None]], axis=0)

    nu_all = jnp.einsum("nij,nj->ni", fac.P, dxb_all, precision=_PREC) + p_all
    return LQRSolution(dxb=dxb_all, du=du_all, nu=nu_all, dtheta=dtheta)


@jax.custom_batching.custom_vmap
def solve_lqr(
    Q: jnp.ndarray,    # (N, 13, 13)
    R: jnp.ndarray,    # (N, 4, 4)
    S: jnp.ndarray,    # (N, 4, 13)
    qx: jnp.ndarray,   # (N, 13)
    qu: jnp.ndarray,   # (N, 4)
    A: jnp.ndarray,    # (N-1, 13, 13)
    B: jnp.ndarray,    # (N-1, 13, 4)
    c: jnp.ndarray,    # (N-1, 13)
    dx0: jnp.ndarray,  # (9,) fixed initial state part
) -> LQRSolution:
    fac = lqr_factor(Q, R, S, A, B)
    return lqr_solve(fac, A, B, c, qx, qu, dx0)


# ---------------------------------------------------------------------------
# lane-major batched implementation (the batched hot path)
# ---------------------------------------------------------------------------
# Batched (B, 13, 13) linear algebra wastes vector width: XLA pads each
# tiny matrix to hardware tiles.  Putting the scenario batch on the minor
# (lane) dimension instead — arrays shaped (..., i, j, B) — turns every
# 13x13 operation into 13 fused elementwise FMAs over (i, k, B) tiles.
# The public solve_lqr gets a custom_vmap rule that routes batched calls
# here.

def _mm_ll(a, b):
    """(i, j, B) @ (j, k, B) -> (i, k, B): contraction as an unrolled sum of
    broadcasted elementwise products (fuses into elementwise FMAs)."""
    return jnp.sum(a[:, :, None, :] * b[None, :, :, :], axis=1)


def _mv_ll(a, v):
    """(i, j, B) @ (j, B) -> (i, B)."""
    return jnp.sum(a * v[None, :, :], axis=1)


def _t_ll(a):
    return jnp.swapaxes(a, 0, 1)


def _chol4_ll(A):
    """Unrolled Cholesky of (4, 4, B) SPD stacks."""
    eps = jnp.asarray(1e-30, A.dtype)
    l00 = jnp.sqrt(jnp.maximum(A[0, 0], eps))
    l10 = A[1, 0] / l00
    l20 = A[2, 0] / l00
    l30 = A[3, 0] / l00
    l11 = jnp.sqrt(jnp.maximum(A[1, 1] - l10 * l10, eps))
    l21 = (A[2, 1] - l20 * l10) / l11
    l31 = (A[3, 1] - l30 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(A[2, 2] - l20 * l20 - l21 * l21, eps))
    l32 = (A[3, 2] - l30 * l20 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(A[3, 3] - l30 * l30 - l31 * l31 - l32 * l32, eps))
    return (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33)


def spd_solve4_ll(A, Bm):
    """Solve A X = B with A (4, 4, B) SPD, B (4, k, B)."""
    (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33) = _chol4_ll(A)
    b0, b1, b2, b3 = Bm[0], Bm[1], Bm[2], Bm[3]     # (k, B)
    y0 = b0 / l00[None]
    y1 = (b1 - l10[None] * y0) / l11[None]
    y2 = (b2 - l20[None] * y0 - l21[None] * y1) / l22[None]
    y3 = (b3 - l30[None] * y0 - l31[None] * y1 - l32[None] * y2) / l33[None]
    x3 = y3 / l33[None]
    x2 = (y2 - l32[None] * x3) / l22[None]
    x1 = (y1 - l21[None] * x2 - l31[None] * x3) / l11[None]
    x0 = (y0 - l10[None] * x1 - l20[None] * x2 - l30[None] * x3) / l00[None]
    return jnp.stack([x0, x1, x2, x3], axis=0)


def chol4_solve_ll(f, Bm):
    """Forward/back substitution against packed factors f (10, B),
    B of shape (4, k, B)."""
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = (
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]
    )
    b0, b1, b2, b3 = Bm[0], Bm[1], Bm[2], Bm[3]
    y0 = b0 / l00[None]
    y1 = (b1 - l10[None] * y0) / l11[None]
    y2 = (b2 - l20[None] * y0 - l21[None] * y1) / l22[None]
    y3 = (b3 - l30[None] * y0 - l31[None] * y1 - l32[None] * y2) / l33[None]
    x3 = y3 / l33[None]
    x2 = (y2 - l32[None] * x3) / l22[None]
    x1 = (y1 - l21[None] * x2 - l31[None] * x3) / l11[None]
    x0 = (y0 - l10[None] * x1 - l20[None] * x2 - l30[None] * x3) / l00[None]
    return jnp.stack([x0, x1, x2, x3], axis=0)


def lqr_factor_ll(Q, R, S, A, B) -> LQRFactor:
    """Riccati factorization, lane-major (trailing batch axis Bn).

    Q (N,13,13,Bn)  R (N,4,4,Bn)  S (N,4,13,Bn)
    A (N-1,13,13,Bn)  B (N-1,13,4,Bn)
    """
    cRt = jnp.stack(_chol4_ll(R[-1]), axis=0)              # (10, Bn)
    RiS = chol4_solve_ll(cRt, S[-1])                       # (4, 13, Bn)
    P_term = Q[-1] - _mm_ll(_t_ll(S[-1]), RiS)

    def backward(P, inp):
        Qi, Ri, Si, Ai, Bi = inp
        AtP = _mm_ll(_t_ll(Ai), P)
        BtP = _mm_ll(_t_ll(Bi), P)
        Qh = Qi + _mm_ll(AtP, Ai)
        Rh = Ri + _mm_ll(BtP, Bi)
        Sh = Si + _mm_ll(BtP, Ai)
        fh = jnp.stack(_chol4_ll(Rh), axis=0)              # (10, Bn)
        K = -chol4_solve_ll(fh, Sh)                        # (4, 13, Bn)
        Pn = Qh + _mm_ll(_t_ll(Sh), K)
        Pn = 0.5 * (Pn + jnp.swapaxes(Pn, 0, 1))
        return Pn, (Pn, K, fh)

    inputs = (Q[:-1], R[:-1], S[:-1], A, B)
    _, (Ps, Ks, cRhs) = jax.lax.scan(backward, P_term, inputs, reverse=True)
    # ys of the reverse scan are input-ordered: Ps[i] = P at stage i.
    P_all = jnp.concatenate([Ps, P_term[None]], axis=0)    # (N, 13, 13, Bn)
    return LQRFactor(P=P_all, K=Ks, cRh=cRhs, RiS=RiS, cRt=cRt)


def lqr_solve_ll(fac: LQRFactor, A, B, c, qx, qu, dx0) -> LQRSolution:
    """Backsolve one RHS (qx, qu, c, dx0) against a stored factorization.

    The vector backward pass uses p_i = qxh_i + K_i^T quh_i (from
    K = -Rh^{-1} Sh, so Sh^T k = K^T quh) and the costates come from the
    value-function identity nu_i = P_i dxb_i + p_i.
    """
    Riqu = chol4_solve_ll(fac.cRt, qu[-1][:, None])[:, 0]
    p_term = qx[-1] - _mv_ll(_t_ll(fac.RiS), qu[-1])

    def backward(p, inp):
        P_next, Ki, cRhi, qxi, qui, Ai, Bi, ci = inp
        Pc = p + _mv_ll(P_next, ci)
        qxh = qxi + _mv_ll(_t_ll(Ai), Pc)
        quh = qui + _mv_ll(_t_ll(Bi), Pc)
        k = -chol4_solve_ll(cRhi, quh[:, None])[:, 0]
        pn = qxh + _mv_ll(_t_ll(Ki), quh)
        return pn, (pn, k)

    inputs = (fac.P[1:], fac.K, fac.cRh, qx[:-1], qu[:-1], A, B, c)
    p0, (ps, ks) = jax.lax.scan(backward, p_term, inputs, reverse=True)
    p_all = jnp.concatenate([ps, p_term[None]], axis=0)    # (N, 13, Bn)

    P0 = fac.P[0]
    Pxt = P0[:9, 9:]
    Ptt = P0[9:, 9:]
    rhs = -(p0[9:] + _mv_ll(jnp.swapaxes(Pxt, 0, 1), dx0))
    dtheta = spd_solve4_ll(Ptt, rhs[:, None])[:, 0]
    dxb0 = jnp.concatenate([dx0, dtheta], axis=0)

    def forward(dxb, inp):
        Ki, ki, Ai, Bi, ci = inp
        du = _mv_ll(Ki, dxb) + ki
        nxt = _mv_ll(Ai, dxb) + _mv_ll(Bi, du) + ci
        return nxt, (dxb, du)

    dxb_last, (dxbs, dus) = jax.lax.scan(forward, dxb0, (fac.K, ks, A, B, c))
    du_term = -(Riqu + _mv_ll(fac.RiS, dxb_last))
    dxb_all = jnp.concatenate([dxbs, dxb_last[None]], axis=0)
    du_all = jnp.concatenate([dus, du_term[None]], axis=0)

    # costates: nu_i = P_i dxb_i + p_i (value-function gradient)
    nu_all = jnp.sum(fac.P * dxb_all[:, None], axis=2) + p_all
    return LQRSolution(dxb=dxb_all, du=du_all, nu=nu_all, dtheta=dtheta)


def solve_lqr_batched(Q, R, S, qx, qu, A, B, c, dx0) -> LQRSolution:
    """Lane-major batched LQR solve (factor + one backsolve).

    Shapes (trailing batch Bn):
      Q (N,13,13,Bn)  R (N,4,4,Bn)  S (N,4,13,Bn)  qx (N,13,Bn)  qu (N,4,Bn)
      A (N-1,13,13,Bn)  B (N-1,13,4,Bn)  c (N-1,13,Bn)  dx0 (9,Bn)
    """
    fac = lqr_factor_ll(Q, R, S, A, B)
    return lqr_solve_ll(fac, A, B, c, qx, qu, dx0)


@solve_lqr.def_vmap
def _solve_lqr_vmap(axis_size, in_batched, Q, R, S, qx, qu, A, B, c, dx0):
    args = [Q, R, S, qx, qu, A, B, c, dx0]

    def to_ll(x, batched):
        if batched:
            return jnp.moveaxis(x, 0, -1)
        return jnp.broadcast_to(x[..., None], x.shape + (axis_size,))

    ll = [to_ll(x, b) for x, b in zip(args, in_batched)]
    sol = solve_lqr_batched(*ll)
    out = LQRSolution(*[jnp.moveaxis(f, -1, 0) for f in sol])
    return out, LQRSolution(dxb=True, du=True, nu=True, dtheta=True)
