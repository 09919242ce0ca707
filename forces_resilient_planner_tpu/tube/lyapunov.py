"""Disturbance-tube propagation: forward reachable ellipsoids.

Batched equivalent of NMPCSolver::getDistrEllipsoid + setFORCESParams
(plan_manage/src/nmpc_solver.cpp:484-611):

  - closed-loop Phi = At + Bt K with the fixed feedback gain K
    (nmpc_solver.cpp:28-31, 696); At/Bt are the continuous-time Jacobians
    (hand-derived in updateMatrix 615-699, here via autodiff).
  - per disturbance channel i:  Nt = t w_i^2 D_i D_i^T,
    W = Nt - e^{-Phi t} Nt e^{-Phi^T t},  solve  Phi X + X Phi^T = W.
    The reference solves this with complex Schur + Sylvester
    (Eigen::matrix_function_solve_triangular_sylvester, line 595); at 9x9 a
    batched Kronecker solve (81x81) is the array-shaped formulation — one
    batched LU instead of an unbatchable Schur iteration.
  - channel combination and stage recursion use the trace-normalized
    Minkowski-sum approximation Q = (1+1/beta) Q1 + (1+beta) Q2 with
    beta = sqrt(tr Q1 / tr Q2)  (nmpc_solver.cpp:507-509, 601-603).

Faithfulness note: the reference's `temp` accumulator is declared
uninitialized (nmpc_solver.cpp:573, UB in C++); we implement the intended
semantics temp = 0.  The shadowed inner `X` (line 596) is likewise treated
as the intended per-channel solution.

Structure: everything per-stage-independent (Phi, expm, Lyapunov
solves, Qd) is computed batched with vmap; only the cheap 9x9 Minkowski
recursion over the horizon runs in a lax.scan.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import ModelConfig, TubeConfig
from forces_resilient_planner_tpu.dynamics.quadrotor import (
    continuous_jacobians,
    euler_to_rot,
)
from forces_resilient_planner_tpu.ops.expm import expm_fixed

_PREC = jax.lax.Precision.HIGHEST

NX = 9


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def lyapunov_solve(Phi: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """Solve Phi X + X Phi^T = W for X via the Kronecker-vectorized system.

    (I (x) Phi + Phi (x) I) vec(X) = vec(W) with column-major vec; using
    row-major flatten the operator becomes kron(Phi, I) + kron(I, Phi).

    General-W reference implementation (kept as the oracle for tests).
    The tube path uses the Gramian forms below: a batched 81x81 LU per
    stage and channel does not scale with the batch.
    """
    n = Phi.shape[-1]
    I = jnp.eye(n, dtype=Phi.dtype)
    Kmat = jnp.kron(Phi, I) + jnp.kron(I, Phi)
    x = jnp.linalg.solve(Kmat, W.reshape(-1))
    return x.reshape(n, n)


def lyapunov_gramian(Phi: jnp.ndarray, C: jnp.ndarray, t: float) -> jnp.ndarray:
    """X = int_0^t e^{-Phi s} C e^{-Phi^T s} ds — the UNIQUE solution of
    Phi X + X Phi^T = C - e^{-Phi t} C e^{-Phi^T t} (differentiate the
    integral), i.e. exactly the getDistrEllipsoid Lyapunov problem
    (nmpc_solver.cpp:567-611) without forming the right-hand side.

    Computed with Van Loan's block-exponential identity:
      expm([[ -Phi, C ], [ 0, Phi^T ]] t) = [[ ., F12 ], [ 0, F22 ]]
      F12 = X e^{Phi^T t},  F22 = e^{Phi^T t}  =>  X = F12 F22^{-1}.
    One 18x18 expm + one 9x9 solve per (stage, channel): VMEM-trivial,
    fully batchable, and PSD by construction (the Kronecker route can
    return small asymmetries at f32).
    """
    n = Phi.shape[-1]
    Z = jnp.zeros_like(Phi)
    H = jnp.concatenate(
        [
            jnp.concatenate([-Phi, C], axis=-1),
            jnp.concatenate([Z, Phi.T], axis=-1),
        ],
        axis=-2,
    )
    # expm_fixed (ops/expm.py): straight-line Pade-13 + masked squaring —
    # jax.scipy's expm evaluates all five Pade branches under vmap, which
    # dominated the batched tube phase on-chip
    F = expm_fixed(H * t)
    F12, F22 = F[:n, n:], F[n:, n:]
    # X = F12 @ inv(F22): solve F22^T X^T = F12^T (9x9)
    return jnp.linalg.solve(F22.T, F12.T).T


def taylor_n_terms(dtype) -> int:
    """Dtype-matched Taylor length for the scaled-norm<=0.5 Gramian series.

    Measured truncation vs the 12-term f64 reference on tube-regime Phi
    (256 closed-loop linearization points, round 5): 7 terms -> X rel
    6.5e-10 / Mp abs 4.4e-10 (below f32 eps 1.2e-7); 12 terms reaches
    f64.  The f32 path drops ~25 of ~92 9x9 matmuls per stage by not
    paying for precision f32 cannot represent.  Valid while
    norm1(Phi t) <= 8 (the 4-doubling budget): tests/test_tube.py pins
    that bound at the solver's box corners."""
    return 7 if dtype == jnp.float32 else 12


def gramian_channels(Phi: jnp.ndarray, t: float, w_bound: jnp.ndarray,
                     n_terms: int | None = None, max_doublings: int = 4):
    """All three disturbance-channel Gramians + e^{Phi t}, matmul-only.

    Computes X_i = t w_i^2 * int_0^t e^{-Phi s} e_i e_i^T e^{-Phi^T s} ds
    for the velocity channels i in {3,4,5} (Dt_, nmpc_solver.cpp:24-26) and
    Mp = e^{Phi t}, using ONLY batched 9x9 matmuls:

      - series: with G_0 = e_i e_i^T, H_{m+1} = -(Phi u H_m + (Phi u H_m)^T)
        / (m+1),  X(u) = u * sum_m H_m / (m+1)   (symmetry of H_m halves
        the matmuls; truncation ~0.5^(n+1)/(n+1)! at the scaled norm)
      - scaling/doubling: u = t / 2^s with per-matrix s from the 1-norm;
        X(2u) = X(u) + M_u X(u) M_u^T,  M_{2u} = M_u^2 (exact identities),
        applied max_doublings times under per-lane masks (shape-static).

    Rationale: the 18x18 Van Loan route (lyapunov_gramian) pays a batched
    LU solve per channel; batched small-matrix LU is slow next to the
    matmul work itself.  This form has no solve at all.

    Returns (X (..., 3, 9, 9) channel-ordered, Mp (..., 9, 9)).
    """
    dtype = Phi.dtype
    if n_terms is None:
        n_terms = taylor_n_terms(dtype)
    Pt = Phi * t
    norm1 = jnp.max(jnp.sum(jnp.abs(Pt), axis=-2), axis=-1)
    s = jnp.ceil(jnp.log2(jnp.maximum(norm1 / 0.5, 1.0)))
    s = jnp.clip(jnp.nan_to_num(s, nan=0.0), 0, max_doublings)
    u_scale = (0.5**s).astype(dtype)
    Pu = Pt * u_scale[..., None, None]

    # Mm = e^{-Pu}, Mp = e^{+Pu}: shared Horner on the power series
    I = jnp.broadcast_to(jnp.eye(NX, dtype=dtype), Phi.shape)
    Mm = I
    Mp = I
    for m in range(n_terms, 0, -1):
        Mm = I - _mm(Pu, Mm) / m
        Mp = I + _mm(Pu, Mp) / m

    # channel series at scaled time, all channels stacked on a leading axis
    e = jnp.eye(NX, dtype=dtype)[3:6]                       # (3, 9)
    G = e[..., :, None] * e[..., None, :]                   # (3, 9, 9)
    G = jnp.broadcast_to(G, Phi.shape[:-2] + (3, NX, NX))
    Pu3 = Pu[..., None, :, :]
    H = G
    X = G
    for m in range(1, n_terms + 1):
        PH = _mm(Pu3, H)
        H = -(PH + jnp.swapaxes(PH, -1, -2)) / m
        X = X + H / (m + 1)
    X = X * (t * u_scale)[..., None, None, None]

    # doublings (masked, fixed trip count)
    for k in range(max_doublings):
        live = (s > k)[..., None, None]
        MX = _mm(Mm[..., None, :, :], X)
        X = jnp.where(
            live[..., None, :, :],
            X + _mm(MX, jnp.swapaxes(Mm, -1, -2)[..., None, :, :]),
            X,
        )
        Mm = jnp.where(live, _mm(Mm, Mm), Mm)
        Mp = jnp.where(live, _mm(Mp, Mp), Mp)

    # Nt = t * w_i^2 * e_i e_i^T (channel_Qd): fold in the t w^2 factor
    X = X * (t * w_bound**2)[..., :, None, None]
    return X, Mp


def channel_Qd_fast(Phi: jnp.ndarray, t: float, w_bound: jnp.ndarray):
    """channel_Qd + e^{Phi t} via the matmul-only Gramian path.

    Same combine rule as channel_Qd (trace-normalized sum); returns
    (Qd, Mp) so the caller reuses the exponential for the Q2 recursion.
    """
    X, Mp = gramian_channels(Phi, t, w_bound)
    trX = jnp.sqrt(
        jnp.clip(jnp.trace(X, axis1=-2, axis2=-1), 1e-30, None)
    )
    Qd = jnp.sum(trX, axis=-1)[..., None, None] * jnp.sum(
        X / trX[..., None, None], axis=-3
    )
    return Qd, Mp


def sqrtm_psd_db(Q: jnp.ndarray, iters: int = 12) -> jnp.ndarray:
    """3x3 PSD square root via scaled Denman-Beavers iteration.

    Closed-form 3x3 inverses (corridor.decomp.inv3) instead of eigh: a
    batched symmetric eigensolver is slow at (20480, 3, 3), while the DB
    iteration is elementwise math.
    Determinant-scaled DB converges quadratically; `iters` covers the
    ego-ellipsoid conditioning (r^2/h^2 ~ 40) to f64 accuracy.
    """
    from forces_resilient_planner_tpu.corridor.decomp import inv3

    dtype = Q.dtype
    n = Q.shape[-1]
    # regularize: Q may be numerically semidefinite
    tr = jnp.trace(Q, axis1=-2, axis2=-1)[..., None, None]
    eps = 1e-12 * tr + 1e-30
    Y = Q + eps * jnp.eye(n, dtype=dtype)
    Z = jnp.broadcast_to(jnp.eye(n, dtype=dtype), Q.shape)
    for _ in range(iters):
        # determinant scaling: g = |det(Y) det(Z)|^(-1/(2n))
        dY = jnp.linalg.det(Y)
        dZ = jnp.linalg.det(Z)
        g = jnp.abs(dY * dZ) ** (-1.0 / (2 * n))
        g = jnp.nan_to_num(g, nan=1.0, posinf=1.0, neginf=1.0)[..., None, None]
        Yn = 0.5 * (g * Y + inv3(g * Z))
        Z = 0.5 * (g * Z + inv3(g * Y))
        Y = Yn
    return 0.5 * (Y + jnp.swapaxes(Y, -1, -2))


def minkowski_sum(Q1: jnp.ndarray, Q2: jnp.ndarray) -> jnp.ndarray:
    """Trace-normalized outer approximation of the Minkowski sum of two
    ellipsoids given by shape matrices (nmpc_solver.cpp:507-509)."""
    beta = jnp.sqrt(jnp.trace(Q1, axis1=-2, axis2=-1) / jnp.trace(Q2, axis1=-2, axis2=-1))
    beta = beta[..., None, None]
    return (1.0 + 1.0 / beta) * Q1 + (1.0 + beta) * Q2


def sqrtm_psd(Q: jnp.ndarray) -> jnp.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition.

    Replaces the general EigenSolver sqrt (nmpc_solver.cpp:512-513); Q is
    symmetric by construction so eigh is exact and batchable.
    """
    w, V = jnp.linalg.eigh(Q)
    w = jnp.clip(w, 0.0, None)
    return jnp.einsum("...ij,...j,...kj->...ik", V, jnp.sqrt(w), V, precision=_PREC)


def closed_loop_phi(
    x: jnp.ndarray, u: jnp.ndarray, K: jnp.ndarray, cfg: ModelConfig
) -> jnp.ndarray:
    """Phi = At + Bt K at one linearization point (nmpc_solver.cpp:696)."""
    f0 = jnp.zeros(3, dtype=x.dtype)
    At, Bt = continuous_jacobians(x, u, f0, cfg)
    return At + _mm(Bt, K.astype(x.dtype))


def channel_Qd(
    Phi: jnp.ndarray, t: float, w_bound: jnp.ndarray, dtype=None
) -> jnp.ndarray:
    """Combined disturbance ellipsoid Qd for one stage (all 3 channels).

    Channels enter through D = [e_x e_y e_z] on the velocity rows
    (Dt_, nmpc_solver.cpp:24-26).
    """
    dtype = dtype or Phi.dtype

    def one_channel(i):
        d = jnp.zeros((NX,), dtype).at[3 + i].set(1.0)
        Nt = t * w_bound[i] ** 2 * jnp.outer(d, d)
        # Gramian form: solves Phi X + X Phi^T = Nt - e^{-Phi t} Nt e^{-Phi^T t}
        # without materializing the 81x81 Kronecker operator (see
        # lyapunov_gramian; identical X, batch-scalable)
        X = lyapunov_gramian(Phi, Nt, t)
        trX = jnp.sqrt(jnp.clip(jnp.trace(X), 1e-30, None))
        return trX, X / trX

    trs, Xn = jax.vmap(one_channel)(jnp.arange(3))
    return jnp.sum(trs) * jnp.sum(Xn, axis=0)


class TubeResult(NamedTuple):
    E: jnp.ndarray        # (N, 3, 3) stage uncertainty ellipsoid sqrt matrices
    Q2: jnp.ndarray       # (N, 3, 3) propagated disturbance position ellipsoids
    Phi: jnp.ndarray      # (N, 9, 9) closed-loop matrices (diagnostics)


def propagate_tubes(
    Z_prev: jnp.ndarray,
    mcfg: ModelConfig,
    tcfg: TubeConfig,
    K: jnp.ndarray,
) -> TubeResult:
    """Per-stage uncertainty ellipsoids E_i for corridor tightening.

    Z_prev: (N, 17) previous MPC solution (predicted euler/vel/thrust per
    stage are the linearization points, nmpc_solver.cpp:497-501).

    Stage recursion (setFORCESParams, nmpc_solver.cpp:490-520):
      Q1_i = R_i ego_size R_i^T
      Q_i  = Q1_0                      (i = 0)
           = mink(Q1_i, Q2pos_{i-1})   (i > 0)
      E_i  = sqrt(Q_i)
      [Qd_i from channels]  Qu_i = mink(Qinit_{i}, Qd_i)
      Q2pos_i = (e^{Phi_i t} Qu_i e^{Phi_i^T t})[0:3, 0:3]
      Qinit_{i+1} = Qu_i,   Qinit_0 = eps^2 I
    """
    dtype = Z_prev.dtype
    t = mcfg.dt
    N = Z_prev.shape[0]
    x_stages = Z_prev[:, 8:17]
    u_stages = Z_prev[:, 0:4]
    rpy = Z_prev[:, 14:17]
    w_bound = jnp.full((3,), tcfg.ext_noise_bound, dtype)

    Phi = jax.vmap(lambda x, u: closed_loop_phi(x, u, jnp.asarray(K), mcfg))(
        x_stages, u_stages
    )
    # stage-independent heavy lifting, fully batched.  channel_Qd_fast is
    # the matmul-only Gramian-doubling path (no batched LU anywhere) and
    # returns e^{Phi t} as a byproduct; parity vs the Van Loan oracle
    # (channel_Qd) is tested in tests/test_tube.py
    Qd, expm_pos = channel_Qd_fast(Phi, t, w_bound)

    R = euler_to_rot(rpy)
    ego = jnp.diag(
        jnp.asarray([tcfg.ego_r**2, tcfg.ego_r**2, tcfg.ego_h**2], dtype)
    )
    Q1 = jnp.einsum("nij,jk,nlk->nil", R, ego, R, precision=_PREC)

    Q_init0 = (tcfg.epsilon**2) * jnp.eye(NX, dtype=dtype)

    def scan_body(carry, inp):
        Q_init = carry
        Qd_i, Em_i = inp
        Qu = minkowski_sum(Q_init, Qd_i)
        Q2pos = _mm(_mm(Em_i, Qu), Em_i.T)[0:3, 0:3]
        return Qu, Q2pos

    _, Q2pos = jax.lax.scan(scan_body, Q_init0, (Qd, expm_pos))

    # combine with the ego ellipsoid: stage 0 uses Q1 only, stage i uses the
    # disturbance ellipsoid computed at stage i-1
    Qcomb = jnp.concatenate(
        [Q1[0][None], minkowski_sum(Q1[1:], Q2pos[:-1])], axis=0
    )
    E = sqrtm_psd_db(Qcomb)
    return TubeResult(E=E, Q2=Q2pos, Phi=Phi)


def propagate_tubes_batch(
    Z_prev: jnp.ndarray,      # (B, N, 17)
    mcfg: ModelConfig,
    tcfg: TubeConfig,
    K: jnp.ndarray | None = None,
) -> TubeResult:
    """Batched propagate_tubes: the per-stage math (Jacobians, channel
    Gramians, e^{Phi t}, ego ellipsoid) runs over the flattened (B*N)
    stage lanes; only the O(N) Minkowski recursion and the DB sqrt run per
    stage.  Same formulas as propagate_tubes (parity tested in
    tests/test_tube.py).  K = None uses the config gain tcfg.K."""
    B, N = Z_prev.shape[0], Z_prev.shape[1]
    dtype = Z_prev.dtype
    t = mcfg.dt
    L = B * N
    x = Z_prev[..., 8:17].reshape(L, NX)
    u = Z_prev[..., 0:4].reshape(L, 4)

    Kj = jnp.asarray(tcfg.K if K is None else K, dtype)
    w_bound = jnp.full((3,), tcfg.ext_noise_bound, dtype)
    Phi = jax.vmap(lambda xi, ui: closed_loop_phi(xi, ui, Kj, mcfg))(x, u)
    Qd, expm_pos = channel_Qd_fast(Phi, t, w_bound)
    R = euler_to_rot(x[:, 6:9])
    ego = jnp.diag(
        jnp.asarray([tcfg.ego_r**2, tcfg.ego_r**2, tcfg.ego_h**2], dtype)
    )
    Q1 = jnp.einsum("nij,jk,nlk->nil", R, ego, R, precision=_PREC)

    Qd = Qd.reshape(B, N, NX, NX)
    expm_pos = expm_pos.reshape(B, N, NX, NX)
    Phi = Phi.reshape(B, N, NX, NX)
    Q1 = Q1.reshape(B, N, 3, 3)

    Q_init0 = (tcfg.epsilon**2) * jnp.eye(NX, dtype=dtype)

    def scan_body(Q_init, inp):
        Qd_i, Em_i = inp
        Qu = minkowski_sum(Q_init, Qd_i)
        Q2pos = jnp.einsum(
            "bij,bjk,blk->bil", Em_i, Qu, Em_i, precision=_PREC
        )[:, 0:3, 0:3]
        return Qu, Q2pos

    _, Q2pos = jax.lax.scan(
        scan_body,
        jnp.broadcast_to(Q_init0, (B, NX, NX)),
        (jnp.moveaxis(Qd, 1, 0), jnp.moveaxis(expm_pos, 1, 0)),
        unroll=N,  # 20 rolled steps = 20 kernel launches of small matmuls
    )
    Q2pos = jnp.moveaxis(Q2pos, 0, 1)                     # (B, N, 3, 3)

    Qcomb = jnp.concatenate(
        [Q1[:, 0][:, None], minkowski_sum(Q1[:, 1:], Q2pos[:, :-1])], axis=1
    )
    E = sqrtm_psd_db(Qcomb)
    return TubeResult(E=E, Q2=Q2pos, Phi=Phi)


def tighten_corridor(
    A: jnp.ndarray, b: jnp.ndarray, E: jnp.ndarray
) -> jnp.ndarray:
    """btilde_j = b_j - ||E a_j^T||  (forces_normal.cpp:111-136).

    A: (..., nh, 3), b: (..., nh), E: (..., 3, 3) -> (..., nh).
    Zero (padding) rows are left untouched (||E*0|| = 0).
    """
    Ea = jnp.einsum("...ij,...kj->...ki", E, A, precision=_PREC)
    return b - jnp.linalg.norm(Ea, axis=-1)
