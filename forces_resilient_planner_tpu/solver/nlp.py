"""NLP definition for the resilient-planner NMPC.

Stage variable layout (canonical FORCES-parity layout, setup.m:42-66):
    z = [u(4), u_prev(4), x(9)],  x = [p(3), v(3), rpy(3)]

Problem (matlab_code/mpc/*):
    min  sum_i  w_wp||p_i - ref_i||^2 + 12 w_wp (psi_i - psi_ref_i)^2
              + w_input ||u_i[0:3]/rate_max||^2
              + w_rate ||u_i - uprev_i||^2
              + [stage 0 only] 10 w_input ||uprev_0[0:3]||^2      (mpc_objective1.m:38-47)
              + w_vel ||v_i||^2                                   (final profile terminal,
                                                                   mpc_objectiveN_final.m:27)
    s.t. x_0 = xinit                                              (xinitidx: states only)
         x_{i+1} = RK2(x_i, u_i, f_ext),  uprev_{i+1} = u_i       (transit.m + model.E)
         lb <= z_i <= ub                                          (mpc_generator_normal.m:28-46)
         A_i p_i - btilde_i <= hu (=1e-5)                         (mpc_corridorconst.m)

The cost is an exact quadratic in z; the only nonlinearity is the dynamics
equality and that is where Gauss-Newton SQP/IPM linearization applies.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import ModelConfig, WeightConfig
from forces_resilient_planner_tpu.dynamics.quadrotor import rk2_step

_PREC = jax.lax.Precision.HIGHEST

# ---- index layout --------------------------------------------------------
IU = slice(0, 4)       # u
IUP = slice(4, 8)      # u_prev
IX = slice(8, 17)      # x
IPOS = slice(8, 11)
IVEL = slice(11, 14)
IRPY = slice(14, 17)
IYAW = 16

# x-bar (augmented state for the Riccati sweep) = [x(9), uprev(4)]
PERM_XBAR = np.array([8, 9, 10, 11, 12, 13, 14, 15, 16, 4, 5, 6, 7])
PERM_U = np.array([0, 1, 2, 3])
NXB = 13
NU = 4
NZ = 17


class StageWeights(NamedTuple):
    """Per-stage weight table (N, ...); unifies the normal/final profiles."""

    w_wp: jnp.ndarray        # (N,)
    w_input: jnp.ndarray     # (N,)
    w_rate: jnp.ndarray      # (N,)
    w_vel: jnp.ndarray       # (N,)  nonzero only on the final-profile terminal stage
    w_uprev0: jnp.ndarray    # (N,)  nonzero only on stage 0


class NLPParams(NamedTuple):
    """Everything that parameterizes one NMPC solve (the 2600-param analog)."""

    xinit: jnp.ndarray       # (9,)
    ref_pos: jnp.ndarray     # (N, 3)
    ref_yaw: jnp.ndarray     # (N,)
    f_ext: jnp.ndarray       # (3,)
    corridor_A: jnp.ndarray  # (N, nh, 3)
    corridor_b: jnp.ndarray  # (N, nh)  already tube-tightened
    weights: StageWeights


def make_stage_weights(
    cfg: WeightConfig, N: int, final: bool = False, dtype=jnp.float64
) -> StageWeights:
    """Build the per-stage weight table for one profile.

    Mirrors FORCESNormal::setParasNormal (forces_normal.cpp:36-52): stage
    weights everywhere, terminal stage overridden; final profile adds the
    braking term on the terminal stage.
    """
    if final:
        w_wp = np.full(N, cfg.w_final_stage_wp)
        w_in = np.full(N, cfg.w_final_stage_input)
        w_wp[-1] = cfg.w_final_terminal_wp
        w_in[-1] = cfg.w_final_terminal_input
        w_vel = np.zeros(N)
        w_vel[-1] = cfg.final_brake_factor * cfg.w_final_terminal_wp
    else:
        w_wp = np.full(N, cfg.w_stage_wp)
        w_in = np.full(N, cfg.w_stage_input)
        w_wp[-1] = cfg.w_terminal_wp
        w_in[-1] = cfg.w_terminal_input
        w_vel = np.zeros(N)
    w_rate = np.full(N, cfg.w_input_rate)
    w_uprev0 = np.zeros(N)
    w_uprev0[0] = cfg.stage1_uprev_factor * w_in[0]
    return StageWeights(
        w_wp=jnp.asarray(w_wp, dtype),
        w_input=jnp.asarray(w_in, dtype),
        w_rate=jnp.asarray(w_rate, dtype),
        w_vel=jnp.asarray(w_vel, dtype),
        w_uprev0=jnp.asarray(w_uprev0, dtype),
    )


def variable_bounds(cfg: ModelConfig, dtype=jnp.float64):
    """(lb, ub) of shape (17,), mpc_generator_normal.m:28-46."""
    rmax = cfg.max_rate
    tmin, tmax = cfg.min_thrust, cfg.max_thrust
    mx, my, mz = cfg.map_halfsize
    lb = np.array(
        [-rmax, -rmax, -rmax, tmin, -rmax, -rmax, -rmax, tmin,
         -mx, -my, 0.0,
         -cfg.max_vel, -cfg.max_vel, -cfg.max_vel,
         -cfg.max_tilt, -cfg.max_tilt, -cfg.max_yaw]
    )
    ub = np.array(
        [rmax, rmax, rmax, tmax, rmax, rmax, rmax, tmax,
         mx, my, mz,
         cfg.max_vel, cfg.max_vel, cfg.max_vel,
         cfg.max_tilt, cfg.max_tilt, cfg.max_yaw]
    )
    return jnp.asarray(lb, dtype), jnp.asarray(ub, dtype)


def stage_hessians(w: StageWeights, cfg: ModelConfig, dtype=jnp.float64) -> jnp.ndarray:
    """Constant per-stage cost Hessians H (N, 17, 17) (exact — cost is quadratic)."""
    N = w.w_wp.shape[0]
    rmax2 = cfg.max_rate ** 2

    def one(w_wp, w_in, w_rate, w_vel, w_up0):
        H = jnp.zeros((NZ, NZ), dtype)
        # position + yaw tracking
        H = H.at[8, 8].add(2 * w_wp)
        H = H.at[9, 9].add(2 * w_wp)
        H = H.at[10, 10].add(2 * w_wp)
        H = H.at[IYAW, IYAW].add(24 * w_wp)
        # velocity (final-profile terminal braking)
        for k in range(11, 14):
            H = H.at[k, k].add(2 * w_vel)
        # normalized input cost (rates only; thrust not penalized)
        for k in range(3):
            H = H.at[k, k].add(2 * w_in / rmax2)
        # input-rate cost ||u - uprev||^2 over all 4 components
        for k in range(4):
            H = H.at[k, k].add(2 * w_rate)
            H = H.at[4 + k, 4 + k].add(2 * w_rate)
            H = H.at[k, 4 + k].add(-2 * w_rate)
            H = H.at[4 + k, k].add(-2 * w_rate)
        # stage-0 uprev slack penalty (rates only, unnormalized)
        for k in range(4, 7):
            H = H.at[k, k].add(2 * w_up0)
        return H

    return jax.vmap(one)(w.w_wp, w.w_input, w.w_rate, w.w_vel, w.w_uprev0)


def cost_gradient(Z: jnp.ndarray, p: NLPParams, H: jnp.ndarray) -> jnp.ndarray:
    """grad f = H z + g_lin per stage.  Z: (N,17) -> (N,17)."""
    g_lin = jnp.zeros_like(Z)
    g_lin = g_lin.at[:, IPOS].set(-2.0 * p.weights.w_wp[:, None] * p.ref_pos)
    g_lin = g_lin.at[:, IYAW].set(-24.0 * p.weights.w_wp * p.ref_yaw)
    return jnp.einsum("nij,nj->ni", H, Z, precision=_PREC) + g_lin


def cost_value(Z: jnp.ndarray, p: NLPParams, H: jnp.ndarray) -> jnp.ndarray:
    g_lin = jnp.zeros_like(Z)
    g_lin = g_lin.at[:, IPOS].set(-2.0 * p.weights.w_wp[:, None] * p.ref_pos)
    g_lin = g_lin.at[:, IYAW].set(-24.0 * p.weights.w_wp * p.ref_yaw)
    quad = 0.5 * jnp.einsum("ni,nij,nj->", Z, H, Z, precision=_PREC)
    const = jnp.sum(p.weights.w_wp * jnp.sum(p.ref_pos**2, -1)) + jnp.sum(
        12.0 * p.weights.w_wp * p.ref_yaw**2
    )
    return quad + jnp.einsum("ni,ni->", g_lin, Z, precision=_PREC) + const


def dynamics_residuals(Z: jnp.ndarray, p: NLPParams, cfg: ModelConfig):
    """c_i = F(z_i) - E z_{i+1} for i = 0..N-2, F(z) = [RK2(x,u); u].  (N-1, 13)."""
    x = Z[:-1, IX]
    u = Z[:-1, IU]
    xn = jax.vmap(lambda xx, uu: rk2_step(xx, uu, p.f_ext, cfg))(x, u)
    F = jnp.concatenate([xn, u], axis=-1)
    Enext = jnp.concatenate([Z[1:, IX], Z[1:, IUP]], axis=-1)
    return F - Enext


def dynamics_jacobians(Z: jnp.ndarray, p: NLPParams, cfg: ModelConfig):
    """Per-stage RK2 Jacobians (Ax, Bx) for stages 0..N-2 (closed form).

    Ax: (N-1, 9, 9), Bx: (N-1, 9, 4).
    """
    from forces_resilient_planner_tpu.dynamics.quadrotor import (
        rk2_jacobians_analytic,
    )

    return rk2_jacobians_analytic(Z[:-1, IX], Z[:-1, IU], p.f_ext, cfg)


def inequality_residuals(Z: jnp.ndarray, p: NLPParams, lb, ub, hu: float):
    """All stage-separable inequality rows g(z) <= 0, shape (N, 64).

    Row order per stage: [lb - z (17), z - ub (17), A p - b - hu (30)].
    """
    g_lb = lb[None, :] - Z
    g_ub = Z - ub[None, :]
    pos = Z[:, IPOS]
    g_cor = (jnp.einsum("nkj,nj->nk", p.corridor_A, pos, precision=_PREC)
             - p.corridor_b - hu)
    return jnp.concatenate([g_lb, g_ub, g_cor], axis=-1)


def ineq_jac_T_times(p: NLPParams, v: jnp.ndarray) -> jnp.ndarray:
    """J_g^T v per stage without materializing J_g.  v: (N, 64) -> (N, 17)."""
    out = -v[:, 0:17] + v[:, 17:34]
    cor = jnp.einsum("nkj,nk->nj", p.corridor_A, v[:, 34:64],
                     precision=_PREC)
    return out.at[:, IPOS].add(cor)


def ineq_jac_times(p: NLPParams, dz: jnp.ndarray) -> jnp.ndarray:
    """J_g dz per stage.  dz: (N, 17) -> (N, 64)."""
    cor = jnp.einsum("nkj,nj->nk", p.corridor_A, dz[:, IPOS],
                     precision=_PREC)
    return jnp.concatenate([-dz, dz, cor], axis=-1)


def ineq_weighted_hessian(p: NLPParams, sigma: jnp.ndarray) -> jnp.ndarray:
    """J_g^T diag(sigma) J_g per stage.  sigma: (N, 64) -> (N, 17, 17).

    Written as eye-masked broadcasts and an unrolled 3x3 corridor block so
    every op is an elementwise reduce over the constraint axis (einsum/diag
    lower to slow gathers here).
    """
    N = sigma.shape[0]
    diag = sigma[:, 0:17] + sigma[:, 17:34]
    W = diag[:, :, None] * jnp.eye(NZ, dtype=sigma.dtype)[None]
    # corridor rows touch only the position block: sum_k A_kj s_k A_kl
    Acor = p.corridor_A  # (N, nh, 3)
    sc = sigma[:, 34:64]
    As = Acor * sc[:, :, None]
    rows = []
    for j in range(3):
        cols = [jnp.sum(As[:, :, j] * Acor[:, :, l], axis=1) for l in range(3)]
        rows.append(jnp.stack(cols, axis=-1))
    blk = jnp.stack(rows, axis=-2)  # (N, 3, 3)
    W = W.at[:, IPOS, IPOS].add(blk)
    return W
