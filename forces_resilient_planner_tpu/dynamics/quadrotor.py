"""9-state quadrotor dynamics with external force and rotor drag.

Array transcription of the reference model:
  - continuous dynamics: matlab_code/dynamics/nonlinear_dynamics.m:20-40
  - discretization:      matlab_code/dynamics/transit.m (FORCES RK2 = Heun's
    method, verified against the generated CasADi code
    solver/normal/FORCESNLPsolver_normal_casadi.c:238-470 — k1 = f(x,u),
    k2 = f(x + dt*k1, u), x+ = x + dt/2*(k1+k2))
  - analytic Jacobian cross-check target: plan_manage/src/nmpc_solver.cpp:615-699

State  x = [px py pz vx vy vz roll pitch yaw]
Input  u = [wx wy wz thrust]   (commanded body rates + collective thrust force)

All functions are pure, jit/vmap-friendly, and written for f32 accelerator compute
(f64-capable when jax_enable_x64 is on, used by the CPU oracle).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import ModelConfig

_PREC = jax.lax.Precision.HIGHEST


def euler_to_rot(rpy: jnp.ndarray) -> jnp.ndarray:
    """ZYX rotation R = Rz(yaw) @ Ry(pitch) @ Rx(roll).

    Matches nonlinear_dynamics.m:22-24 and nmpc_solver.cpp:554-564.
    rpy: (..., 3) -> (..., 3, 3)
    """
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    r00 = cy * cp
    r01 = cy * sp * sr - cr * sy
    r02 = cy * sp * cr + sy * sr
    r10 = cp * sy
    r11 = cy * cr + sy * sp * sr
    r12 = sy * sp * cr - cy * sr
    r20 = -sp
    r21 = cp * sr
    r22 = cp * cr
    rows = jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )
    return rows


def continuous_dynamics(
    x: jnp.ndarray, u: jnp.ndarray, f_ext: jnp.ndarray, cfg: ModelConfig
) -> jnp.ndarray:
    """xdot = f(x, u, f_ext).  nonlinear_dynamics.m:20-40."""
    vel = x[..., 3:6]
    rpy = x[..., 6:9]
    R = euler_to_rot(rpy)
    z_b = R[..., :, 2]
    thrust = u[..., 3]
    drag = jnp.asarray([cfg.drag_coeff, cfg.drag_coeff, 0.0], dtype=x.dtype)
    # drag_acc = R diag(d) R^T v
    v_body = jnp.einsum("...ji,...j->...i", R, vel, precision=_PREC)
    drag_acc = jnp.einsum("...ij,...j->...i", R, drag * v_body,
                          precision=_PREC)
    g_vec = jnp.zeros_like(vel).at[..., 2].set(cfg.g)
    acc = z_b * (thrust[..., None] / cfg.mass) + f_ext - g_vec - drag_acc
    euler_dot = u[..., 0:3]
    return jnp.concatenate([vel, acc, euler_dot], axis=-1)


def rk2_step(
    x: jnp.ndarray, u: jnp.ndarray, f_ext: jnp.ndarray, cfg: ModelConfig
) -> jnp.ndarray:
    """Heun RK2 discretization, exactly the FORCES client's RK2 (transit.m)."""
    k1 = continuous_dynamics(x, u, f_ext, cfg)
    k2 = continuous_dynamics(x + cfg.dt * k1, u, f_ext, cfg)
    return x + 0.5 * cfg.dt * (k1 + k2)


def ab_jacobians(
    x: jnp.ndarray, u: jnp.ndarray, f_ext: jnp.ndarray, cfg: ModelConfig
):
    """Discrete-time Jacobians (A, B) of rk2_step via forward-mode autodiff.

    Replaces the hand-derived updateMatrix (nmpc_solver.cpp:615-699); the
    continuous-time versions are exposed separately for the tube module.
    """
    A = jax.jacfwd(lambda xx: rk2_step(xx, u, f_ext, cfg))(x)
    B = jax.jacfwd(lambda uu: rk2_step(x, uu, f_ext, cfg))(u)
    return A, B


def continuous_jacobians(
    x: jnp.ndarray, u: jnp.ndarray, f_ext: jnp.ndarray, cfg: ModelConfig
):
    """Continuous-time (At, Bt) of xdot = f(x,u); used for Phi = At + Bt K."""
    At = jax.jacfwd(lambda xx: continuous_dynamics(xx, u, f_ext, cfg))(x)
    Bt = jax.jacfwd(lambda uu: continuous_dynamics(x, uu, f_ext, cfg))(u)
    return At, Bt


def _mm3(a, b):
    """Batched 3x3 matmul as broadcast-sum (VPU-friendly, no MXU padding)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _rot_factors(rpy):
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    z = jnp.zeros_like(cr)
    o = jnp.ones_like(cr)

    def m(rows):
        return jnp.stack(
            [jnp.stack(r, axis=-1) for r in rows], axis=-2
        )

    Rx = m([[o, z, z], [z, cr, -sr], [z, sr, cr]])
    dRx = m([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    Ry = m([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    dRy = m([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    Rz = m([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    dRz = m([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    return Rx, dRx, Ry, dRy, Rz, dRz


def continuous_jacobians_analytic(
    x: jnp.ndarray, u: jnp.ndarray, cfg: ModelConfig
):
    """Closed-form continuous-time Jacobians (Jc (...,9,9), Bc (...,9,4)).

    The batched analytic equivalent of the hand-derived updateMatrix
    (nmpc_solver.cpp:615-699); built from dR/d(angle) factor products so
    every op is elementwise over the batch (no autodiff tangent sweeps).
    """
    dtype = x.dtype
    rpy = x[..., 6:9]
    vel = x[..., 3:6]
    thrust = u[..., 3]
    Rx, dRx, Ry, dRy, Rz, dRz = _rot_factors(rpy)
    R = _mm3(Rz, _mm3(Ry, Rx))
    dR_r = _mm3(Rz, _mm3(Ry, dRx))
    dR_p = _mm3(Rz, _mm3(dRy, Rx))
    dR_y = _mm3(dRz, _mm3(Ry, Rx))

    D = jnp.asarray([cfg.drag_coeff, cfg.drag_coeff, 0.0], dtype)
    RD = R * D[..., None, :]                       # R @ diag(D)
    RDRt = _mm3(RD, jnp.swapaxes(R, -1, -2))
    Tm = (thrust / cfg.mass)[..., None]

    cols = []
    for dR in (dR_r, dR_p, dR_y):
        dRD = dR * D[..., None, :]
        dRDRt = _mm3(dRD, jnp.swapaxes(R, -1, -2)) + _mm3(
            RD, jnp.swapaxes(dR, -1, -2)
        )
        col = dR[..., :, 2] * Tm - jnp.sum(dRDRt * vel[..., None, :], axis=-1)
        cols.append(col)
    dv_drpy = jnp.stack(cols, axis=-1)             # (..., 3, 3)
    dv_dv = -RDRt

    shape = x.shape[:-1]
    Jc = jnp.zeros(shape + (9, 9), dtype)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), shape + (3, 3))
    Jc = Jc.at[..., 0:3, 3:6].set(eye3)
    Jc = Jc.at[..., 3:6, 3:6].set(dv_dv)
    Jc = Jc.at[..., 3:6, 6:9].set(dv_drpy)

    Bc = jnp.zeros(shape + (9, 4), dtype)
    Bc = Bc.at[..., 3:6, 3].set(R[..., :, 2] / cfg.mass)
    Bc = Bc.at[..., 6:9, 0:3].set(eye3)
    return Jc, Bc


def rk2_jacobians_analytic(
    x: jnp.ndarray, u: jnp.ndarray, f_ext: jnp.ndarray, cfg: ModelConfig
):
    """Discrete Heun-step Jacobians via the chain rule:
        A = I + dt/2 (J1 + J2 + dt J2 J1)
        B = dt/2 (B1 + B2 + dt J2 B1)
    with J,B the continuous Jacobians at x and at the Euler midpoint."""
    dt = cfg.dt
    k1 = continuous_dynamics(x, u, f_ext, cfg)
    x_mid = x + dt * k1
    J1, B1 = continuous_jacobians_analytic(x, u, cfg)
    J2, B2 = continuous_jacobians_analytic(x_mid, u, cfg)

    def mm9(a, b):
        return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)

    eye9 = jnp.eye(9, dtype=x.dtype)
    A = eye9 + 0.5 * dt * (J1 + J2 + dt * mm9(J2, J1))
    B = 0.5 * dt * (B1 + B2 + dt * mm9(J2, B1))
    return A, B


def thrust_world_acc(rpy: jnp.ndarray, thrust: jnp.ndarray, cfg: ModelConfig):
    """World-frame acceleration implied by attitude+thrust: R e3 T/m - g e3.

    Used for warm-start accel recovery (nmpc_solver.cpp:176-180) and the
    100 Hz command stream (nmpc_solver.cpp:925-931).
    """
    R = euler_to_rot(rpy)
    acc = R[..., :, 2] * (thrust[..., None] / cfg.mass)
    return acc - jnp.zeros_like(acc).at[..., 2].set(cfg.g)
