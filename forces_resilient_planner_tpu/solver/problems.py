"""Problem-construction helpers: warm starts and simple corridor setups.

Mirrors the host-side parameter packing of forces_normal.cpp:55-140 /
NMPCSolver::initMPCOutput (nmpc_solver.cpp:265-286).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import ModelConfig, WeightConfig
from forces_resilient_planner_tpu.dynamics.quadrotor import rk2_step
from forces_resilient_planner_tpu.solver.nlp import (
    NLPParams,
    NZ,
    StageWeights,
    make_stage_weights,
)


def hover_warm_start(
    state: jnp.ndarray, cfg: ModelConfig, thrust_seed: float | None = None,
    dtype=None,
) -> jnp.ndarray:
    """Hover-seeded Z0 (N, 17): zero rates, hover-ish thrust, state replicated.

    Mirrors initMPCOutput's real_thrust_c_=7.3 seed (nmpc_solver.cpp:265-286).
    """
    dtype = dtype or state.dtype
    t = cfg.hover_thrust if thrust_seed is None else thrust_seed
    row = jnp.concatenate(
        [
            jnp.asarray([0.0, 0.0, 0.0, t, 0.0, 0.0, 0.0, t], dtype),
            state.astype(dtype),
        ]
    )
    return jnp.tile(row[None, :], (cfg.N, 1))


def lqr_warm_start_batch(
    x0: jnp.ndarray,          # (B, 9)
    ref_pos: jnp.ndarray,     # (B, N, 3)
    ref_yaw: jnp.ndarray,     # (B, N)
    f_ext: jnp.ndarray,       # (B, 3)
    mcfg: ModelConfig,
    K: jnp.ndarray,           # (4, 9) fixed feedback gain (nmpc_solver.cpp:28-31)
) -> jnp.ndarray:
    """LQR-rollout warm start (B, N, 17): close the loop with the reference's
    fixed gain and roll the true RK2 dynamics toward the reference.

    The reference warm-starts FORCES from the previous MPC solution
    (forces_normal.cpp:74-97) and falls back to a hover seed only on the
    first solve / after failures (nmpc_solver.cpp:265-286).  One-shot sweep
    solves have no previous solution; this rollout provides the analog: a
    dynamically consistent primal trajectory tracking the reference with
    u = u_hover + K (x - x_ref), clipped to the input bounds, integrated
    with the same rk2_step the NLP's equality constraints use — so the
    equality residuals of the warm start are ~0 and the IPM starts from a
    near-feasible point instead of a hovering one.
    """
    dtype = x0.dtype
    u_lb = jnp.asarray(
        [-mcfg.max_rate, -mcfg.max_rate, -mcfg.max_rate, mcfg.min_thrust],
        dtype,
    )
    u_ub = jnp.asarray(
        [mcfg.max_rate, mcfg.max_rate, mcfg.max_rate, mcfg.max_thrust], dtype
    )
    margin = 1e-2
    u_hover = jnp.asarray([0.0, 0.0, 0.0, mcfg.hover_thrust], dtype)
    Kt = K.astype(dtype).T                                   # (9, 4)
    # saturate the tracking error BEFORE the gain so the rollout inputs stay
    # interior to the bounds: an input-saturated warm start parks many IPM
    # slacks at the boundary and measurably SLOWS convergence (see
    # tools/warmstart_experiment.py)
    e_sat = jnp.asarray([0.7, 0.7, 0.7, 1.5, 1.5, 1.5, 0.3, 0.3, 0.3], dtype)

    refs = jnp.concatenate(
        [ref_pos, ref_yaw[..., None]], axis=-1
    ).swapaxes(0, 1)                                         # (N, B, 4)

    def step(x, ref_k):                                      # x (B, 9)
        xref = jnp.zeros_like(x)
        xref = xref.at[:, 0:3].set(ref_k[:, 0:3])
        xref = xref.at[:, 8].set(ref_k[:, 3])
        err = jnp.clip(x - xref, -e_sat, e_sat)
        u = u_hover[None] + jnp.matmul(
            err, Kt, precision=jax.lax.Precision.HIGHEST)
        u = jnp.clip(u, u_lb + margin, u_ub - margin)
        xn = rk2_step(x, u, f_ext, mcfg)
        return xn, (u, x)

    _, (u, xs) = jax.lax.scan(step, x0, refs)                # (N, B, .)
    uprev = jnp.concatenate([u[0:1], u[:-1]], axis=0)
    Z = jnp.concatenate([u, uprev, xs], axis=-1)             # (N, B, 17)
    return Z.swapaxes(0, 1)


def box_corridor(
    center: np.ndarray, half: np.ndarray, N: int, nh: int = 30, dtype=np.float64
):
    """Axis-aligned box corridor, identical at every stage.  Returns (A, b)."""
    A = np.zeros((nh, 3), dtype)
    b = np.zeros((nh,), dtype)
    eye = np.eye(3)
    for k in range(3):
        A[2 * k] = eye[k]
        b[2 * k] = center[k] + half[k]
        A[2 * k + 1] = -eye[k]
        b[2 * k + 1] = -(center[k] - half[k])
    return (
        jnp.asarray(np.tile(A[None], (N, 1, 1))),
        jnp.asarray(np.tile(b[None], (N, 1))),
    )


def hover_to_goal_params(
    x0: np.ndarray,
    goal: np.ndarray,
    mcfg: ModelConfig,
    wcfg: WeightConfig,
    f_ext=(0.0, 0.0, 0.0),
    corridor_center=None,
    corridor_half=(5.0, 5.0, 2.0),
    final: bool = False,
    dtype=jnp.float64,
) -> NLPParams:
    """BASELINE config-1 style problem: constant goal reference, box corridor."""
    N = mcfg.N
    ref_pos = jnp.tile(jnp.asarray(goal, dtype)[None], (N, 1))
    dirv = np.asarray(goal[:2]) - np.asarray(x0[:2])
    yaw = float(np.arctan2(dirv[1], dirv[0])) if np.linalg.norm(dirv) > 1e-6 else 0.0
    ref_yaw = jnp.full((N,), yaw, dtype)
    center = (
        np.asarray(corridor_center)
        if corridor_center is not None
        else 0.5 * (np.asarray(x0[:3]) + np.asarray(goal))
    )
    A, b = box_corridor(center, np.asarray(corridor_half), N)
    return NLPParams(
        xinit=jnp.asarray(x0, dtype),
        ref_pos=ref_pos,
        ref_yaw=ref_yaw,
        f_ext=jnp.asarray(f_ext, dtype),
        corridor_A=A.astype(dtype),
        corridor_b=b.astype(dtype),
        weights=make_stage_weights(wcfg, N, final=final, dtype=dtype),
    )
