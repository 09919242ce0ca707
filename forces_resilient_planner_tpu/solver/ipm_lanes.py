"""Lane-major batched interior-point NMPC solver (the throughput path).

Same algorithm as solver/ipm.py::solve (single-loop primal-dual IPM with
Gauss-Newton stage Hessians and a Riccati KKT solve), restructured so the
scenario batch lives on the MINOR (lane) axis of every array: Z is
(N, 17, B), corridor rows are (N, nh, 3, B), multipliers (N, 64, B).

Why: `vmap(solve)` puts the batch on the LEADING axis, so every 17x17 /
13x13 stage operation works on tiny minor tiles that XLA pads to (8, 128)
— and the custom_vmap LQR routing has to transpose ~120 MB of QP blocks
to lane-major on every IPM iteration.  Here nothing is ever transposed in
the hot loop, and the partitioned QP blocks (Wp, Rp, Sp, q) are assembled
directly from the weight/sigma vectors without materializing the
(B, N, 17, 17) stage Hessian at all: the cost Hessian's fixed sparsity
(diag + u/u_prev rate coupling + corridor 3x3 position block) is written
out explicitly.

Numerical semantics are identical to vmap(ipm.solve) lane-by-lane (same
update formulas, same convergence masks, same barrier schedule); parity
is tested in tests/test_ipm_lanes.py at f64.

Reference anchors are those of solver/ipm.py (FORCES PDIP_NLP,
mpc_generator_normal.m:51-79; exit codes FORCESNLPsolver_normal.h:110-139).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import ModelConfig, SolverConfig
from forces_resilient_planner_tpu.dynamics.quadrotor import (
    rk2_jacobians_analytic,
    rk2_step,
)
from forces_resilient_planner_tpu.solver import nlp
from forces_resilient_planner_tpu.solver.ipm import SolveResult
from forces_resilient_planner_tpu.solver.nlp import NLPParams, NXB, NU, NZ
_PREC = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# lane-major NLP pieces (Z: (N, 17, B); see nlp.py for the scalar versions)
# ---------------------------------------------------------------------------

def _cost_gradient(Z, w: nlp.StageWeights, ref_pos, ref_yaw, rmax2):
    """grad f = H z + g_lin, written from the Hessian's sparsity.

    H structure (nlp.stage_hessians): pos/yaw/vel tracking diagonals, input
    cost on rates, rate cost coupling u and u_prev, stage-0 u_prev penalty.
    w_* are (N, B); ref_pos (N, 3, B); ref_yaw (N, B).
    """
    u, up = Z[:, 0:4], Z[:, 4:8]
    pos, vel, rpy = Z[:, 8:11], Z[:, 11:14], Z[:, 14:17]
    w_wp = w.w_wp[:, None]
    g_u = 2.0 * w.w_rate[:, None] * (u - up)
    g_u = g_u.at[:, 0:3].add(2.0 * (w.w_input[:, None] / rmax2) * u[:, 0:3])
    g_up = 2.0 * w.w_rate[:, None] * (up - u)
    g_up = g_up.at[:, 0:3].add(2.0 * w.w_uprev0[:, None] * up[:, 0:3])
    g_pos = 2.0 * w_wp * (pos - ref_pos)
    g_vel = 2.0 * w.w_vel[:, None] * vel
    g_rpy = jnp.zeros_like(rpy)
    g_rpy = g_rpy.at[:, 2].set(24.0 * w.w_wp * (Z[:, 16] - ref_yaw))
    return jnp.concatenate([g_u, g_up, g_pos, g_vel, g_rpy], axis=1)


def _habs_z_max(Z, w: nlp.StageWeights, rmax2):
    """max |H| |z| over stages/rows, per lane — the f32 stationarity
    precision floor used by ipm._kkt_error (sum of |H_ij| |z_j| per row)."""
    u, up = jnp.abs(Z[:, 0:4]), jnp.abs(Z[:, 4:8])
    pos, vel = jnp.abs(Z[:, 8:11]), jnp.abs(Z[:, 11:14])
    w_wp = jnp.abs(w.w_wp)[:, None]
    r_u = 2.0 * w.w_rate[:, None] * (u + up)
    r_u = r_u.at[:, 0:3].add(2.0 * (w.w_input[:, None] / rmax2) * u[:, 0:3])
    r_up = 2.0 * w.w_rate[:, None] * (up + u)
    r_up = r_up.at[:, 0:3].add(2.0 * w.w_uprev0[:, None] * up[:, 0:3])
    r_pos = 2.0 * w_wp * pos
    r_vel = 2.0 * jnp.abs(w.w_vel)[:, None] * vel
    r_yaw = 24.0 * w.w_wp * jnp.abs(Z[:, 16])
    rows = jnp.concatenate(
        [r_u, r_up, r_pos, r_vel, r_yaw[:, None]], axis=1
    )
    return jnp.max(rows, axis=(0, 1))


def _corridor_mv(A, x):
    """(N, nh, 3, B) @ (N, 3, B) -> (N, nh, B), unrolled over xyz."""
    return (
        A[:, :, 0] * x[:, None, 0]
        + A[:, :, 1] * x[:, None, 1]
        + A[:, :, 2] * x[:, None, 2]
    )


def _corridor_mtv(A, v):
    """(N, nh, 3, B)^T @ (N, nh, B) -> (N, 3, B)."""
    return jnp.stack(
        [jnp.sum(A[:, :, j] * v, axis=1) for j in range(3)], axis=1
    )


def _ineq_residuals(Z, A, b, lb, ub, hu):
    g_lb = lb[None, :, None] - Z
    g_ub = Z - ub[None, :, None]
    g_cor = _corridor_mv(A, Z[:, 8:11]) - b - hu
    return jnp.concatenate([g_lb, g_ub, g_cor], axis=1)     # (N, 64, B)


def _ineq_jac_T_times(A, v):
    out = -v[:, 0:17] + v[:, 17:34]
    return out.at[:, 8:11].add(_corridor_mtv(A, v[:, 34:]))


def _ineq_jac_times(A, dz):
    return jnp.concatenate(
        [-dz, dz, _corridor_mv(A, dz[:, 8:11])], axis=1
    )


def _eq_grad(Z, lam, Ax, Bx):
    """J_eq^T lam; Ax (N-1, 9, 9, B), Bx (N-1, 9, 4, B), lam (N, 13, B)."""
    lx, lu = lam[1:, :9], lam[1:, 9:]                        # (N-1, ., B)
    out = jnp.zeros_like(Z)
    BtL = jnp.einsum("nijb,nib->njb", Bx, lx, precision=_PREC)
    AtL = jnp.einsum("nijb,nib->njb", Ax, lx, precision=_PREC)
    out = out.at[:-1, 0:4].add(BtL + lu)
    out = out.at[:-1, 8:17].add(AtL)
    out = out.at[1:, 8:17].add(-lx)
    out = out.at[1:, 4:8].add(-lu)
    out = out.at[0, 8:17].add(lam[0, :9])
    return out


def _xbar_cat(vx, vt):
    """[x-part (N, 9, B), theta-part (N, 4, B)] -> (N, 13, B)."""
    return jnp.concatenate([vx, vt], axis=1)


def _assemble_qp_blocks(w: nlp.StageWeights, A, sigma, reg, rmax2, dtype):
    """Partitioned barrier-weighted stage Hessian, assembled directly:

      full W = H + J_g^T diag(sigma) J_g + reg*I over z = [u, u_prev, x];
      returned in Riccati partition xbar = [x(9), u_prev(4)], u(4):
        Wp (N,13,13,B), Rp (N,4,4,B), Sp (N,4,13,B).

    Bound rows contribute sigma to every diagonal; corridor rows a dense
    3x3 position block; H contributes tracking/vel/rate diagonals and the
    u <-> u_prev coupling (the only off-diagonal of H, landing in Sp).
    """
    N, _, _, B = A.shape
    sig_u = sigma[:, 0:4] + sigma[:, 17 + 0:17 + 4]
    sig_up = sigma[:, 4:8] + sigma[:, 17 + 4:17 + 8]
    sig_x = sigma[:, 8:17] + sigma[:, 17 + 8:17 + 17]
    sc = sigma[:, 34:]

    w_rate = w.w_rate[:, None]
    # --- Rp: u block ---
    r_diag = 2.0 * w_rate + sig_u + reg
    r_diag = r_diag.at[:, 0:3].add(2.0 * w.w_input[:, None] / rmax2)
    Rp = jnp.zeros((N, NU, NU, B), dtype)
    for k in range(NU):
        Rp = Rp.at[:, k, k].set(r_diag[:, k])

    # --- Wp: xbar block (x then u_prev) ---
    x_diag = sig_x + reg
    x_diag = x_diag.at[:, 0:3].add(2.0 * w.w_wp[:, None])
    x_diag = x_diag.at[:, 3:6].add(2.0 * w.w_vel[:, None])
    x_diag = x_diag.at[:, 8].add(24.0 * w.w_wp)
    up_diag = 2.0 * w_rate + sig_up + reg
    up_diag = up_diag.at[:, 0:3].add(2.0 * w.w_uprev0[:, None])
    Wp = jnp.zeros((N, NXB, NXB, B), dtype)
    for k in range(9):
        Wp = Wp.at[:, k, k].set(x_diag[:, k])
    for k in range(NU):
        Wp = Wp.at[:, 9 + k, 9 + k].set(up_diag[:, k])
    # corridor 3x3 position block: sum_k A_kj sc_k A_kl
    for j in range(3):
        Asj = A[:, :, j] * sc
        for l in range(j, 3):
            blk = jnp.sum(Asj * A[:, :, l], axis=1)
            Wp = Wp.at[:, j, l].add(blk)
            if l != j:
                Wp = Wp.at[:, l, j].add(blk)

    # --- Sp: u rows vs xbar cols; only H's rate coupling u_k <-> uprev_k ---
    Sp = jnp.zeros((N, NU, NXB, B), dtype)
    for k in range(NU):
        Sp = Sp.at[:, k, 9 + k].set(-2.0 * w_rate[:, 0])
    return Wp, Rp, Sp


def solve_lanes(
    Z0: jnp.ndarray,          # (N, 17, B) lane-major warm start
    params: NLPParams,        # lane-major fields, see lanes_params()
    mcfg: ModelConfig,
    scfg: SolverConfig,
) -> SolveResult:
    """Lane-major batched IPM.  Returns batch-LEADING SolveResult fields
    (Z (B, N, 17), ...) for drop-in compatibility with ipm.solve_batch."""
    st0 = _init_state(Z0, params, mcfg, scfg)
    st = _run_lanes(st0, params, mcfg, scfg, scfg.max_iters)
    return _state_to_result(st, params, mcfg, scfg)


def _init_state(Z0, params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig):
    """Initial IPM state tuple (all lane-major, trailing batch B)."""
    N, _, B = Z0.shape
    dtype = Z0.dtype
    lb, ub = nlp.variable_bounds(mcfg, dtype)
    hu = jnp.asarray(scfg.corridor_slack, dtype)
    margin = 1e-3
    Zc = jnp.clip(Z0, (lb + margin)[None, :, None], (ub - margin)[None, :, None])
    g0 = _ineq_residuals(Zc, params.corridor_A, params.corridor_b, lb, ub, hu)
    s0 = jnp.maximum(-g0, 1e-2)
    mu0 = jnp.full((B,), scfg.mu_init, dtype)
    mu_d0 = jnp.clip(mu0[None, None] / s0, 1e-6, 1e6)
    lam0 = jnp.zeros((N, NXB, B), dtype)
    return (
        Zc, lam0, s0, mu_d0, mu0,
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), bool),
        jnp.full((B,), jnp.inf, dtype),
    )


def _state_to_result(st, params: NLPParams, mcfg: ModelConfig,
                     scfg: SolverConfig) -> SolveResult:
    """Final state -> SolveResult with the exit-code taxonomy of the
    reference solver's return-code families (FORCESNLPsolver_normal.h:110-139):

        1   OPTIMAL       converged within tolerance
        0   MAXITREACHED  iteration budget exhausted, still progressing
       -6   BADFUNCEVAL   NaN/Inf encountered (the in-loop guard tripped;
                          the last finite iterate is returned)
       -7   NOPROGRESS    stopped with the final iterate still violating
                          the inequalities by more than scfg.infeas_tol —
                          the primal-infeasibility certificate (empty
                          tube-tightened corridors, contradictory bounds;
                          the IPM keeps feasible-problem iterates interior,
                          so a stuck violation means no feasible point was
                          reachable)

    Classification costs one inequality-residual evaluation at the final
    point (no Jacobians) — negligible against the ~15-iteration solve.
    Consumers that only need success keep testing `exit_code == 1`; the
    host FSM and the fleet ladder branch on -7 to replan immediately
    instead of burning the fail counter (nmpc_solver.cpp:397-429).
    """
    Z, lam, s, mu_d, _, it, done, err = st
    dtype = Z.dtype
    lb, ub = nlp.variable_bounds(mcfg, dtype)
    hu = jnp.asarray(scfg.corridor_slack, dtype)
    g = _ineq_residuals(Z, params.corridor_A, params.corridor_b, lb, ub, hu)
    violation = jnp.max(g, axis=(0, 1))                  # (B,)
    optimal = done & jnp.isfinite(err)
    bad = done & ~jnp.isfinite(err)
    stuck = violation > jnp.asarray(scfg.infeas_tol, dtype)
    exit_code = jnp.where(
        optimal, 1,
        jnp.where(stuck, -7, jnp.where(bad, -6, 0)),
    ).astype(jnp.int32)
    return SolveResult(
        Z=jnp.moveaxis(Z, -1, 0),
        lam=jnp.moveaxis(lam, -1, 0),
        s=jnp.moveaxis(s, -1, 0),
        mu_d=jnp.moveaxis(mu_d, -1, 0),
        exit_code=exit_code,
        iters=it,
        kkt_error=err,
    )


def _dyn_pieces(Z, f_ext_bl, mcfg: ModelConfig):
    """Equality residuals + RK2 Jacobians for a lane-major Z (N, 17, B),
    via the batch-leading dynamics module; only the small (9,9)/(9,4)
    tensors are transposed per iteration.  f_ext_bl: (B, 3)."""
    x_bl = jnp.moveaxis(Z[:-1, 8:17], 1, -1)             # (N-1, B, 9)
    u_bl = jnp.moveaxis(Z[:-1, 0:4], 1, -1)
    xn = rk2_step(x_bl, u_bl, f_ext_bl[None], mcfg)      # (N-1, B, 9)
    F = jnp.concatenate([jnp.moveaxis(xn, -1, 1), Z[:-1, 0:4]], axis=1)
    Enext = jnp.concatenate([Z[1:, 8:17], Z[1:, 4:8]], axis=1)
    c = F - Enext                                        # (N-1, 13, B)
    Ax, Bx = rk2_jacobians_analytic(x_bl, u_bl, f_ext_bl[None], mcfg)
    Ax = jnp.moveaxis(Ax, 1, -1)                         # (N-1, 9, 9, B)
    Bx = jnp.moveaxis(Bx, 1, -1)
    return c, Ax, Bx


def _run_lanes(st0, params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig,
               max_iters: int):
    """Run the lane-major IPM while_loop from an arbitrary state (resumable:
    the tiered solver continues compacted sub-batches from mid-solve state)."""
    N, _, B = st0[0].shape
    dtype = st0[0].dtype
    w = params.weights
    lb, ub = nlp.variable_bounds(mcfg, dtype)
    hu = jnp.asarray(scfg.corridor_slack, dtype)
    tol = jnp.asarray(
        max(scfg.tol_stat, scfg.tol_eq, scfg.tol_ineq, scfg.tol_comp), dtype
    )
    rmax2 = mcfg.max_rate ** 2
    Acor, bcor = params.corridor_A, params.corridor_b
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tol_ref = jnp.asarray(1e-4, dtype)

    f_ext_bl = params.f_ext.T                                # (B, 3)

    def dyn_pieces(Z):
        return _dyn_pieces(Z, f_ext_bl, mcfg)

    def kkt_error(Z, lam, s, mu_d, mu, grad_f, g, c, Ax, Bx):
        eq_g = _eq_grad(Z, lam, Ax, Bx)
        r_stat = grad_f + eq_g + _ineq_jac_T_times(Acor, mu_d)
        r_init = Z[0, 8:17] - params.xinit                   # (9, B)
        r_g = g + s
        r_c = s * mu_d - mu[None, None]
        s_max = 100.0
        m_all = (
            jnp.sum(jnp.abs(lam), axis=(0, 1))
            + jnp.sum(jnp.abs(mu_d), axis=(0, 1))
        ) / (N * NXB + N * 64)
        s_d = jnp.maximum(s_max, m_all) / s_max
        s_c = jnp.maximum(
            s_max, jnp.sum(jnp.abs(mu_d), axis=(0, 1)) / (N * 64)
        ) / s_max
        mag = (
            _habs_z_max(Z, w, rmax2)
            + jnp.max(jnp.abs(lam), axis=(0, 1))
            + jnp.max(jnp.abs(mu_d), axis=(0, 1))
        )
        stat_scale = jnp.maximum(1.0, 4.0 * eps * mag / tol_ref)
        stat = jnp.max(jnp.abs(r_stat), axis=(0, 1)) / (s_d * stat_scale)
        eq = jnp.maximum(
            jnp.max(jnp.abs(c), axis=(0, 1)), jnp.max(jnp.abs(r_init), axis=0)
        )
        ineq = jnp.max(jnp.abs(r_g), axis=(0, 1))
        comp = jnp.max(jnp.abs(r_c), axis=(0, 1)) / s_c
        comp0 = jnp.max(jnp.abs(s * mu_d), axis=(0, 1)) / s_c
        return stat, eq, ineq, comp, comp0

    def body(st):
        Z, lam, s, mu_d, mu, it, done, err = st
        grad_f = _cost_gradient(Z, w, params.ref_pos, params.ref_yaw, rmax2)
        g = _ineq_residuals(Z, Acor, bcor, lb, ub, hu)
        c, Ax, Bx = dyn_pieces(Z)
        stat, eq, ineq, comp, comp0 = kkt_error(
            Z, lam, s, mu_d, mu, grad_f, g, c, Ax, Bx
        )
        err0 = jnp.maximum(jnp.maximum(stat, eq), jnp.maximum(ineq, comp0))
        lane_done = err0 <= tol

        r_g = g + s
        sigma = mu_d / s
        dx0 = params.xinit - Z[0, 8:17]

        from forces_resilient_planner_tpu.solver import riccati

        # one factorization per iteration, replayed for every RHS
        Wp, Rp, Sp = _assemble_qp_blocks(
            w, Acor, sigma, jnp.asarray(scfg.reg, dtype), rmax2, dtype
        )
        Abar = jnp.zeros((N - 1, NXB, NXB, B), dtype)
        Abar = Abar.at[:, :9, :9].set(Ax)
        Bbar = jnp.zeros((N - 1, NXB, NU, B), dtype)
        Bbar = Bbar.at[:, :9, :].set(Bx)
        Bbar = Bbar.at[:, 9:, :].set(
            jnp.broadcast_to(
                jnp.eye(NU, dtype=dtype)[None, :, :, None],
                (N - 1, NU, NU, B),
            )
        )
        fac = riccati.lqr_factor_ll(Wp, Rp, Sp, Abar, Bbar)
        backsolve = lambda qx_, qu_: riccati.lqr_solve_ll(
            fac, Abar, Bbar, c, qx_, qu_, dx0
        )

        def direction(w_vec):
            q = grad_f + _ineq_jac_T_times(Acor, w_vec)
            dxb, du, nu, _ = backsolve(
                _xbar_cat(q[:, 8:17], q[:, 4:8]), q[:, 0:4]
            )
            dZ = jnp.concatenate([du, dxb[:, 9:], dxb[:, :9]], axis=1)
            ds = -r_g - _ineq_jac_times(Acor, dZ)
            return dZ, ds, nu

        tau = jnp.asarray(scfg.frac_to_boundary, dtype)

        def max_step(v, dv):
            ratio = jnp.where(
                dv < 0, -tau * v / jnp.minimum(dv, -1e-30), jnp.inf
            )
            return jnp.minimum(1.0, jnp.min(ratio, axis=(0, 1)))

        if scfg.predictor_corrector:
            # ---- Mehrotra predictor-corrector (see ipm.py) -----------------
            dZ_aff, ds_aff, _ = direction(sigma * r_g)
            dmu_aff = -mu_d - sigma * ds_aff
            a_p_aff = max_step(s, ds_aff)[None, None]
            a_d_aff = max_step(mu_d, dmu_aff)[None, None]
            m_ineq = N * s.shape[1]
            mu_avg = jnp.sum(s * mu_d, axis=(0, 1)) / m_ineq
            mu_aff = jnp.sum(
                (s + a_p_aff * ds_aff) * (mu_d + a_d_aff * dmu_aff),
                axis=(0, 1),
            ) / m_ineq
            sig_c = jnp.clip(
                (mu_aff / jnp.maximum(mu_avg, 1e-30)) ** 3,
                scfg.sigma_min, 1.0,
            )
            # tol/20 floor + monotone cap: see ipm.py
            mu_n = jnp.where(
                lane_done, mu,
                jnp.clip(sig_c * mu_avg, tol / 20.0, jnp.maximum(mu, tol)),
            )
            corr = (mu_n[None, None] - ds_aff * dmu_aff) / s
            dZ, ds, nu = direction(corr + sigma * r_g)
            mu_d_new_full = corr - sigma * ds
        else:
            if scfg.mu_gate:
                err_mu = jnp.maximum(
                    jnp.maximum(stat, eq), jnp.maximum(ineq, comp)
                )
                shrink = err_mu <= scfg.mu_gate_factor * mu
            else:
                shrink = jnp.ones_like(lane_done)
            mu_pow = (
                mu * jnp.sqrt(mu) if scfg.mu_superlin == 1.5
                else mu ** scfg.mu_superlin
            )
            mu_n = jnp.where(
                shrink & ~lane_done,
                jnp.maximum(
                    tol / 20.0, jnp.minimum(scfg.kappa_mu * mu, mu_pow)
                ),
                mu,
            )
            dZ, ds, nu = direction(mu_n[None, None] / s + sigma * r_g)
            mu_d_new_full = mu_n[None, None] / s - sigma * ds
        dmu = mu_d_new_full - mu_d

        lam_plus = nu
        lam0_row = jnp.concatenate(
            [-nu[0, :9], jnp.zeros((4, B), dtype)], axis=0
        )
        lam_plus = lam_plus.at[0].set(lam0_row)

        a_p = max_step(s, ds)[None, None]                    # (1, 1, B)
        a_d = max_step(mu_d, dmu)[None, None]

        Z_n = Z + a_p * dZ
        s_n = s + a_p * ds
        mu_d_n = mu_d + a_d * dmu
        lam_n = lam + a_d * (lam_plus - lam)

        bad = ~(
            jnp.isfinite(err0)
            & jnp.all(jnp.isfinite(Z_n), axis=(0, 1))
            & jnp.all(jnp.isfinite(s_n), axis=(0, 1))
        )
        keep = (lane_done | bad)[None, None]
        Z_n = jnp.where(keep, Z, Z_n)
        s_n = jnp.where(keep, s, s_n)
        mu_d_n = jnp.where(keep, mu_d, mu_d_n)
        lam_n = jnp.where(keep, lam, lam_n)
        err_out = jnp.where(bad & ~lane_done, jnp.asarray(jnp.inf, dtype), err0)
        done_out = lane_done | bad
        return (Z_n, lam_n, s_n, mu_d_n, mu_n, it + 1, done_out, err_out)

    def stepper(st):
        """One global step: lanes whose own cond is false keep their state
        (exact vmap(while_loop) semantics, lane by lane)."""
        Z, lam, s, mu_d, mu, it, done, err = st
        active = (~done) & (it < max_iters)                  # (B,)
        new = body(st)
        am = active[None, None]
        Z_o = jnp.where(am, new[0], Z)
        lam_o = jnp.where(am, new[1], lam)
        s_o = jnp.where(am, new[2], s)
        mu_d_o = jnp.where(am, new[3], mu_d)
        mu_o = jnp.where(active, new[4], mu)
        it_o = jnp.where(active, new[5], it)
        done_o = jnp.where(active, new[6], done)
        err_o = jnp.where(active, new[7], err)
        return (Z_o, lam_o, s_o, mu_d_o, mu_o, it_o, done_o, err_o)

    return jax.lax.while_loop(
        lambda st: jnp.any((~st[6]) & (st[5] < max_iters)),
        stepper,
        st0,
    )


def lanes_params(params: NLPParams) -> NLPParams:
    """Batch-leading NLPParams (B, ...) -> lane-major (... , B)."""
    mv = lambda a: jnp.moveaxis(a, 0, -1)
    return NLPParams(
        xinit=mv(params.xinit),
        ref_pos=mv(params.ref_pos),
        ref_yaw=mv(params.ref_yaw),
        f_ext=mv(params.f_ext),
        corridor_A=mv(params.corridor_A),
        corridor_b=mv(params.corridor_b),
        weights=jax.tree.map(mv, params.weights),
    )


def solve_batch_lanes(
    Z0: jnp.ndarray, params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig
) -> SolveResult:
    """Drop-in replacement for ipm.solve_batch (batch-leading in/out) that
    runs the lane-major path; the one-time layout moves are outside the
    IPM loop and cost ~2 of the ~20 iterations' worth of transposes the
    vmap path pays."""
    return solve_lanes(
        jnp.moveaxis(Z0, 0, -1), lanes_params(params), mcfg, scfg
    )


# ---------------------------------------------------------------------------
# tiered solve: full-batch phase + compacted tail phase
# ---------------------------------------------------------------------------
# The lockstep while_loop runs until the SLOWEST lane converges: on a 4096-
# scenario grid the mean is ~14 iterations but the max is ~21, so ~1/3 of
# the wall clock is spent stepping a batch where >90% of lanes are already
# masked off.  Tiering exploits the convergence histogram: run everyone for
# phase1 iterations, then gather the unconverged minority into a small
# sub-batch (fixed shape - still one jit, no host round-trip) and let only
# that sub-batch run the expensive tail iterations at a fraction of the
# per-iteration cost.

def _take_lanes(a, idx):
    """Gather lanes (the MINOR axis) via a leading-axis take: minor-dim
    gathers serialize on a vector unit, a transposed
    take does not."""
    if a.ndim == 1:
        return jnp.take(a, idx, axis=0)
    return jnp.moveaxis(jnp.take(jnp.moveaxis(a, -1, 0), idx, axis=0), 0, -1)


def _put_lanes(a, idx, sub):
    if a.ndim == 1:
        return a.at[idx].set(sub)
    al = jnp.moveaxis(a, -1, 0)
    al = al.at[idx].set(jnp.moveaxis(sub, -1, 0))
    return jnp.moveaxis(al, 0, -1)


def solve_lanes_tiered(
    Z0: jnp.ndarray,          # (N, 17, B) lane-major warm start
    params: NLPParams,        # lane-major
    mcfg: ModelConfig,
    scfg: SolverConfig,
    phase1_iters: int,
    tail_lanes: int,
) -> SolveResult:
    """Two-tier lane-major IPM.

    Lanes still unconverged after phase1_iters are compacted (stable
    argsort on the done mask, unconverged first) into a tail_lanes-wide
    sub-batch that resumes from its exact mid-solve state, so per-lane
    results are bit-identical to the single-phase solver whenever the
    unconverged count fits in tail_lanes.  If it overflows (a harder
    scenario distribution than the tail schedule was sized for), the
    overflowed lanes keep their mid-solve state and the full-batch
    safety-net phase below finishes them — results stay bit-identical to
    the single-phase solver at graceful (full-batch-rate) cost; when
    nothing overflows the net's while_loop condition is false on entry
    and it costs one predicate evaluation.
    """
    st = _run_lanes(
        _init_state(Z0, params, mcfg, scfg), params, mcfg, scfg, phase1_iters
    )
    done = st[6]
    order = jnp.argsort(done, stable=True)     # unconverged first
    idx = order[:tail_lanes]
    sub_st = tuple(_take_lanes(a, idx) for a in st)
    sub_params = jax.tree.map(lambda a: _take_lanes(a, idx), params)
    sub_st = _run_lanes(sub_st, sub_params, mcfg, scfg, scfg.max_iters)
    merged = tuple(
        _put_lanes(a, idx, b) for a, b in zip(st, sub_st)
    )
    merged = _run_lanes(merged, params, mcfg, scfg, scfg.max_iters)
    return _state_to_result(merged, params, mcfg, scfg)


def solve_lanes_multitier(
    Z0: jnp.ndarray,          # (N, 17, B) lane-major warm start
    params: NLPParams,        # lane-major
    mcfg: ModelConfig,
    scfg: SolverConfig,
    schedule,                 # ((iter_cap_0, tail_lanes_1), (iter_cap_1, tail_lanes_2), ...)
) -> SolveResult:
    """Multi-level tiered lane-major IPM.

    Generalizes solve_lanes_tiered: after running the full batch to
    schedule[0][0] total iterations, the unconverged minority is compacted
    into schedule[0][1] lanes and run to schedule[1][0] iterations, then
    compacted again into schedule[1][1] lanes, and so on; the last level
    runs to scfg.max_iters.  The convergence histogram's thin tail (a few
    percent of lanes past ~phase1+2 iterations) then costs a few percent
    of a full-batch iteration instead of 25%.  Same bit-exactness
    semantics as solve_lanes_tiered, level by level; lanes that overflow
    a level's tail capacity are finished by the final full-batch
    safety-net phase (free when nothing overflows — its while_loop
    condition is false on entry).
    """
    assert len(schedule) > 0, "multitier schedule must be non-empty"
    # clamp each level's cap so a schedule entry can never run lanes past
    # scfg.max_iters (the last level's implicit cap)
    schedule = tuple(
        (min(cap, scfg.max_iters), lanes) for cap, lanes in schedule
    )
    st = _run_lanes(
        _init_state(Z0, params, mcfg, scfg), params, mcfg, scfg,
        schedule[0][0],
    )

    def level(st, params, i):
        tail_lanes = schedule[i][1]
        done = st[6]
        order = jnp.argsort(done, stable=True)     # unconverged first
        idx = order[:tail_lanes]
        sub_st = tuple(_take_lanes(a, idx) for a in st)
        sub_params = jax.tree.map(lambda a: _take_lanes(a, idx), params)
        next_cap = (
            schedule[i + 1][0] if i + 1 < len(schedule) else scfg.max_iters
        )
        sub_st = _run_lanes(sub_st, sub_params, mcfg, scfg, next_cap)
        if i + 1 < len(schedule):
            sub_st = level(sub_st, sub_params, i + 1)
        return tuple(_put_lanes(a, idx, b) for a, b in zip(st, sub_st))

    merged = level(st, params, 0)
    merged = _run_lanes(merged, params, mcfg, scfg, scfg.max_iters)
    return _state_to_result(merged, params, mcfg, scfg)


def _round_lanes(B: int, frac: float) -> int:
    return min(B, max(128, int(round(B * frac / 128.0)) * 128))


def solve_batch_lanes_tiered(
    Z0: jnp.ndarray, params: NLPParams, mcfg: ModelConfig, scfg: SolverConfig
) -> SolveResult:
    """Batch-leading wrapper for the tiered solver.

    scfg.tiers, when non-empty, gives a multi-level ((iter_cap, frac), ...)
    schedule (frac = fraction of the FULL batch, rounded to 128 lanes);
    otherwise scfg.tier_phase1 / scfg.tier_frac select the two-phase solver
    (tier_phase1 <= 0 = single phase)."""
    B = Z0.shape[0]
    if scfg.tiers:
        schedule = tuple(
            (cap, _round_lanes(B, frac)) for cap, frac in scfg.tiers
        )
        return solve_lanes_multitier(
            jnp.moveaxis(Z0, 0, -1), lanes_params(params), mcfg, scfg,
            schedule,
        )
    if scfg.tier_phase1 <= 0:
        return solve_batch_lanes(Z0, params, mcfg, scfg)
    return solve_lanes_tiered(
        jnp.moveaxis(Z0, 0, -1), lanes_params(params), mcfg, scfg,
        scfg.tier_phase1, _round_lanes(B, scfg.tier_frac),
    )
