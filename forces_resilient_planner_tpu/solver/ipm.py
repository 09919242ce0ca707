"""Primal-dual interior-point NMPC solver (FORCES PDIP_NLP equivalent).

Single-loop nonlinear IPM: at each iteration the dynamics are linearized
(Gauss-Newton — the cost is exactly quadratic so this is the exact cost
Hessian), all stage-separable inequalities are absorbed into the stage
Hessian through the barrier term, and the resulting equality-constrained
QP is solved by Riccati recursion (solver/riccati.py).

Matches the NLP of the reference's generated solver
(FORCESNLPsolver_normal, maxit 200, tolerances 1e-4:
mpc_generator_normal.m:51-79).  Fixed-point-free jit semantics: a bounded
while_loop with convergence masking; exit code 1 = optimal, 0 = max-iter
(FORCESNLPsolver_normal.h:110-139).

Design notes:
  - every array op is stage-batched (N=20 leading axis) and vmap-able over
    scenarios; the only sequential dependency is the N-step Riccati scan.
  - f32 on the accelerator with HIGHEST matmul precision; f64 under jax_enable_x64 for
    the CPU oracle path.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import ModelConfig, SolverConfig
from forces_resilient_planner_tpu.solver import nlp
from forces_resilient_planner_tpu.solver.nlp import (
    NLPParams,
    NXB,
    NU,
    NZ,
    PERM_XBAR,
    PERM_U,
)
from forces_resilient_planner_tpu.solver.riccati import (
    lqr_factor,
    lqr_solve,
    solve_lqr,
)

_PREC = jax.lax.Precision.HIGHEST


class SolveResult(NamedTuple):
    Z: jnp.ndarray          # (N, 17) primal solution
    lam: jnp.ndarray        # (N, 13) equality multipliers (row 0 = init, rows 1.. = dynamics)
    s: jnp.ndarray          # (N, 64) slacks
    mu_d: jnp.ndarray       # (N, 64) inequality duals
    exit_code: jnp.ndarray  # 1 optimal / 0 max-iter / -6 NaN / -7 no-progress
    iters: jnp.ndarray
    kkt_error: jnp.ndarray  # final max KKT residual


class _State(NamedTuple):
    Z: jnp.ndarray
    lam: jnp.ndarray
    s: jnp.ndarray
    mu_d: jnp.ndarray
    mu: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray
    err: jnp.ndarray


def _eq_grad(Z, lam, params, cfg, jac=None):
    """J_eq^T lam accumulated per stage.  lam[0,:9] = init rows; lam[i+1] =
    dynamics-constraint-i rows (13)."""
    N = Z.shape[0]
    if jac is None:
        jac = nlp.dynamics_jacobians(Z, params, cfg)
    Ax, Bx = jac                                     # (N-1,9,9), (N-1,9,4)
    lam_dyn = lam[1:]                                # (N-1, 13)
    lx, lu = lam_dyn[:, :9], lam_dyn[:, 9:]
    out = jnp.zeros_like(Z)
    # d/dz_i  of lam_i^T (F(z_i) - E z_{i+1}):
    out = out.at[:-1, nlp.IU].add(
        jnp.einsum("nij,ni->nj", Bx, lx, precision=_PREC) + lu
    )
    out = out.at[:-1, nlp.IX].add(
        jnp.einsum("nij,ni->nj", Ax, lx, precision=_PREC)
    )
    # d/dz_{i+1}: -E^T lam_i
    out = out.at[1:, nlp.IX].add(-lx)
    out = out.at[1:, nlp.IUP].add(-lu)
    # init constraint rows on stage-0 states
    out = out.at[0, nlp.IX].add(lam[0, :9])
    return out, Ax, Bx


def _kkt_error(Z, lam, s, mu_d, params, cfg, H, lb, ub, hu, mu, jac=None,
               c=None, g=None, grad_f=None):
    """Scaled KKT residuals (IPOPT-style s_d/s_c scaling, which is also what
    FORCES' tolerances are measured against): stationarity and
    complementarity are divided by a multiplier-magnitude scale so the test
    is meaningful at f32 precision with O(100) gradients.  Pre-computed
    linearization pieces can be passed in to avoid re-evaluation."""
    if grad_f is None:
        grad_f = nlp.cost_gradient(Z, params, H)
    eq_g, _, _ = _eq_grad(Z, lam, params, cfg, jac=jac)
    ineq_g = nlp.ineq_jac_T_times(params, mu_d)
    r_stat = grad_f + eq_g + ineq_g
    if c is None:
        c = nlp.dynamics_residuals(Z, params, cfg)
    r_init = Z[0, nlp.IX] - params.xinit
    if g is None:
        g = nlp.inequality_residuals(Z, params, lb, ub, hu)
    r_g = g + s
    r_c = s * mu_d - mu
    s_max = 100.0
    m_all = (jnp.sum(jnp.abs(lam)) + jnp.sum(jnp.abs(mu_d))) / (
        lam.size + mu_d.size
    )
    s_d = jnp.maximum(s_max, m_all) / s_max
    s_c = jnp.maximum(s_max, jnp.sum(jnp.abs(mu_d)) / mu_d.size) / s_max
    # dtype-aware precision floor: the stationarity residual is a cancelling
    # sum of O(|grad f|) terms, so it cannot be measured below
    # ~eps * magnitude.  In f64 the floor is irrelevant; in f32 it admits
    # the achievable optimum (control parity stays ~1e-4, see tests).
    eps = jnp.asarray(jnp.finfo(Z.dtype).eps, Z.dtype)
    # pre-cancellation term magnitudes: |H||z| (the rate-cost terms are
    # O(w_rate * thrust) ~ 1e3 and cancel in the sum), plus multiplier sizes
    habs = jnp.einsum("nij,nj->ni", jnp.abs(H), jnp.abs(Z), precision=_PREC)
    mag = (
        jnp.max(habs)
        + jnp.max(jnp.abs(lam))
        + jnp.max(jnp.abs(mu_d))
    )
    tol_ref = jnp.asarray(1e-4, Z.dtype)
    stat_scale = jnp.maximum(1.0, 4.0 * eps * mag / tol_ref)
    stat = jnp.max(jnp.abs(r_stat)) / (s_d * stat_scale)
    eq = jnp.maximum(jnp.max(jnp.abs(c)), jnp.max(jnp.abs(r_init)))
    ineq = jnp.max(jnp.abs(r_g))
    comp = jnp.max(jnp.abs(r_c)) / s_c
    return stat, eq, ineq, comp


def solve(
    Z0: jnp.ndarray,
    params: NLPParams,
    mcfg: ModelConfig,
    scfg: SolverConfig,
    init_duals=None,
) -> SolveResult:
    """Solve one NMPC NLP.  Z0: (N, 17) warm start.

    init_duals: optional (lam (N,13), s (N,64), mu_d (N,64), mu scalar)
    dual-state warm start (receding-horizon shifting experiments,
    tools/dual_warmstart_experiment.py).  None (default) keeps the cold
    initialization — the traced program is unchanged, so cached
    executables stay valid."""
    N = Z0.shape[0]
    dtype = Z0.dtype
    H = nlp.stage_hessians(params.weights, mcfg, dtype)
    lb, ub = nlp.variable_bounds(mcfg, dtype)
    hu = jnp.asarray(scfg.corridor_slack, dtype)
    tol = jnp.asarray(
        max(scfg.tol_stat, scfg.tol_eq, scfg.tol_ineq, scfg.tol_comp), dtype
    )

    # clip warm start strictly inside the box so initial slacks are positive
    margin = 1e-3
    Zc = jnp.clip(Z0, lb + margin, ub - margin)

    g0 = nlp.inequality_residuals(Zc, params, lb, ub, hu)
    if init_duals is None:
        s0 = jnp.maximum(-g0, 1e-2)
        mu0 = jnp.asarray(scfg.mu_init, dtype)
        mu_d0 = jnp.clip(mu0 / s0, 1e-6, 1e6)
        lam0 = jnp.zeros((N, NXB), dtype)
    else:
        lam_i, s_i, mud_i, mu_i = init_duals
        s0 = jnp.maximum(jnp.asarray(s_i, dtype), 1e-6)
        mu_d0 = jnp.clip(jnp.asarray(mud_i, dtype), 1e-8, 1e8)
        mu0 = jnp.asarray(mu_i, dtype)
        lam0 = jnp.asarray(lam_i, dtype)

    def body(st: _State) -> _State:
        Z, lam, s, mu_d, mu = st.Z, st.lam, st.s, st.mu_d, st.mu

        # ---- linearize ONCE at the current point --------------------------
        grad_f = nlp.cost_gradient(Z, params, H)
        g = nlp.inequality_residuals(Z, params, lb, ub, hu)
        c = nlp.dynamics_residuals(Z, params, mcfg)            # (N-1,13)
        Ax, Bx = nlp.dynamics_jacobians(Z, params, mcfg)

        # ---- convergence check at the current point -----------------------
        stat, eq, ineq, comp = _kkt_error(
            Z, lam, s, mu_d, params, mcfg, H, lb, ub, hu, mu,
            jac=(Ax, Bx), c=c, g=g, grad_f=grad_f,
        )
        s_c0 = jnp.maximum(100.0, jnp.sum(jnp.abs(mu_d)) / mu_d.size) / 100.0
        comp0 = jnp.max(jnp.abs(s * mu_d)) / s_c0
        err0 = jnp.max(jnp.stack([stat, eq, ineq, comp0]))
        done = err0 <= tol

        r_g = g + s
        sigma = mu_d / s
        # stage Hessian with barrier weighting + primal regularization
        W = H + nlp.ineq_weighted_hessian(params, sigma)
        W = W + scfg.reg * jnp.eye(NZ, dtype=dtype)[None]

        # partition to (xbar, u) with static slices (gathers on minor
        # dims serialize; concatenated slices stay vectorized)
        Wxx = W[:, 8:17, 8:17]
        Wxp = W[:, 8:17, 4:8]
        Wpx = W[:, 4:8, 8:17]
        Wpp = W[:, 4:8, 4:8]
        Wp = jnp.concatenate(
            [
                jnp.concatenate([Wxx, Wxp], axis=-1),
                jnp.concatenate([Wpx, Wpp], axis=-1),
            ],
            axis=-2,
        )                                                      # (N,13,13) Q
        Rp = W[:, 0:4, 0:4]                                    # (N,4,4)   R
        Sp = jnp.concatenate(
            [W[:, 0:4, 8:17], W[:, 0:4, 4:8]], axis=-1
        )                                                      # (N,4,13)  S

        # dynamics linearization (reuse the jacobians computed above)
        Abar = jnp.zeros((N - 1, NXB, NXB), dtype)
        Abar = Abar.at[:, :9, :9].set(Ax)
        Bbar = jnp.zeros((N - 1, NXB, NU), dtype)
        Bbar = Bbar.at[:, :9, :].set(Bx)
        Bbar = Bbar.at[:, 9:, :].set(jnp.eye(NU, dtype=dtype)[None])
        dx0 = params.xinit - Z[0, nlp.IX]

        # fraction-to-boundary
        tau = jnp.asarray(scfg.frac_to_boundary, dtype)

        def max_step(v, dv):
            ratio = jnp.where(dv < 0, -tau * v / jnp.minimum(dv, -1e-30), jnp.inf)
            return jnp.minimum(1.0, jnp.min(ratio))

        def direction(w_vec, fac):
            """One backsolve: reduced QP gradient from the complementarity
            target vector w_vec (lambda^+ substitution eliminates s, mu_d)."""
            q = grad_f + nlp.ineq_jac_T_times(params, w_vec)
            qx = jnp.concatenate([q[:, 8:17], q[:, 4:8]], axis=-1)
            qu = q[:, 0:4]
            sol = lqr_solve(fac, Abar, Bbar, c, qx, qu, dx0)
            dZ = jnp.zeros_like(Z)
            dZ = dZ.at[:, nlp.IX].set(sol.dxb[:, :9])
            dZ = dZ.at[:, nlp.IUP].set(sol.dxb[:, 9:])
            dZ = dZ.at[:, nlp.IU].set(sol.du)
            ds = -r_g - nlp.ineq_jac_times(params, dZ)
            return sol, dZ, ds

        fac = lqr_factor(Wp, Rp, Sp, Abar, Bbar)

        if scfg.predictor_corrector:
            # ---- Mehrotra predictor-corrector (FORCES PDIP-style) ---------
            # predictor: pure affine scaling (mu = 0, no corrector term)
            _, dZ_aff, ds_aff = direction(sigma * r_g, fac)
            dmu_aff = -mu_d - sigma * ds_aff
            a_p_aff = max_step(s, ds_aff)
            a_d_aff = max_step(mu_d, dmu_aff)
            m_ineq = s.size
            mu_avg = jnp.sum(s * mu_d) / m_ineq
            mu_aff = jnp.sum(
                (s + a_p_aff * ds_aff) * (mu_d + a_d_aff * dmu_aff)
            ) / m_ineq
            sig_c = jnp.clip(
                (mu_aff / jnp.maximum(mu_avg, 1e-30)) ** 3,
                scfg.sigma_min, 1.0,
            )
            # floors: (a) tol/20 — unfloored Mehrotra collapses slacks to
            # ~1e-20 while the nonlinear eq residual is still converging and
            # the barrier terms overflow; (b) monotone cap at the previous
            # mu — adaptive centering is allowed to slow down but never to
            # re-inflate the barrier (tames the convergence tail).
            mu = jnp.where(
                done, mu,
                jnp.clip(sig_c * mu_avg, tol / 20.0, jnp.maximum(mu, tol)),
            )
            # corrector: centering + second-order term ds_aff * dmu_aff
            corr = (mu - ds_aff * dmu_aff) / s
            sol, dZ, ds = direction(corr + sigma * r_g, fac)
            mu_d_new_full = corr - sigma * ds
        else:
            # ---- monotone Fiacco-McCormick barrier schedule ----------------
            if scfg.mu_gate:
                err_mu = jnp.max(jnp.stack([stat, eq, ineq, comp]))
                shrink = err_mu <= scfg.mu_gate_factor * mu
            else:
                shrink = jnp.asarray(True)   # ungated geometric schedule
            # 1.5 exponent as mu*sqrt(mu), as in the lane-major solver
            # (ipm_lanes.py): general pow lowers through exp/log
            mu_pow = (
                mu * jnp.sqrt(mu) if scfg.mu_superlin == 1.5
                else mu ** scfg.mu_superlin
            )
            mu = jnp.where(
                shrink & ~done,
                jnp.maximum(
                    tol / 20.0, jnp.minimum(scfg.kappa_mu * mu, mu_pow)
                ),
                mu,
            )
            sol, dZ, ds = direction(mu / s + sigma * r_g, fac)
            mu_d_new_full = mu / s - sigma * ds
        dmu = mu_d_new_full - mu_d

        # new equality multipliers from costates: dynamics rows are +nu_{i+1};
        # the init-constraint multiplier is -nu_0 (x part; theta rows unused)
        lam_plus = sol.nu                                       # (N, 13)
        lam0_row = jnp.concatenate(
            [-sol.nu[0, :9], jnp.zeros((4,), dtype)]
        )
        lam_plus = lam_plus.at[0].set(lam0_row)

        a_p = max_step(s, ds)
        a_d = max_step(mu_d, dmu)

        Z_n = Z + a_p * dZ
        s_n = s + a_p * ds
        mu_d_n = mu_d + a_d * dmu
        lam_n = lam + a_d * (lam_plus - lam)

        # if already converged (or the step went bad), keep the checked point
        bad = ~(
            jnp.isfinite(err0)
            & jnp.all(jnp.isfinite(Z_n))
            & jnp.all(jnp.isfinite(s_n))
        )
        keep = done | bad
        Z_n = jnp.where(keep, Z, Z_n)
        s_n = jnp.where(keep, s, s_n)
        mu_d_n = jnp.where(keep, mu_d, mu_d_n)
        lam_n = jnp.where(keep, lam, lam_n)
        err_out = jnp.where(bad & ~done, jnp.asarray(jnp.inf, dtype), err0)
        done_out = done | bad

        return _State(
            Z=Z_n, lam=lam_n, s=s_n, mu_d=mu_d_n, mu=mu,
            it=st.it + 1, done=done_out, err=err_out,
        )

    def cond(st: _State):
        return (~st.done) & (st.it < scfg.max_iters)

    init_err = jnp.asarray(jnp.inf, dtype)
    st = _State(
        Z=Zc, lam=lam0, s=s0, mu_d=mu_d0, mu=mu0,
        it=jnp.asarray(0, jnp.int32), done=jnp.asarray(False), err=init_err,
    )
    st = jax.lax.while_loop(cond, body, st)

    # exit-code taxonomy (reference code families,
    # FORCESNLPsolver_normal.h:110-139): 1 OPTIMAL / 0 MAXITREACHED /
    # -6 BADFUNCEVAL (NaN guard) / -7 NOPROGRESS (final iterate still
    # violating the inequalities beyond scfg.infeas_tol = primal-
    # infeasibility certificate).  See ipm_lanes._state_to_result.
    g_end = nlp.inequality_residuals(st.Z, params, lb, ub, hu)
    violation = jnp.max(g_end)
    optimal = st.done & jnp.isfinite(st.err)
    bad = st.done & ~jnp.isfinite(st.err)
    stuck = violation > jnp.asarray(scfg.infeas_tol, dtype)
    exit_code = jnp.where(
        optimal, 1, jnp.where(stuck, -7, jnp.where(bad, -6, 0))
    ).astype(jnp.int32)
    return SolveResult(
        Z=st.Z, lam=st.lam, s=st.s, mu_d=st.mu_d,
        exit_code=exit_code, iters=st.it, kkt_error=st.err,
    )


solve_batch = jax.vmap(solve, in_axes=(0, 0, None, None))
