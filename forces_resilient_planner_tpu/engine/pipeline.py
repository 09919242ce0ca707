"""The 20 Hz NMPC master step: references -> tubes -> corridors -> solve.

Pure-functional, fully jitted equivalent of NMPCSolver::solveNMPC +
setFORCESParams + getSikangConst (nmpc_solver.cpp:288-551), vmap-able over
scenarios.  The host FSM (engine/fsm.py) interprets the returned flags.

Corridor strategy (batched re-design of getSikangConst, nmpc_solver.cpp:288-332):
the reference walks stages sequentially, decomposing a fresh polytope only
when the previous stage's polytope (inflated by the stage ellipsoid) no
longer contains the reference point.  A stage's fresh decomposition depends
only on (ref_i, yaw_i, obstacles), so we compute all N candidate
decompositions batched, then replay the sequential reuse rule as a cheap
gather scan — identical selected constraints, no data-dependent shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import PlannerConfig
from forces_resilient_planner_tpu.corridor.decomp import decompose_segment
from forces_resilient_planner_tpu.engine.reference import (
    ReferenceResult,
    sample_references,
    wrap_yaw_outputs,
)
from forces_resilient_planner_tpu.solver import ipm, nlp
from forces_resilient_planner_tpu.tube.lyapunov import (
    propagate_tubes,
    tighten_corridor,
)

_PREC = jax.lax.Precision.HIGHEST


class NMPCStepResult(NamedTuple):
    mpc_output: jnp.ndarray   # (N+1, 17) updated deque (row N = row N-1)
    exit_code: jnp.ndarray    # solver exit (1 optimal / 0 maxit / -6 NaN
    #                           / -7 no-progress, ipm_lanes._state_to_result)
    iters: jnp.ndarray
    kkt_error: jnp.ndarray
    ref: ReferenceResult
    corridor_A: jnp.ndarray   # (N, nh, 3) selected (untightened) corridors
    corridor_b: jnp.ndarray   # (N, nh)
    corridor_b_tight: jnp.ndarray
    tube_E: jnp.ndarray       # (N, 3, 3)
    # decision flags for the FSM (solveNMPC return-code logic, lines 435-481)
    reach_local_end: jnp.ndarray
    switch_to_final: jnp.ndarray
    diverged: jnp.ndarray
    goal_reached: jnp.ndarray
    ref_jump_replan: jnp.ndarray


def corridor_seed2(ref: ReferenceResult, cfg: PlannerConfig) -> jnp.ndarray:
    """Second seed point 10 cm along the reference yaw
    (nmpc_solver.cpp:317-319).  Works on (..., N, 3)/(..., N) refs."""
    return jnp.stack(
        [
            ref.ref_pos[..., 0] + cfg.corridor.seed_len * jnp.cos(ref.ref_yaw),
            ref.ref_pos[..., 1] + cfg.corridor.seed_len * jnp.sin(ref.ref_yaw),
            ref.ref_pos[..., 2],
        ],
        axis=-1,
    )


def reuse_select(
    A_all: jnp.ndarray,   # (N, nh, 3)
    b_all: jnp.ndarray,   # (N, nh)
    tube_E: jnp.ndarray,  # (N, 3, 3)
    ref_pos: jnp.ndarray, # (N, 3)
    cfg: PlannerConfig,
):
    """Sequential corridor reuse rule as a gather scan: keep the previous
    stage's polytope while the inflated ellipsoid-tightened containment
    test passes (getSikangConst, nmpc_solver.cpp:293-311)."""
    infl = cfg.tube.reuse_inflation

    def reuse_step(prev_idx, inp):
        i, E_i, ref_i = inp
        A_prev = A_all[prev_idx]
        b_prev = b_all[prev_idx]
        Ea = jnp.einsum("ij,kj->ki", E_i, A_prev, precision=_PREC)
        margin = (
            jnp.einsum("kj,j->k", A_prev, ref_i, precision=_PREC)
            - (b_prev - infl * jnp.linalg.norm(Ea, axis=-1))
        )
        row_valid = jnp.linalg.norm(A_prev, axis=-1) > 1e-12
        contained = jnp.all(jnp.where(row_valid, margin <= 0, True))
        # stage 0 always decomposes fresh (poly list starts empty, line 290)
        fresh = (i == 0) | (~contained)
        idx = jnp.where(fresh, i, prev_idx)
        return idx, idx

    N = ref_pos.shape[0]
    # unrolled for the same reason as the reference yaw LPF: 20 rolled
    # steps of tiny gathers cost ~20 kernel launches per batched call
    _, sel = jax.lax.scan(
        reuse_step, jnp.asarray(0), (jnp.arange(N), tube_E, ref_pos),
        unroll=N,
    )
    return A_all[sel], b_all[sel], sel


def decompose_stages(
    p1: jnp.ndarray,             # (N, 3)
    p2: jnp.ndarray,             # (N, 3)
    obstacles: jnp.ndarray,
    obstacle_mask: jnp.ndarray,
    cfg: PlannerConfig,
):
    """Fresh decomposition of every stage's seed segment -> (A, b) of
    shapes (N, nh, 3), (N, nh)."""
    dec = jax.vmap(
        lambda a, b: decompose_segment(
            a, b, obstacles, obstacle_mask, cfg.corridor, cfg.model.nh
        )
    )(p1, p2)
    return dec.A, dec.b


def build_corridors(
    ref: ReferenceResult,
    tube_E: jnp.ndarray,
    obstacles: jnp.ndarray,
    obstacle_mask: jnp.ndarray,
    cfg: PlannerConfig,
):
    """All-stage decomposition + sequential reuse selection."""
    A_all, b_all = decompose_stages(
        ref.ref_pos, corridor_seed2(ref, cfg), obstacles, obstacle_mask, cfg
    )
    return reuse_select(A_all, b_all, tube_E, ref.ref_pos, cfg)


def nmpc_step(
    mpc_output: jnp.ndarray,     # (N+1, 17) previous deque
    kino_path: jnp.ndarray,      # (K, 3)
    kino_size: jnp.ndarray,
    t_offset: jnp.ndarray,       # mpc_start - kino_start [s]
    state_mpc: jnp.ndarray,      # (9,) current odom state
    f_ext: jnp.ndarray,          # (3,)
    end_pt: jnp.ndarray,         # (3,) global goal
    obstacles: jnp.ndarray,      # (M, 3)
    obstacle_mask: jnp.ndarray,  # (M,)
    use_final: jnp.ndarray,      # bool: final (braking) profile
    cfg: PlannerConfig,
    accept_on_maxit: jnp.ndarray | bool = False,
) -> NMPCStepResult:
    mcfg = cfg.model
    N = mcfg.N
    dtype = mpc_output.dtype

    # 1. references + yaw (getCurTraj loop, nmpc_solver.cpp:490-495)
    ref = sample_references(
        kino_path, kino_size, t_offset,
        last_yaw=mpc_output[1, 16],
        pred_pos1=mpc_output[1, 8:11],
        N=N, Ts=mcfg.dt,
    )

    # 2. disturbance tubes from the previous solution (rows 0..N-1)
    tube = propagate_tubes(
        mpc_output[:N], mcfg, cfg.tube, jnp.asarray(cfg.tube.K, dtype)
    )

    # 3. corridors + tube tightening (forces_normal.cpp:111-136)
    A_sel, b_sel, _ = build_corridors(
        ref, tube.E, obstacles, obstacle_mask, cfg
    )
    b_tight = tighten_corridor(A_sel, b_sel, tube.E)

    # 4. pack + solve.  xinit = stage-1 *prediction*, not odometry
    #    (forces_normal.cpp:62-72); warm start = previous rows 1..N.
    weights_n = nlp.make_stage_weights(cfg.weights, N, final=False, dtype=dtype)
    weights_f = nlp.make_stage_weights(cfg.weights, N, final=True, dtype=dtype)
    weights = jax.tree.map(
        lambda a, b: jnp.where(use_final, b, a), weights_n, weights_f
    )
    params = nlp.NLPParams(
        xinit=mpc_output[1, 8:17],
        ref_pos=ref.ref_pos,
        ref_yaw=ref.ref_yaw,
        f_ext=f_ext,
        corridor_A=A_sel,
        corridor_b=b_tight,
        weights=weights,
    )
    Z0 = mpc_output[1 : N + 1]
    res = ipm.solve(Z0, params, mcfg, cfg.solver)

    # 5. accept or keep previous (solveNMPC lines 397-429 acceptance; counter
    #    policy lives in the host FSM).  accept_on_maxit mirrors the
    #    desperate acceptance after >3 replans (nmpc_solver.cpp:408-413).
    ok = (res.exit_code == 1) | (
        jnp.asarray(accept_on_maxit) & jnp.isfinite(res.kkt_error)
    )
    Z_new = jnp.where(ok, wrap_yaw_outputs(res.Z), mpc_output[:N])
    out = jnp.concatenate([Z_new, Z_new[-1][None]], axis=0)

    # 6. status flags (lines 435-481)
    fsm = cfg.fsm
    ref_end = out[N - 1, 8:11]
    max_index = jnp.floor((N * mcfg.dt + t_offset) / mcfg.dt)
    kino_last = kino_path[jnp.clip(kino_size - 1, 0, kino_path.shape[0] - 1)]
    reach_local_end = (max_index > 0.5 * kino_size) & (
        jnp.linalg.norm(end_pt - kino_last) > fsm.local_end_dist
    )
    switch_final = (max_index >= kino_size) | (
        jnp.linalg.norm(ref_end - end_pt) < fsm.final_switch_dist
    )
    diverged = (
        jnp.linalg.norm(out[1, 8:11] - state_mpc[0:3]) > fsm.divergence_dist
    )
    goal_reached = jnp.linalg.norm(ref_end - end_pt) < fsm.goal_radius
    jump_replan = ref.stage0_jump > fsm.ref_jump_replan

    return NMPCStepResult(
        mpc_output=out,
        exit_code=res.exit_code,
        iters=res.iters,
        kkt_error=res.kkt_error,
        ref=ref,
        corridor_A=A_sel,
        corridor_b=b_sel,
        corridor_b_tight=b_tight,
        tube_E=tube.E,
        reach_local_end=reach_local_end,
        switch_to_final=switch_final,
        diverged=diverged,
        goal_reached=goal_reached,
        ref_jump_replan=jump_replan,
    )
