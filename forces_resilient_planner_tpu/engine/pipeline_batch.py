"""Batched full-pipeline NMPC step: the fleet-scale nmpc_step.

engine/pipeline.py::nmpc_step is the single-robot 20 Hz step; vmapping it
whole routes the solve through the per-lane solver (solver/ipm.py), which
cannot use the lane-major tiered path that gives the bare solver its
throughput (solver/ipm_lanes.py).  This module splits the step at the
solver boundary instead:

  references / tubes / corridors / tightening  -> vmapped (per-lane math)
  interior-point solve                          -> solve_batch_lanes_tiered
  acceptance + FSM flags                        -> vectorized over the batch

Numerics are the single-step formulas unchanged (same reference anchors as
engine/pipeline.py: solveNMPC/setFORCESParams, nmpc_solver.cpp:288-551);
parity with jax.vmap(nmpc_step) is tested in tests/test_pipeline.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import PlannerConfig
from forces_resilient_planner_tpu.engine.pipeline import (
    NMPCStepResult,
    corridor_seed2,
    decompose_stages,
    reuse_select,
)
from forces_resilient_planner_tpu.engine.reference import (
    sample_references,
    wrap_yaw_outputs,
)
from forces_resilient_planner_tpu.ops import corridor_pallas
from forces_resilient_planner_tpu.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu.tube.lyapunov import (
    propagate_tubes_batch,
    tighten_corridor,
)


def nmpc_step_batched(
    mpc_output: jnp.ndarray,     # (B, N+1, 17) previous deques
    kino_path: jnp.ndarray,      # (B, K, 3)
    kino_size: jnp.ndarray,      # (B,)
    t_offset: jnp.ndarray,       # (B,)
    state_mpc: jnp.ndarray,      # (B, 9)
    f_ext: jnp.ndarray,          # (B, 3)
    end_pt: jnp.ndarray,         # (B, 3)
    obstacles: jnp.ndarray,      # (B, M, 3)
    obstacle_mask: jnp.ndarray,  # (B, M)
    use_final: jnp.ndarray,      # (B,) bool
    cfg: PlannerConfig,
    accept_on_maxit: jnp.ndarray | bool = False,
) -> NMPCStepResult:
    mcfg = cfg.model
    N = mcfg.N
    B = mpc_output.shape[0]
    dtype = mpc_output.dtype

    # 1. references (getCurTraj loop, nmpc_solver.cpp:490-495)
    with jax.named_scope("refs"):
        ref = jax.vmap(
            lambda out, path, size, toff: sample_references(
                path, size, toff, last_yaw=out[1, 16],
                pred_pos1=out[1, 8:11], N=N, Ts=mcfg.dt,
            )
        )(mpc_output, kino_path, kino_size, t_offset)

    # 2. disturbance tubes (getDistrEllipsoid, nmpc_solver.cpp:567-611)
    with jax.named_scope("tube"):
        tube = propagate_tubes_batch(mpc_output[:, :N], mcfg, cfg.tube)

    # 3. corridors + tube tightening (forces_normal.cpp:111-136).  Every
    #    stage's fresh decomposition, then the cheap reuse gather-scan.
    with jax.named_scope("corridor"):
        seed2 = corridor_seed2(ref, cfg)                 # (B, N, 3)
        if corridor_pallas.corridor_kernel_enabled(dtype, B, cfg.corridor):
            A_all, b_all = corridor_pallas.decompose_stages(
                ref.ref_pos, seed2, obstacles, obstacle_mask,
                cfg.corridor, mcfg.nh,
            )
        else:
            A_all, b_all = jax.vmap(
                lambda p1, p2, obs, om: decompose_stages(
                    p1, p2, obs, om, cfg)
            )(ref.ref_pos, seed2, obstacles, obstacle_mask)
    with jax.named_scope("reuse"):
        A_sel, b_sel, _ = jax.vmap(
            lambda Aa, ba, E, rp: reuse_select(Aa, ba, E, rp, cfg)
        )(A_all, b_all, tube.E, ref.ref_pos)

    # 4. pack + lane-major tiered solve.  xinit = stage-1 prediction
    #    (forces_normal.cpp:62-72); warm start = previous rows 1..N.
    with jax.named_scope("tighten"):
        b_tight = tighten_corridor(A_sel, b_sel, tube.E)
        weights_n = nlp.make_stage_weights(
            cfg.weights, N, final=False, dtype=dtype)
        weights_f = nlp.make_stage_weights(
            cfg.weights, N, final=True, dtype=dtype)

        def _select(a, b):
            an = jnp.broadcast_to(a[None], (B,) + a.shape)
            bn = jnp.broadcast_to(b[None], (B,) + b.shape)
            sel = use_final.reshape((B,) + (1,) * a.ndim)
            return jnp.where(sel, bn, an)

        weights = jax.tree.map(_select, weights_n, weights_f)
        params = nlp.NLPParams(
            xinit=mpc_output[:, 1, 8:17],
            ref_pos=ref.ref_pos,
            ref_yaw=ref.ref_yaw,
            f_ext=f_ext,
            corridor_A=A_sel,
            corridor_b=b_tight,
            weights=weights,
        )
    with jax.named_scope("solve"):
        res = ipm_lanes.solve_batch_lanes_tiered(
            mpc_output[:, 1 : N + 1], params, mcfg, cfg.solver)

    # 5. acceptance (solveNMPC lines 397-429; counters live in the host FSM)
    ok = (res.exit_code == 1) | (
        jnp.asarray(accept_on_maxit) & jnp.isfinite(res.kkt_error)
    )
    Z_new = jnp.where(
        ok.reshape(B, 1, 1), jax.vmap(wrap_yaw_outputs)(res.Z),
        mpc_output[:, :N],
    )
    out = jnp.concatenate([Z_new, Z_new[:, -1][:, None]], axis=1)

    # 6. status flags (solveNMPC lines 435-481), batch-vectorized
    fsm = cfg.fsm
    ref_end = out[:, N - 1, 8:11]
    max_index = jnp.floor((N * mcfg.dt + t_offset) / mcfg.dt)
    kino_last = jnp.take_along_axis(
        kino_path,
        jnp.clip(kino_size - 1, 0, kino_path.shape[1] - 1)[:, None, None],
        axis=1,
    )[:, 0]
    reach_local_end = (max_index > 0.5 * kino_size) & (
        jnp.linalg.norm(end_pt - kino_last, axis=-1) > fsm.local_end_dist
    )
    switch_final = (max_index >= kino_size) | (
        jnp.linalg.norm(ref_end - end_pt, axis=-1) < fsm.final_switch_dist
    )
    diverged = (
        jnp.linalg.norm(out[:, 1, 8:11] - state_mpc[:, 0:3], axis=-1)
        > fsm.divergence_dist
    )
    goal_reached = jnp.linalg.norm(ref_end - end_pt, axis=-1) < fsm.goal_radius
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


def nmpc_step_stream(step_fn, input_sets):
    """Pipelined dispatch over independent batched-step input sets.

    The serving pattern of engine/batch.py::solve_scenario_stream applied
    to the FULL pipeline: JAX's async dispatch issues set k+1's step while
    set k still executes on device, hiding the host's dispatch latency.  step_fn: a jitted callable over one input set (e.g.
    jit(lambda a: nmpc_step_batched(**a, cfg=cfg))); input_sets: iterable
    of DEVICE-RESIDENT input pytrees (stage them with jax.device_put /
    block_until_ready first — host->device transfer inside the loop would
    serialize it).  Returns the list of (in-flight) results; sync with
    np.asarray as usual.
    """
    return [step_fn(a) for a in input_sets]
