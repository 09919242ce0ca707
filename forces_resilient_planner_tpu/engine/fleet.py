"""Fleet-scale batched closed loop: map -> search -> NMPC per scenario.

The Monte-Carlo configuration the reference cannot express: B independent
scenarios (start x goal x true-force) flown SIMULTANEOUSLY through the
full pipeline — vmapped kinodynamic search (HOT LOOP 1,
kinodynamic_astar.cpp:17-286), the batched nmpc_step (tubes, corridor
kernel, lane-major solver), and a device-side RK4 plant — with
synchronized replanning.  One shared occupancy scene; per-lane goals,
forces and fates.

Simplifications vs the single-robot host stack (engine/planner.py),
documented deviations for the batched setting:
  - receding-horizon execution applies stage-1 controls for one dt with
    the fixed tube gain K as ancillary feedback, u = u_nom + K(x - x_nom)
    — the closed loop Phi = A + B K that getDistrEllipsoid's tubes model
    (nmpc_solver.cpp:28-31, 567-611); the reference gets this feedback
    from the RotorS inner tracking controller, which the 100 Hz command
    interpolation (commander.py) feeds;
  - replanning is synchronized: the cadence replan plus escalated replans
    whenever any lane's fail ladder crosses max_solve_fails or the solver
    certifies its problem infeasible (exit -7, NOPROGRESS — the taxonomy
    branch the reference's ladder cannot take, nmpc_solver.cpp:405-421);
  - reached lanes freeze (their plant stops integrating) — per-lane
    failure isolation, SURVEY.md section 2.4.

Every lane ends with an attributed outcome (OUTCOME_* below) so a
Monte-Carlo sweep's attrition is explained, not just counted: reached /
collided / panicked (with the dominant solver exit family that drove the
panic) / never-found-a-path / still-flying-at-timeout.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import PlannerConfig
from forces_resilient_planner_tpu.dynamics.quadrotor import continuous_dynamics
from forces_resilient_planner_tpu.engine.pipeline_batch import nmpc_step_batched
from forces_resilient_planner_tpu.mapping import occ_grid as og
from forces_resilient_planner_tpu.search import kinodynamic as kd
from forces_resilient_planner_tpu.solver.problems import hover_warm_start

# per-lane terminal outcomes (FleetResult.outcome)
OUTCOME_REACHED = 1        # entered goal_radius of its goal
OUTCOME_COLLIDED = 2       # plant state entered an occupied voxel
OUTCOME_PANICKED = 3       # froze after `panic_after` consecutive solve fails
OUTCOME_NO_PATH = 4        # the batched search never produced a path
OUTCOME_TIMEOUT = 5        # still flying (solves OK) when duration ran out
OUTCOME_NAMES = {
    OUTCOME_REACHED: "reached",
    OUTCOME_COLLIDED: "collided",
    OUTCOME_PANICKED: "panicked",
    OUTCOME_NO_PATH: "no_path",
    OUTCOME_TIMEOUT: "timeout",
}


class FleetResult(NamedTuple):
    reached_frac: float
    collided_frac: float
    mean_final_dist: float
    solved_frac: float          # mean solver success over all live ticks
    n_ticks: int
    batch: int
    wall_s: float
    searches: int
    final_states: np.ndarray    # (B, 9)
    # --- attribution (round 5): every lane's fate, explained -----------
    outcome: np.ndarray         # (B,) OUTCOME_* codes
    outcome_counts: Dict[str, int]
    time_to_goal: np.ndarray    # (B,) seconds, nan where not reached
    # solver exit-code family fractions over live (unfrozen) lane-ticks
    tick_code_fracs: Dict[str, float]
    # per-lane count of NOPROGRESS (-7, tube-tightened-infeasible) ticks
    infeas_ticks: np.ndarray    # (B,) int
    # exit code of the tick that tipped a lane into panic (0 elsewhere)
    panic_exit_code: np.ndarray  # (B,) int


def _rk4_plant(state, u, f_true, mcfg, dt):
    """Device-side plant: RK4 on the true dynamics with ideal rate
    tracking — the jnp twin of engine/simulator.QuadSim.step."""
    def f(x):
        return continuous_dynamics(x, u, f_true, mcfg)

    k1 = f(state)
    k2 = f(state + 0.5 * dt * k1)
    k3 = f(state + 0.5 * dt * k2)
    k4 = f(state + dt * k3)
    return state + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def run_fleet(
    cfg: PlannerConfig,
    grid: og.OccGrid,
    obstacles: jnp.ndarray,      # (M, 3) shared scene cloud
    obstacle_mask: jnp.ndarray,  # (M,)
    starts: np.ndarray,          # (B, 9)
    goals: np.ndarray,           # (B, 3)
    f_true: np.ndarray,          # (B, 3) true external force accel
    duration: float,
    replan_every: int = 10,      # MPC ticks between synchronized replans
    goal_radius: float = 0.3,
    dtype=jnp.float32,
    tick_trace: list | None = None,   # appended per tick: dict of np arrays
) -> FleetResult:
    mcfg = cfg.model
    N = mcfg.N
    dt = mcfg.dt
    B = starts.shape[0]
    M = obstacles.shape[0]
    # fail-ladder constants: escalation (replan request) fires when a
    # lane's consecutive-fail count EXCEEDS max_solve_fails; the panic
    # freeze is derived from the same config with fixed headroom so
    # escalation always precedes panic for any max_solve_fails value
    # (the >10 m/s^2 panic / WAIT_TARGET abort analog,
    # nmpc_manage.cpp:380-411)
    escalate_after = cfg.fsm.max_solve_fails + 1
    panic_after = cfg.fsm.max_solve_fails + 4
    assert escalate_after < panic_after

    starts_j = jnp.asarray(starts, dtype)
    goals_j = jnp.asarray(goals, dtype)
    f_j = jnp.asarray(f_true, dtype)
    obs_b = jnp.broadcast_to(jnp.asarray(obstacles, dtype)[None], (B, M, 3))
    mask_b = jnp.broadcast_to(jnp.asarray(obstacle_mask)[None], (B, M))

    z3 = jnp.zeros(3, dtype)

    @jax.jit
    def search_fleet(states):
        res = jax.vmap(
            lambda s, g, e: kd.search(
                grid, s[0:3], s[3:6], z3, g, z3, e, False,
                cfg.search, cfg.tube, cfg.map,
            ),
            in_axes=(0, 0, 0),
        )(states, goals_j, f_j)
        path, size = jax.vmap(
            lambda r, e: kd.get_kino_traj(r, e, dt)
        )(res, f_j)
        return res.status, path, size

    @jax.jit
    def mpc_and_plant(mpc_output, path, size, t_off, states, use_final,
                      frozen, last_ok):
        # per-lane fail ladder, the batched initMPCOutput + divergence
        # guard (nmpc_solver.cpp:362-364, 453-463): a lane whose last
        # solve failed, or whose stage-1 prediction drifted beyond the
        # divergence bound from the MEASURED state, re-seeds its deque
        # from hover at the measured state
        # re-anchor seeds are clamped into the NLP's state box: a
        # measured state beyond v_max (possible transiently under strong
        # wind) can never satisfy the xinit equality inside the bounds,
        # so an unclamped seed would report -7 forever; the clamped seed
        # yields a brake-back plan and the divergence guard covers the
        # model error until the plant re-enters the box
        states_seed = states.at[:, 3:6].set(
            jnp.clip(states[:, 3:6], -mcfg.max_vel, mcfg.max_vel)
        )
        hover = jax.vmap(lambda s: hover_warm_start(s, mcfg))(states_seed)
        hover_out = jnp.concatenate([hover, hover[:, -1:]], axis=1)
        pred_err = jnp.linalg.norm(
            mpc_output[:, 1, 8:11] - states[:, 0:3], axis=-1
        )
        reanchor = (~last_ok) | (pred_err > cfg.fsm.divergence_dist)
        Zin = jnp.where(reanchor[:, None, None], hover_out, mpc_output)

        r = nmpc_step_batched(
            Zin, path, size, t_off, states, f_j, goals_j,
            obs_b, mask_b, use_final, cfg=cfg,
        )
        # ancillary feedback: u = u_nom + K (x_real - x_nom), the fixed
        # tube gain (nmpc_solver.cpp:28-31).  The disturbance tube models
        # the CLOSED-LOOP Phi = A + B K (getDistrEllipsoid, 567-611);
        # in the reference that feedback is the RotorS inner tracking
        # controller.  Applying raw stage-1 controls open-loop let the
        # plant drift meters from the solver's prediction-anchored state
        # while every solve reported optimal (round-5 fleet attribution:
        # runaway lanes -> v_max-violating xinit -> perpetual -7 -> 23%
        # panic attrition); the gain closes that loop per tick.
        u_nom = r.mpc_output[:, 1, 0:4]
        x_nom = r.mpc_output[:, 1, 8:17]
        Kfb = jnp.asarray(cfg.K_matrix(), dtype)
        du = jnp.einsum("ij,bj->bi", Kfb, states - x_nom,
                        precision=jax.lax.Precision.HIGHEST)
        lo = jnp.asarray(
            [-mcfg.max_rate] * 3 + [mcfg.min_thrust], dtype
        )
        hi = jnp.asarray(
            [mcfg.max_rate] * 3 + [mcfg.max_thrust], dtype
        )
        u0 = jnp.clip(u_nom + du, lo, hi)
        new_states = jax.vmap(
            lambda s, u, f: _rk4_plant(s, u, f, mcfg, dt)
        )(states, u0, f_j)
        new_states = jnp.where(frozen[:, None], states, new_states)
        dist = jnp.linalg.norm(new_states[:, 0:3] - goals_j, axis=-1)
        reached = dist < goal_radius
        occ = jax.vmap(
            lambda s: og.voxel_state(grid, s[0:3], cfg.map)
        )(new_states)
        # use_final is LATCHED (the host FSM latches it until a new goal,
        # planner.py; fleet goals never change) so a post-replan t_offset
        # reset cannot oscillate a lane back to the normal weight profile
        return (
            r.mpc_output, new_states, reached, occ == 1,
            use_final | r.switch_to_final, r.exit_code,
        )

    Z0 = jax.vmap(lambda s: hover_warm_start(s, mcfg))(starts_j)
    mpc_output = jnp.concatenate([Z0, Z0[:, -1:]], axis=1)
    states = starts_j
    use_final = jnp.zeros((B,), bool)
    reached_mask = np.zeros(B, bool)
    panicked = np.zeros(B, bool)
    last_ok = jnp.ones((B,), bool)
    fail_count = np.zeros(B, np.int32)
    collided = np.zeros(B, bool)
    ever_path = np.zeros(B, bool)
    replan_pending = np.zeros(B, bool)
    time_reached = np.full(B, np.nan)
    infeas_ticks = np.zeros(B, np.int64)
    panic_code = np.zeros(B, np.int32)   # dominant exit at panic time
    code_counts = {1: 0, 0: 0, -6: 0, -7: 0}
    live_ticks = 0
    solved_accum = []

    n_ticks = int(round(duration / dt))
    t0 = time.perf_counter()
    status, path, size = search_fleet(states)
    ever_path |= np.asarray(size) > 0
    searches = 1
    # a failed search (NO_PATH / empty traj) keeps the lane's previous
    # path (the FSM's plan-fail behavior: the old trajectory stays live,
    # nmpc_manage.cpp:186-192); time origins are tracked per lane
    t_planned = jnp.zeros((B,), dtype)
    for k in range(n_ticks):
        t_now = k * dt
        # replan on cadence OR when any live lane's ladder escalated or
        # its solver certified infeasibility (-7) last tick
        escalate = bool(np.any(replan_pending & ~panicked & ~reached_mask))
        if k > 0 and (k % replan_every == 0 or escalate):
            status2, path2, size2 = search_fleet(states)
            good = np.asarray(size2) > 0
            ever_path |= good
            good_j = jnp.asarray(good)
            path = jnp.where(good_j[:, None, None], path2, path)
            size = jnp.where(good_j, size2, size)
            t_planned = jnp.where(good_j, t_now, t_planned)
            searches += 1
            replan_pending[:] = False
        t_off = (t_now - t_planned).astype(dtype)
        frozen = jnp.asarray(reached_mask | panicked)
        (mpc_output, states, reached, occ_hit, use_final,
         ec_b) = mpc_and_plant(
            mpc_output, path, size, t_off, states, use_final, frozen,
            last_ok,
        )
        ec_np = np.asarray(ec_b)
        ok_np = ec_np == 1
        last_ok = jnp.asarray(ok_np)
        live = ~(reached_mask | panicked)
        live_ticks += int(live.sum())
        for code in code_counts:
            code_counts[code] += int(((ec_np == code) & live).sum())
        infeas_ticks += ((ec_np == -7) & live).astype(np.int64)
        fail_count = np.where(ok_np, 0, fail_count + 1)
        # escalated replan request: ladder crossing OR infeasibility
        # certificate (NOPROGRESS means the corridor around the CURRENT
        # path is empty after tube tightening — only a new path helps)
        replan_pending |= (fail_count >= escalate_after) | (
            (ec_np == -7) & live
        )
        newly_panicked = (fail_count >= panic_after) & ~reached_mask & ~panicked
        panic_code[newly_panicked] = ec_np[newly_panicked]
        panicked |= newly_panicked
        newly_reached = np.asarray(reached) & ~panicked & ~reached_mask
        time_reached[newly_reached] = t_now + dt
        reached_mask |= newly_reached
        collided |= np.asarray(occ_hit) & ~reached_mask & ~panicked
        if live.any():
            solved_accum.append(float(ok_np[live].mean()))
        if tick_trace is not None:
            tick_trace.append(dict(
                t=t_now, states=np.asarray(states), ec=ec_np,
                fail=fail_count.copy(), u0=np.asarray(mpc_output[:, 1, 0:4]),
                use_final=np.asarray(use_final), t_off=np.asarray(t_off),
                size=np.asarray(size),
            ))
    states_np = np.asarray(states)
    wall = time.perf_counter() - t0

    outcome = np.full(B, OUTCOME_TIMEOUT, np.int32)
    outcome[~ever_path] = OUTCOME_NO_PATH
    outcome[panicked] = OUTCOME_PANICKED
    outcome[collided] = OUTCOME_COLLIDED
    outcome[reached_mask] = OUTCOME_REACHED
    outcome_counts = {
        name: int((outcome == code).sum())
        for code, name in OUTCOME_NAMES.items()
    }
    tick_code_fracs = (
        {
            "optimal": code_counts[1] / live_ticks,
            "maxit": code_counts[0] / live_ticks,
            "badfuneval": code_counts[-6] / live_ticks,
            "noprogress": code_counts[-7] / live_ticks,
        }
        if live_ticks
        else {}
    )

    dist = np.linalg.norm(states_np[:, 0:3] - np.asarray(goals), axis=-1)
    return FleetResult(
        reached_frac=float(reached_mask.mean()),
        collided_frac=float(collided.mean()),
        mean_final_dist=float(dist[~panicked].mean()) if (~panicked).any()
        else float("nan"),
        solved_frac=float(np.mean(solved_accum)) if solved_accum else 1.0,
        n_ticks=n_ticks,
        batch=B,
        wall_s=wall,
        searches=searches,
        final_states=states_np,
        outcome=outcome,
        outcome_counts=outcome_counts,
        time_to_goal=time_reached,
        tick_code_fracs=tick_code_fracs,
        infeas_ticks=infeas_ticks,
        panic_exit_code=panic_code,
    )
