"""Batched scenario engine: thousands of NMPC problems per chip.

The framework's data parallelism (SURVEY.md section 2.4): vmap over
(goal x force profile x corridor set) scenarios of the full solve, plus
scenario-grid builders for the BASELINE configs 4-5.  Per-scenario failure
isolation comes free: each lane carries its own exit code and the batched
solver's NaN guard keeps diverged lanes from poisoning the rest.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import PlannerConfig
from forces_resilient_planner_tpu.solver import ipm, ipm_lanes, nlp
from forces_resilient_planner_tpu.solver import problems
from forces_resilient_planner_tpu.solver.problems import (
    box_corridor,
    hover_warm_start,
)


class ScenarioSet(NamedTuple):
    """Batched NLP parameters + warm starts.  Leading axis = scenario."""

    Z0: jnp.ndarray
    params: nlp.NLPParams

    @property
    def batch(self) -> int:
        return self.Z0.shape[0]


def make_scenarios(
    cfg: PlannerConfig,
    goals: np.ndarray,          # (G, 3)
    forces: np.ndarray,         # (F, 3)
    corridor_halves: np.ndarray,  # (Cc, 3) box half-extents
    x0: np.ndarray | None = None,
    dtype=jnp.float32,
) -> ScenarioSet:
    """Cartesian scenario grid (goal x force x corridor), config-4/5 style."""
    mcfg = cfg.model
    N = mcfg.N
    if x0 is None:
        x0 = np.zeros(9)
        x0[2] = 1.2
    G, F, Cc = len(goals), len(forces), len(corridor_halves)
    B = G * F * Cc
    gi, fi, ci = np.meshgrid(
        np.arange(G), np.arange(F), np.arange(Cc), indexing="ij"
    )
    g = goals[gi.ravel()]
    f = forces[fi.ravel()]
    ch = corridor_halves[ci.ravel()]

    ref_pos = np.tile(g[:, None, :], (1, N, 1))
    dirv = g[:, :2] - x0[None, :2]
    yaw = np.where(
        np.linalg.norm(dirv, axis=-1) > 1e-6,
        np.arctan2(dirv[:, 1], dirv[:, 0]),
        0.0,
    )
    ref_yaw = np.tile(yaw[:, None], (1, N))

    centers = 0.5 * (x0[None, :3] + g)
    A = np.zeros((B, N, mcfg.nh, 3))
    b = np.zeros((B, N, mcfg.nh))
    eye = np.eye(3)
    for k in range(3):
        A[:, :, 2 * k, :] = eye[k]
        b[:, :, 2 * k] = (centers[:, k] + ch[:, k])[:, None]
        A[:, :, 2 * k + 1, :] = -eye[k]
        b[:, :, 2 * k + 1] = -(centers[:, k] - ch[:, k])[:, None]

    weights = nlp.make_stage_weights(cfg.weights, N, final=False, dtype=dtype)
    weights_b = jax.tree.map(lambda a: jnp.tile(a[None], (B,) + (1,) * a.ndim), weights)

    params = nlp.NLPParams(
        xinit=jnp.tile(jnp.asarray(x0, dtype)[None], (B, 1)),
        ref_pos=jnp.asarray(ref_pos, dtype),
        ref_yaw=jnp.asarray(ref_yaw, dtype),
        f_ext=jnp.asarray(f, dtype),
        corridor_A=jnp.asarray(A, dtype),
        corridor_b=jnp.asarray(b, dtype),
        weights=weights_b,
    )
    # honor SolverConfig.warm_start here too so the host path builds the
    # SAME warm start as the device-side expansion (_expand_scenarios_device)
    # — the mesh sweep and the oracle parity rebuild must match the fused
    # sweep path bit-for-bit
    if cfg.solver.warm_start == "lqr":
        Z0 = problems.lqr_warm_start_batch(
            jnp.tile(jnp.asarray(x0, dtype)[None], (B, 1)),
            params.ref_pos, params.ref_yaw, params.f_ext,
            mcfg, jnp.asarray(cfg.K_matrix(), dtype),
        )
    else:
        Z0 = jnp.tile(
            hover_warm_start(jnp.asarray(x0, dtype), mcfg)[None], (B, 1, 1)
        )
    return ScenarioSet(Z0=Z0, params=params)


def _expand_scenarios_device(
    cfg: PlannerConfig,
    x0: jnp.ndarray,       # (9,)
    goals: jnp.ndarray,    # (G, 3)
    forces: jnp.ndarray,   # (F, 3)
    halves: jnp.ndarray,   # (Cc, 3)
    weights: nlp.StageWeights,  # per-stage (N, ...) tables
) -> ScenarioSet:
    """Device-side cartesian scenario expansion (jit-traceable).

    The host transfers only the scenario *seeds* (a few KB); the ~60 MB of
    per-scenario NLP parameters (corridor rows, references, warm starts) are
    materialized on-chip.  This is the framework's host-to-device parameter
    staging path (SURVEY.md section 2.4): the reference pushes 2600 doubles
    per solve through FORCES param structs (forces_normal.cpp:74-137); here
    the per-solve parameter block never crosses the PCIe/DCN boundary.
    """
    mcfg = cfg.model
    N, nh = mcfg.N, mcfg.nh
    dtype = goals.dtype
    G, F, Cc = goals.shape[0], forces.shape[0], halves.shape[0]
    B = G * F * Cc

    g = jnp.repeat(goals, F * Cc, axis=0)                    # (B, 3)
    f = jnp.tile(jnp.repeat(forces, Cc, axis=0), (G, 1))     # (B, 3)
    ch = jnp.tile(halves, (G * F, 1))                        # (B, 3)

    ref_pos = jnp.broadcast_to(g[:, None, :], (B, N, 3))
    dirv = g[:, :2] - x0[None, :2]
    yaw = jnp.where(
        jnp.linalg.norm(dirv, axis=-1) > 1e-6,
        jnp.arctan2(dirv[:, 1], dirv[:, 0]),
        0.0,
    )
    ref_yaw = jnp.broadcast_to(yaw[:, None], (B, N))

    centers = 0.5 * (x0[None, :3] + g)
    eye = jnp.eye(3, dtype=dtype)
    A_one = jnp.zeros((nh, 3), dtype).at[0:6:2].set(eye).at[1:6:2].set(-eye)
    A = jnp.broadcast_to(A_one[None, None], (B, N, nh, 3))
    b_one = jnp.zeros((B, nh), dtype)
    b_one = b_one.at[:, 0:6:2].set(centers + ch)
    b_one = b_one.at[:, 1:6:2].set(-(centers - ch))
    b = jnp.broadcast_to(b_one[:, None, :], (B, N, nh))

    weights_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), weights
    )
    if cfg.solver.warm_start == "lqr":
        Z0 = problems.lqr_warm_start_batch(
            jnp.broadcast_to(x0[None], (B, 9)), ref_pos, ref_yaw, f,
            mcfg, jnp.asarray(cfg.K_matrix(), dtype),
        )
    else:
        Z0 = jnp.broadcast_to(
            hover_warm_start(x0, mcfg)[None], (B, N, nlp.NZ)
        )
    params = nlp.NLPParams(
        xinit=jnp.broadcast_to(x0[None], (B, 9)),
        ref_pos=ref_pos, ref_yaw=ref_yaw, f_ext=f,
        corridor_A=A, corridor_b=b, weights=weights_b,
    )
    return ScenarioSet(Z0=Z0, params=params)


# bounded executable caches: keyed by config VALUE + shapes; without a cap
# a long-lived service sweeping many configs would accumulate executables
# (round-3 advisor note).  FIFO eviction — re-entry just re-jits.
_CACHE_CAP = 16


def _cache_put(cache: dict, key, value):
    if len(cache) >= _CACHE_CAP and key not in cache:
        cache.pop(next(iter(cache)))
    cache[key] = value


_jitted_sweeps: dict = {}


def solve_scenario_grid(
    cfg: PlannerConfig,
    goals: np.ndarray,
    forces: np.ndarray,
    corridor_halves: np.ndarray,
    x0: np.ndarray | None = None,
    dtype=jnp.float32,
) -> ipm.SolveResult:
    """Expand-and-solve fused in one jit: only the scenario seeds cross the
    host-device boundary.  Compiled once per (G, F, Cc, config) shape."""
    mcfg = cfg.model
    if x0 is None:
        x0 = np.zeros(9)
        x0[2] = 1.2
    # key by VALUE (PlannerConfig is a frozen/hashable dataclass): id() keys
    # are reused after GC, which could silently serve a stale executable
    # compiled against a different config's constants
    key = (cfg, goals.shape, forces.shape, corridor_halves.shape,
           str(dtype))
    if key not in _jitted_sweeps:
        weights = nlp.make_stage_weights(
            cfg.weights, mcfg.N, final=False, dtype=dtype
        )

        # Two dispatches on purpose: expansion and solve fused into ONE XLA
        # program measured 4.3x slower end-to-end (the compiler scheduled the
        # expanded parameter tensors poorly around the IPM while-loop, and an
        # optimization_barrier did not recover it).  As separate executables
        # the expansion materializes once (~30 ms incl. dispatch) and the
        # solve runs at full speed; scenario data still never crosses the
        # host-device boundary.
        expand = jax.jit(
            lambda x0_, g_, f_, h_: jax.tree.map(
                lambda a: a + 0.0,
                _expand_scenarios_device(cfg, x0_, g_, f_, h_, weights),
            )
        )
        solve = jax.jit(
            lambda Z0, p: ipm_lanes.solve_batch_lanes_tiered(
                Z0, p, cfg.model, cfg.solver
            )
        )
        _cache_put(_jitted_sweeps, key, (expand, solve))
    expand, solve = _jitted_sweeps[key]
    scen = expand(
        jnp.asarray(x0, dtype), jnp.asarray(goals, dtype),
        jnp.asarray(forces, dtype), jnp.asarray(corridor_halves, dtype),
    )
    return solve(scen.Z0, scen.params)


def solve_scenario_stream(
    cfg: PlannerConfig,
    seed_sets,                  # iterable of (goals, forces) numpy pairs
    corridor_halves: np.ndarray,
    x0: np.ndarray | None = None,
    dtype=jnp.float32,
):
    """Pipelined sweep over a stream of scenario seed sets.

    JAX dispatch is asynchronous: by dispatching scenario-set k+1's
    expansion (and k+1's solve) before synchronizing on set k's result,
    the host-side dispatch latency of the two-executable sweep
    (see solve_scenario_grid) is hidden behind device compute — the
    double-buffered host-to-device parameter staging of SURVEY.md §2.4.
    Returns the list of SolveResults (device arrays, already complete or
    in flight; sync with np.asarray as usual).
    """
    mcfg = cfg.model
    if x0 is None:
        x0 = np.zeros(9)
        x0[2] = 1.2
    seed_sets = list(seed_sets)
    if not seed_sets:
        return []
    g0 = seed_sets[0][0]
    key = (cfg, g0.shape, seed_sets[0][1].shape, corridor_halves.shape,
           str(dtype))
    results = []
    if key not in _jitted_sweeps:
        # populate the (expand, solve) executable pair; the warm-up solve IS
        # seed set 0's result — re-dispatching the same set would do one
        # redundant batched solve
        results.append(
            solve_scenario_grid(
                cfg, g0, seed_sets[0][1], corridor_halves, x0=x0, dtype=dtype
            )
        )
        seed_sets = seed_sets[1:]
    expand, solve = _jitted_sweeps[key]

    x0j = jnp.asarray(x0, dtype)
    hj = jnp.asarray(corridor_halves, dtype)
    for g, f in seed_sets:
        scen = expand(x0j, jnp.asarray(g, dtype), jnp.asarray(f, dtype), hj)
        results.append(solve(scen.Z0, scen.params))
    return results


_jitted_solvers: dict = {}


def solve_scenarios(
    scen: ScenarioSet, cfg: PlannerConfig
) -> ipm.SolveResult:
    """One batched jitted solve (compiled once per config, cached)."""
    key = cfg  # by value: frozen/hashable (see solve_scenario_grid)
    if key not in _jitted_solvers:
        _cache_put(
            _jitted_solvers,
            key,
            jax.jit(
                lambda Z0, params: ipm_lanes.solve_batch_lanes_tiered(
                    Z0, params, cfg.model, cfg.solver
                )
            ),
        )
    return _jitted_solvers[key](scen.Z0, scen.params)


class SweepStats(NamedTuple):
    n: jnp.ndarray
    n_solved: jnp.ndarray
    mean_iters: jnp.ndarray
    max_kkt_solved: jnp.ndarray
    mean_cost: jnp.ndarray


def sweep_stats(res: ipm.SolveResult) -> SweepStats:
    """Global reductions over a (possibly sharded) batch.  Under pjit these
    lower to XLA collectives across the mesh (the reference's 'communication
    backend' analog, SURVEY.md section 5)."""
    solved = res.exit_code == 1
    n = jnp.asarray(res.exit_code.shape[0], jnp.float32)
    n_solved = jnp.sum(solved.astype(jnp.float32))
    mean_iters = jnp.mean(res.iters.astype(jnp.float32))
    max_kkt = jnp.max(jnp.where(solved, res.kkt_error, 0.0))
    mean_cost = jnp.mean(jnp.sum(res.Z[:, :, 0:4] ** 2, axis=(1, 2)))
    return SweepStats(
        n=n, n_solved=n_solved, mean_iters=mean_iters,
        max_kkt_solved=max_kkt, mean_cost=mean_cost,
    )
