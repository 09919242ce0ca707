"""Multi-device / multi-host scale-out via jax.sharding.

The reference is a single-process planner; scale-out is a new capability
(SURVEY.md section 2.4): scenario batches are sharded over a device mesh,
the per-scenario solves are embarrassingly parallel, and sweep statistics
reduce across the mesh with XLA collectives (NCCL on NVIDIA cards).

Multi-process runs call jax.distributed.initialize() first; CI exercises
the mesh on virtual CPU devices (--xla_force_host_platform_device_count).
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from forces_resilient_planner_tpu.config import PlannerConfig
from forces_resilient_planner_tpu.engine import batch as batch_mod
from forces_resilient_planner_tpu.solver import ipm


def make_mesh(devices=None, shape: Sequence[int] | None = None,
              axis_names: Sequence[str] | None = None) -> Mesh:
    """Mesh over the available devices.

    Default: one 'batch' axis over every device — the cards of one host
    reach each other all to all, so the mesh follows the algorithm (one
    scenario axis).  An explicit 2-D shape gets ('host', 'chip') axes, the
    outer one spanning process boundaries (tests/test_multiprocess.py).
    """
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices),)
    if axis_names is None:
        axis_names = ("batch",) if len(shape) == 1 else ("host", "chip")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Scenario batch sharded across every mesh axis; everything else
    replicated."""
    return NamedSharding(mesh, P(mesh.axis_names))


def shard_scenarios(scen: batch_mod.ScenarioSet, mesh: Mesh) -> batch_mod.ScenarioSet:
    """Shard the scenario batch across the mesh.

    Uses make_array_from_callback so it works on MULTI-PROCESS meshes
    (each process materializes only its addressable shards from the
    host-side scenario data, which is identical on every process by
    construction — deterministic seeds); on a single-process mesh this is
    equivalent to device_put with the same NamedSharding.
    """

    def put(a):
        a_np = np.asarray(a)
        sh = NamedSharding(
            mesh, P(mesh.axis_names, *([None] * (a_np.ndim - 1)))
        )
        return jax.make_array_from_callback(
            a_np.shape, sh, lambda idx: a_np[idx]
        )

    return jax.tree.map(put, scen)


def make_sharded_solver(cfg: PlannerConfig, mesh: Mesh):
    """jit-compiled sharded batched solve + collective sweep stats.

    Each shard runs the lane-major tiered solver on its LOCAL scenario
    slice via shard_map — the per-device program is exactly the
    single-card throughput path, tier compaction included (device-local,
    so no cross-device gathers); only the sweep statistics cross the
    mesh, as XLA collectives.

    Returns fn(scen) -> (SolveResult sharded, SweepStats replicated).
    """
    from forces_resilient_planner_tpu.solver import ipm_lanes

    data_spec = P(mesh.axis_names)

    def local_solve(Z0, params):
        return ipm_lanes.solve_batch_lanes_tiered(
            Z0, params, cfg.model, cfg.solver
        )

    sharded_solve = jax.shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(data_spec, jax.tree.map(lambda _: data_spec, _PARAMS_TREE)),
        out_specs=jax.tree.map(lambda _: data_spec, _RESULT_TREE),
        # the IPM state is initialized from literals (zeros/full), which the
        # varying-manual-axes checker flags against the shard-varying loop
        # outputs; the program is per-shard pure so the check is safe to skip
        check_vma=False,
    )

    @partial(jax.jit)
    def run(scen: batch_mod.ScenarioSet):
        res = ipm.SolveResult(*sharded_solve(scen.Z0, scen.params))
        stats = batch_mod.sweep_stats(res)   # cross-shard reductions -> collectives
        return res, stats

    return run


# spec templates (leaf structure stand-ins for shard_map's pytree specs)
from forces_resilient_planner_tpu.solver import nlp as _nlp  # noqa: E402

_PARAMS_TREE = _nlp.NLPParams(
    xinit=0, ref_pos=0, ref_yaw=0, f_ext=0,
    corridor_A=0, corridor_b=0,
    weights=_nlp.StageWeights(0, 0, 0, 0, 0),
)
_RESULT_TREE = ipm.SolveResult(
    Z=0, lam=0, s=0, mu_d=0, exit_code=0, iters=0, kkt_error=0
)


def sweep_scenarios(
    cfg: PlannerConfig, n_goals: int, n_forces: int, n_corridors: int = 1,
    seed: int = 0, dtype=jnp.float32,
) -> batch_mod.ScenarioSet:
    """The config-5 sweep's scenario grid (goal x force x corridor),
    deterministic per seed."""
    rng = np.random.default_rng(seed)
    goals = rng.uniform([-4, -4, 1.0], [4, 4, 1.6], (n_goals, 3))
    forces = rng.uniform(-2.0, 2.0, (n_forces, 3))
    halves = np.tile(np.array([[6.0, 6.0, 2.0]]), (n_corridors, 1))
    return batch_mod.make_scenarios(cfg, goals, forces, halves, dtype=dtype)


def monte_carlo_sweep(
    cfg: PlannerConfig, mesh: Mesh, n_goals: int, n_forces: int,
    n_corridors: int = 1, seed: int = 0, dtype=jnp.float32,
):
    """BASELINE config-5 shape: large scenario Monte-Carlo resilience sweep.

    Scenario count is rounded up to a multiple of the mesh size.
    """
    scen = sweep_scenarios(cfg, n_goals, n_forces, n_corridors, seed, dtype)
    B = scen.batch
    n_dev = mesh.devices.size
    pad = (-B) % n_dev
    if pad:
        scen = jax.tree.map(
            lambda a: jnp.concatenate([a, a[:pad]], axis=0), scen
        )
    scen = shard_scenarios(scen, mesh)
    run = make_sharded_solver(cfg, mesh)
    return run(scen)
