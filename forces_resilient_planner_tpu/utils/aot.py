"""Offline solver artifact generation (the FORCES-codegen analog).

The reference's solver is produced out-of-band: a MATLAB problem spec is
sent to the FORCES Pro cloud, which returns generated C + a static library
that ships with the robot (plan_manage/matlab_code/generate_solver.m,
README.md:61-66).  The equivalent here of "ship a compiled solver"
is a serialized `jax.export` artifact: the jitted batched solve is traced
and lowered ONCE to a versioned StableHLO blob, which deployments load and
run without retracing or re-sharding logic (XLA backend compilation still
happens on first load, amortized by the persistent compilation cache).

    # offline (the generate_solver.m analog)
    blob = export_batched_solver(cfg, batch=4096)
    Path("solver_b4096.bin").write_bytes(blob)

    # on the robot / in the sweep job
    solver = load_solver(Path("solver_b4096.bin").read_bytes())
    res = solver(Z0, params)          # same pytree signature
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as jax_export

from forces_resilient_planner_tpu.config import PlannerConfig
from forces_resilient_planner_tpu.solver import ipm_lanes, nlp
from forces_resilient_planner_tpu.solver.ipm import SolveResult

for _nt in (nlp.StageWeights, nlp.NLPParams, SolveResult):
    try:
        jax_export.register_namedtuple_serialization(
            _nt, serialized_name=f"frp.{_nt.__name__}"
        )
    except ValueError:
        pass  # already registered (re-import)


def _example_batch(cfg: PlannerConfig, batch: int, dtype):
    """Shape-only example inputs for tracing (values irrelevant)."""
    N, nh = cfg.model.N, cfg.model.nh
    w = nlp.make_stage_weights(cfg.weights, N, final=False, dtype=dtype)
    wb = jax.tree.map(
        lambda a: jnp.zeros((batch,) + a.shape, dtype), w
    )
    params = nlp.NLPParams(
        xinit=jnp.zeros((batch, 9), dtype),
        ref_pos=jnp.zeros((batch, N, 3), dtype),
        ref_yaw=jnp.zeros((batch, N), dtype),
        f_ext=jnp.zeros((batch, 3), dtype),
        corridor_A=jnp.zeros((batch, N, nh, 3), dtype),
        corridor_b=jnp.zeros((batch, N, nh), dtype),
        weights=wb,
    )
    Z0 = jnp.zeros((batch, N, 17), dtype)
    return Z0, params


def export_batched_solver(
    cfg: PlannerConfig, batch: int, dtype=jnp.float32
) -> bytes:
    """Serialize the jitted batched solve for `batch` scenarios."""
    fn = jax.jit(
        lambda Z0, params: ipm_lanes.solve_batch_lanes_tiered(
            Z0, params, cfg.model, cfg.solver
        )
    )
    Z0, params = _example_batch(cfg, batch, dtype)
    return jax_export.export(fn)(Z0, params).serialize()


def load_solver(blob: bytes) -> Callable:
    """Deserialize an exported solver; returns fn(Z0, params) -> SolveResult."""
    exp = jax_export.deserialize(blob)

    def run(Z0, params):
        from forces_resilient_planner_tpu.solver.ipm import SolveResult

        flat = exp.call(Z0, params)
        return (
            flat if isinstance(flat, SolveResult) else SolveResult(*flat)
        )

    return run
