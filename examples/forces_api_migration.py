"""Migration example: driving the batched solver through the FORCES Pro surface.

A user of the reference talks to the generated solver via flat structs
(xinit / x0 / all_parameters) packed by FORCESNormal::solveNormal
(forces_normal.cpp:55-140).  This example packs the exact same layout and
solves with this repo's IPM — the drop-in path for existing code.

Run: python examples/forces_api_migration.py         (default device, f32)
     python examples/forces_api_migration.py --cpu   (CPU, f64)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

# --cpu: the FORCES interface as an f64 host surface, like the
# reference's ctypes interface
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.solver import forces_api as fapi
from forces_resilient_planner_tpu.solver.problems import (
    box_corridor,
    hover_warm_start,
)
from forces_resilient_planner_tpu.tube import lyapunov


def main():
    x0 = np.zeros(9)
    x0[2] = 1.2
    goal = np.array([2.0, 1.0, 1.2])

    params = fapi.ForcesParams()
    params.xinit[:] = x0                      # stage-1 prediction in real use
    fapi.set_stage_weights(
        params,
        C.weights.w_stage_wp, C.weights.w_stage_input,
        C.weights.w_input_rate,
        C.weights.w_terminal_wp, C.weights.w_terminal_input,
    )

    # corridor + disturbance-tube tightening, exactly like the C++ wrapper
    A, b = box_corridor(0.5 * (x0[:3] + goal), np.array([5.0, 5.0, 2.0]),
                        fapi.N)
    Z_prev = np.asarray(hover_warm_start(jnp.asarray(x0), C.model))
    tubes = lyapunov.propagate_tubes(
        jnp.asarray(Z_prev), C.model, C.tube, jnp.asarray(C.tube.K)
    )
    E = tubes.E
    yaw = np.arctan2(goal[1] - x0[1], goal[0] - x0[0])
    fapi.pack_stage_params(
        params,
        ref_pos=np.tile(goal[None], (fapi.N, 1)),
        ref_yaw=np.full(fapi.N, yaw),
        external_acc=np.array([0.5, 0.0, 0.0]),      # wind estimate
        corridor_A=np.asarray(A), corridor_b=np.asarray(b),
        tube_E=np.asarray(E),
    )
    fapi.pack_warm_start(
        params, np.asarray(hover_warm_start(jnp.asarray(x0), C.model))
    )

    solver = fapi.ForcesSolver("normal")
    output, exitflag, info = solver.solve(params)
    print(f"exitflag={exitflag} it={info.it} solvetime={info.solvetime*1e3:.1f}ms "
          f"res_eq={info.res_eq:.2e} pobj={info.pobj:.3f}")
    for k in (1, 10, 20):
        z = output[f"x{k:02d}"]
        print(f"  x{k:02d}: pos=({z[8]:+.3f},{z[9]:+.3f},{z[10]:+.3f}) "
              f"thrust={z[3]:.2f}")
    assert exitflag == 1


if __name__ == "__main__":
    main()
