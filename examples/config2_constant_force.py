"""BASELINE config 2: constant external force with tube-tightened constraints.

Runs the full pipeline step (tubes + tightening + solve) under a constant
disturb-manager style wind and shows how much the corridor rows tightened.
"""
import numpy as np

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))



def main():
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    from forces_resilient_planner_tpu.engine.pipeline import nmpc_step
    from forces_resilient_planner_tpu.solver.problems import hover_warm_start

    dtype = jnp.float32
    x0 = np.zeros(9); x0[2] = 1.2
    Z = np.asarray(hover_warm_start(jnp.asarray(x0, dtype), C.model))
    mpc_output = jnp.asarray(np.concatenate([Z, Z[-1:]]), dtype)
    K = 128
    t = np.arange(K) * C.model.dt
    path = np.stack([1.5 * t, np.zeros(K), np.full(K, 1.2)], -1)
    res = nmpc_step(
        mpc_output, jnp.asarray(path, dtype), jnp.asarray(K),
        jnp.asarray(0.0, dtype), jnp.asarray(x0, dtype),
        jnp.asarray([1.2, -0.5, 0.2], dtype),      # constant wind [m/s^2]
        jnp.asarray(path[-1], dtype),
        jnp.zeros((64, 3), dtype), jnp.zeros(64, bool),
        jnp.asarray(False), cfg=C,
    )
    print(f"exit={int(res.exit_code)} iters={int(res.iters)}")
    tighten = np.asarray(res.corridor_b - res.corridor_b_tight)
    rows = np.linalg.norm(np.asarray(res.corridor_A), axis=-1) > 1e-9
    print(f"tube tightening margin: mean {tighten[rows].mean():.3f} m, "
          f"max {tighten[rows].max():.3f} m (grows along horizon)")
    print("stage-0 vs stage-19 ellipsoid radius:",
          float(np.linalg.norm(np.asarray(res.tube_E[0]), 2)), "->",
          float(np.linalg.norm(np.asarray(res.tube_E[-1]), 2)))


if __name__ == "__main__":
    main()
