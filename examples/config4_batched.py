"""BASELINE config 4: 4096 parallel NMPC solves (goal x wind x corridor) on
one chip.  This is bench.py's scenario with diagnostics."""
import time

import numpy as np

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))



def main():
    import jax
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    from forces_resilient_planner_tpu.engine import batch as bm

    print("device:", jax.devices()[0])
    rng = np.random.default_rng(0)
    goals = rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (256, 3))
    forces = rng.uniform(-1.5, 1.5, (16, 3))
    halves = np.array([[5.0, 5.0, 2.0]])
    scen = bm.make_scenarios(C, goals, forces, halves, dtype=jnp.float32)
    print("batch:", scen.batch)

    t0 = time.perf_counter()
    res = bm.solve_scenarios(scen, C)
    _ = np.asarray(res.Z)
    print(f"compile+first solve: {time.perf_counter()-t0:.1f} s")

    rng2 = np.random.default_rng(1)
    scen2 = bm.make_scenarios(
        C, rng2.uniform([-3, -3, 1.0], [3, 3, 1.6], (256, 3)),
        rng2.uniform(-1.5, 1.5, (16, 3)), halves, dtype=jnp.float32,
    )
    t0 = time.perf_counter()
    res = bm.solve_scenarios(scen2, C)
    ec = np.asarray(res.exit_code)
    dt = time.perf_counter() - t0
    stats = bm.sweep_stats(res)
    print(f"steady solve: {dt*1e3:.1f} ms -> {scen.batch/dt:.0f} solves/s")
    print(f"solved {ec.mean()*100:.1f}% | mean iters {float(stats.mean_iters):.1f} "
          f"| max kkt (solved) {float(stats.max_kkt_solved):.1e}")


if __name__ == "__main__":
    main()
