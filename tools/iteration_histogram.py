"""Print the monotone-schedule iteration histogram of bench.py's workload
(tier 16/0.25)."""
import dataclasses
import time
from pathlib import Path

import numpy as np

sys_path_root = str(Path(__file__).resolve().parents[1])
import sys as _sys
if sys_path_root not in _sys.path:
    _sys.path.insert(0, sys_path_root)


def main():
    import bench

    bench.setup_cache()

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.engine import batch as bm

    C = dataclasses.replace(
        DEFAULT_CONFIG,
        solver=dataclasses.replace(
            DEFAULT_CONFIG.solver, tier_phase1=16, tier_frac=0.25
        ),
    )
    halves = np.array([[5.0, 5.0, 2.0]])
    n_goals, n_forces = 256, 16

    def seeds(seed):
        rng = np.random.default_rng(seed)
        goals = rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (n_goals, 3))
        forces = rng.uniform(-1.5, 1.5, (n_forces, 3))
        return goals, forces

    g0, f0 = seeds(1)
    t0 = time.perf_counter()
    r = bm.solve_scenario_grid(C, g0, f0, halves)
    _ = np.asarray(r.Z)
    print(f"first call: {time.perf_counter()-t0:.1f}s", flush=True)

    its = []
    for s in range(6):
        g, f = seeds(1000 + s)
        r = bm.solve_scenario_grid(C, g, f, halves)
        its.append(np.asarray(r.iters))
    it = np.concatenate(its)
    hist = {int(k): int(v) for k, v in zip(*np.unique(it, return_counts=True))}
    n = it.size
    print(f"monotone iters: mean={it.mean():.2f} max={it.max()} n={n}")
    print("hist:", hist)
    cum = 0
    for k in sorted(hist, reverse=True):
        cum += hist[k]
        print(f"  >={k}: {cum/n*100:.2f}%")


if __name__ == "__main__":
    main()
