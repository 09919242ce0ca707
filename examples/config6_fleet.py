"""Config 6: fleet-scale batched closed loop (engine/fleet.py).

B scenarios (start x goal x wind) flown SIMULTANEOUSLY through the full
stack — batched kinodynamic search, the kernelized nmpc_step, device-side
plant, per-lane fail ladders — on one chip.  The Monte-Carlo shape the
reference's one-robot 20 Hz loop cannot express.

Runs on JAX's default device at f32 (set JAX_PLATFORMS=cpu to run on
the CPU); tools/fleet_probe.py runs the benchmarked configuration
(B=128).
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))


def main(B=8, duration=5.0):
    import jax.numpy as jnp

    import fleet_probe as fp

    from forces_resilient_planner_tpu.engine import fleet

    cfg = fp.fleet_cfg()
    dtype = jnp.float32
    grid, obs, mask = fp.fleet_scene(cfg, dtype)
    starts, goals, f_true = fp.fleet_lanes(B)

    res = fleet.run_fleet(
        cfg, grid, jnp.asarray(obs, dtype), mask, starts, goals, f_true,
        duration=duration, replan_every=10, dtype=dtype,
    )
    print(
        f"fleet B={B}: reached {res.reached_frac:.2f} "
        f"collided {res.collided_frac:.3f} solver-success "
        f"{res.solved_frac:.3f} searches {res.searches} "
        f"wall {res.wall_s:.1f}s "
        f"(aggregate realtime x{B * duration / res.wall_s:.1f}) "
        f"outcomes={res.outcome_counts}"
    )


if __name__ == "__main__":
    main(
        B=int(sys.argv[1]) if len(sys.argv) > 1 else 8,
        duration=float(sys.argv[2]) if len(sys.argv) > 2 else 5.0,
    )
