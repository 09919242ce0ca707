"""BASELINE config 3: full obstacle scene — corridor sequence + kinodynamic
front-end + time-varying force, closed loop.  Dumps an HTML scene."""
import dataclasses

import numpy as np

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))



def main():
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.engine.planner import ResilientPlanner
    from forces_resilient_planner_tpu.engine.simulator import QuadSim, run_closed_loop
    from forces_resilient_planner_tpu.utils.scene import dump_scene

    C = dataclasses.replace(
        DEFAULT_CONFIG,
        map=dataclasses.replace(
            DEFAULT_CONFIG.map, size=(16.0, 16.0, 4.0), origin=(-8.0, -8.0, -1.0)
        ),
        search=dataclasses.replace(
            DEFAULT_CONFIG.search, expand_width=8, node_capacity=4096, max_rounds=48
        ),
    )
    planner = ResilientPlanner(C, max_cloud=2048, dtype=jnp.float32)
    x0 = np.zeros(9); x0[2] = 1.2
    sim = QuadSim(C.model, x0.copy(), np.zeros(3))
    planner.on_odometry(x0)

    # fence with a gap
    ys = np.arange(-3, 3, 0.1); zs = np.arange(0, 2.6, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1)
    planner.set_occupied(pts[~((pts[:, 1] > -0.2) & (pts[:, 1] < 1.6))])

    def wind(t):
        return np.array([0.8 * np.sin(0.5 * t), 0.0, 0.0])  # time-varying

    trace = run_closed_loop(planner, sim, [3.5, 0.0], duration=7.0,
                            force_schedule=wind, record_plans=True)
    final = trace["pos"][-1]
    print("final position:", np.round(final, 3),
          "| solves:", planner.diag.solves,
          "| replans:", planner.diag.replans)
    out = dump_scene(
        "scene_config3.html",
        traj=trace["pos"][:: len(trace["pos"]) // 200 + 1],
        ref=planner.kino_path[: planner.kino_size],
        goal=planner.end_pt,
        obstacles=planner.obstacles[planner.obstacle_mask][:800],
        kino_path=planner.kino_path[: planner.kino_size],
        meta={"solves": planner.diag.solves, "final": final.tolist()},
    )
    # animated replay (play button + scrubber): the rviz-session analog
    from forces_resilient_planner_tpu.utils.scene import dump_replay

    dump_replay(
        "replay_config3.html", trace, planner.end_pt,
        obstacles=planner.obstacles[planner.obstacle_mask][:800],
        meta={"solves": planner.diag.solves, "final": final.tolist()},
    )
    print("scene dumped to", out)


if __name__ == "__main__":
    main()
