"""Fleet closed loop on the card: B scenarios through search + batched NMPC.

Measures the config-3-at-scale Monte-Carlo shape (engine/fleet.py):
batched kinodynamic searches (the HOT LOOP 1 reformulation,
kinodynamic_astar.cpp:17-286) and full batched pipeline steps per wall
second, plus flight outcomes.

Usage: python tools/fleet_probe.py [B] [duration_s]   (default 128 4.0)
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def fleet_cfg():
    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG

    return dataclasses.replace(
        DEFAULT_CONFIG,
        map=dataclasses.replace(
            DEFAULT_CONFIG.map, size=(12.0, 12.0, 4.0),
            origin=(-6.0, -6.0, -1.0),
        ),
        # expand_width=16/max_rounds=24 measured SLOWER (7.2 s vs 3.6 s
        # per batched search at B=128): the wider frontier pays more per
        # lockstep round without halving the round count
        # clearance_inflate stays at the reference's 1.5: round-5
        # attribution traced the fleet panics to the missing ancillary
        # feedback loop (engine/fleet.py), not to front-end clearance —
        # with the tube-gain feedback closed, 1.5 and 2.5 both reach
        # 128/128 (the knob remains available for narrower scenes)
        search=dataclasses.replace(
            DEFAULT_CONFIG.search, expand_width=8, node_capacity=4096,
            max_rounds=32,
        ),
        corridor=dataclasses.replace(
            DEFAULT_CONFIG.corridor, max_obstacles=512, shrink_iters=8,
            max_obs_planes=12,
        ),
    )


def fleet_scene(cfg, dtype):
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.mapping import occ_grid as og

    grid = og.make_grid(cfg.map, dtype)
    ys = np.arange(-4.0, 4.0, 0.1)
    zs = np.arange(0.0, 2.6, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1)
    pts = pts[~((pts[:, 1] > 0.3) & (pts[:, 1] < 2.1))]
    grid = og.set_occupancy(
        grid, jnp.asarray(pts, dtype), jnp.ones(len(pts), bool), cfg.map
    )
    obs, mask = og.occupied_cloud(grid, cfg.map, 2048)
    return grid, obs, mask


def fleet_lanes(B, seed=5):
    """(starts (B, 9), goals (B, 3), true forces (B, 3)) through the gap.

    Goals thread the gap with >= 0.6 m lateral clearance: the tube + ego
    demand ~0.7 m; tighter lanes honestly fail by tube-tightened
    infeasibility (the scenario knob, not a solver property)."""
    rng = np.random.default_rng(seed)
    starts = np.zeros((B, 9))
    starts[:, 0] = -0.5
    starts[:, 1] = rng.uniform(0.8, 1.6, B)
    starts[:, 2] = 1.2
    goals = np.stack(
        [np.full(B, 3.2), rng.uniform(0.9, 1.5, B), np.full(B, 1.2)], -1
    )
    return starts, goals, rng.uniform(-0.5, 0.5, (B, 3))


def main(B, duration):
    import bench

    bench.require_gpu()
    bench.setup_cache()
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.engine import fleet

    cfg = fleet_cfg()
    dtype = jnp.float32
    grid, obs, mask = fleet_scene(cfg, dtype)
    starts, goals, f_true = fleet_lanes(B)

    # warm-up run (compiles searches + pipeline at this B)
    _ = fleet.run_fleet(
        cfg, grid, jnp.asarray(obs, dtype), mask, starts, goals, f_true,
        duration=0.25, replan_every=10, dtype=dtype,
    )

    # batched front-end search throughput (HOT LOOP 1 at fleet scale)
    import jax

    from forces_resilient_planner_tpu.search import kinodynamic as kd

    z3 = jnp.zeros(3, dtype)
    goals_j = jnp.asarray(goals, dtype)
    f_j = jnp.asarray(f_true, dtype)

    @jax.jit
    def search_only(st):
        r = jax.vmap(
            lambda s, g, e: kd.search(
                grid, s[0:3], s[3:6], z3, g, z3, e, False,
                cfg.search, cfg.tube, cfg.map,
            )
        )(st, goals_j, f_j)
        return r.status, r.n_edges

    st0 = jnp.asarray(starts, dtype)
    np.asarray(search_only(st0)[0])
    slat = []
    for s in range(4):
        stp = st0 + jnp.asarray(
            np.random.default_rng(s).normal(0, 1e-3, st0.shape), dtype
        )
        t0 = time.perf_counter()
        np.asarray(search_only(stp)[0])
        slat.append(time.perf_counter() - t0)
    search_ms = float(np.median(slat) * 1e3)

    res = fleet.run_fleet(
        cfg, grid, jnp.asarray(obs, dtype), mask, starts, goals, f_true,
        duration=duration, replan_every=10, dtype=dtype,
    )
    out = dict(
        B=B,
        duration_s=duration,
        wall_s=round(res.wall_s, 2),
        reached_frac=res.reached_frac,
        collided_frac=res.collided_frac,
        solved_frac=round(res.solved_frac, 4),
        mean_final_dist=round(res.mean_final_dist, 3),
        searches=res.searches,
        scenario_steps_per_s=round(res.batch * res.n_ticks / res.wall_s, 1),
        realtime_factor=round(B * duration / res.wall_s, 1),
        batched_search_ms=round(search_ms, 1),
        searches_per_s=round(B / (search_ms / 1e3), 1),
        # round-5 attribution: every lane's fate + solver exit families
        outcomes=res.outcome_counts,
        tick_code_fracs={k: round(v, 4) for k, v in res.tick_code_fracs.items()},
        mean_time_to_goal=round(float(np.nanmean(res.time_to_goal)), 2)
        if np.isfinite(res.time_to_goal).any() else None,
        infeas_tick_lanes=int((res.infeas_ticks > 0).sum()),
        panic_exit_codes={
            str(c): int((res.panic_exit_code[res.outcome == 3] == c).sum())
            for c in np.unique(res.panic_exit_code[res.outcome == 3])
        },
    )
    print(json.dumps(out), flush=True)
    # per-outcome detail for failed lanes: where did they end up?
    import collections

    fail = res.outcome != 1
    if fail.any():
        d = np.linalg.norm(res.final_states[:, 0:3] - goals, axis=-1)
        by = collections.defaultdict(list)
        for i in np.flatnonzero(fail):
            by[int(res.outcome[i])].append(round(float(d[i]), 2))
        for code, dists in sorted(by.items()):
            from forces_resilient_planner_tpu.engine.fleet import OUTCOME_NAMES

            print(
                f"[fleet] {OUTCOME_NAMES[code]}: {len(dists)} lanes, "
                f"final dist to goal {sorted(dists)[:12]}"
                f"{'...' if len(dists) > 12 else ''}",
                flush=True,
            )


if __name__ == "__main__":
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    d = float(sys.argv[2]) if len(sys.argv) > 2 else 4.0
    main(B, d)
