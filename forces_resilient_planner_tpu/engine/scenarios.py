"""Realistic corridor-rich scenario generators, shared by tests and tools.

The fence scenes produce scenarios whose corridors come from REAL
ellipsoid decompositions (corridor/decomp.py) with genuinely active
non-bbox rows — the workload family used by tests/test_sharding_realism.py
(sharded bit-exactness) — and per-lane raw pipeline inputs
(pipeline_lanes) for the batched-pipeline benchmark and its on-device
checks.  Deterministic per (B, seed).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG, PlannerConfig
from forces_resilient_planner_tpu.corridor.decomp import decompose_segment
from forces_resilient_planner_tpu.solver import nlp
from forces_resilient_planner_tpu.solver.problems import hover_warm_start


def fence_scene() -> np.ndarray:
    """Fence with a gap at y in (0, 1.2), plus a second staggered fence."""
    pts = []
    for x, gap_lo, gap_hi in ((1.5, 0.0, 1.2), (3.0, -1.2, 0.0)):
        ys = np.arange(-3.0, 3.0, 0.15)
        zs = np.arange(0.0, 2.6, 0.15)
        yy, zz = np.meshgrid(ys, zs)
        keep = ~((yy.ravel() > gap_lo) & (yy.ravel() < gap_hi))
        pts.append(
            np.stack(
                [np.full(keep.sum(), x), yy.ravel()[keep], zz.ravel()[keep]],
                -1,
            )
        )
    return np.concatenate(pts, axis=0)


def corridor_scenarios(
    cfg: PlannerConfig, B: int, dtype=jnp.float64, seed: int = 42
):
    """B scenarios threading the fence gaps; corridors from real per-stage
    segment decompositions (build_corridors' inner op).  Returns a
    ScenarioSet (engine/batch.py)."""
    from forces_resilient_planner_tpu.engine import batch as bm

    mcfg = cfg.model
    N = mcfg.N
    rng = np.random.default_rng(seed)
    obs_np = fence_scene()
    M = cfg.corridor.max_obstacles
    sel = rng.choice(len(obs_np), size=min(M, len(obs_np)), replace=False)
    obs = jnp.asarray(obs_np[sel], dtype)
    mask = jnp.ones(len(sel), bool)

    x0 = np.zeros(9)
    x0[2] = 1.2
    goals = rng.uniform([3.8, -2.0, 1.0], [4.5, 2.0, 1.6], (B, 3))
    forces = rng.uniform(-1.0, 1.0, (B, 3))

    # reference: piecewise line start -> gap1 -> gap2 -> goal, walked at a
    # per-scenario reference speed <= v_max so the horizon's references stay
    # dynamically reachable (the kino front-end resamples at Ts=0.05 the
    # same way); scenarios differ in speed and gap entry point, so stages
    # near the fence get genuinely different corridor decompositions
    gap1 = np.stack(
        [np.full(B, 1.5), rng.uniform(0.2, 1.0, B), np.full(B, 1.2)], -1
    )
    wp = np.stack(
        [
            np.tile(x0[:3], (B, 1)),
            gap1,
            np.tile([3.0, -0.6, 1.2], (B, 1)),
            goals,
        ],
        axis=1,
    )  # (B, 4, 3)
    seg = np.linalg.norm(np.diff(wp, axis=1), axis=-1)  # (B, 3)
    cum = np.concatenate([np.zeros((B, 1)), np.cumsum(seg, axis=1)], axis=1)
    v_ref = rng.uniform(1.0, 1.9, (B, 1))
    s = np.minimum(
        np.arange(N)[None] * mcfg.dt * v_ref, cum[:, -1:]
    )
    ref_pos = np.stack(
        [
            np.stack(
                [np.interp(s[b], cum[b], wp[b, :, k]) for k in range(3)], -1
            )
            for b in range(B)
        ],
        0,
    )  # (B, N, 3)
    d = np.diff(ref_pos, axis=1)
    yaw = np.arctan2(d[:, :, 1], d[:, :, 0])
    ref_yaw = np.concatenate([yaw, yaw[:, -1:]], axis=1)  # (B, N)

    seed2 = ref_pos + cfg.corridor.seed_len * np.stack(
        [np.cos(ref_yaw), np.sin(ref_yaw), np.zeros_like(ref_yaw)], -1
    )

    dec = jax.jit(
        jax.vmap(
            jax.vmap(
                lambda p1, p2: decompose_segment(
                    p1, p2, obs, mask, cfg.corridor, mcfg.nh
                )
            )
        )
    )(jnp.asarray(ref_pos, dtype), jnp.asarray(seed2, dtype))
    A, b = dec.A, dec.b  # (B, N, nh, 3), (B, N, nh)

    weights = nlp.make_stage_weights(cfg.weights, N, final=False, dtype=dtype)
    weights_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), weights
    )
    params = nlp.NLPParams(
        xinit=jnp.broadcast_to(jnp.asarray(x0, dtype)[None], (B, 9)),
        ref_pos=jnp.asarray(ref_pos, dtype),
        ref_yaw=jnp.asarray(ref_yaw, dtype),
        f_ext=jnp.asarray(forces, dtype),
        corridor_A=A,
        corridor_b=b,
        weights=weights_b,
    )
    Z0 = jnp.broadcast_to(
        hover_warm_start(jnp.asarray(x0, dtype), mcfg)[None], (B, N, nlp.NZ)
    )
    return bm.ScenarioSet(Z0=Z0, params=params)


PIPELINE_ARG_KEYS = (
    "mpc_output", "kino_path", "kino_size", "t_offset", "state_mpc",
    "f_ext", "end_pt", "obstacles", "obstacle_mask", "use_final",
)


def pipeline_lanes(
    cfg: PlannerConfig, B: int, seed: int = 0, K: int = 64,
    dtype=np.float32,
) -> dict:
    """B raw nmpc_step_batched input lanes (numpy), each with its own scene.

    Every lane flies from (0, 0, 1.2) through two fences (walls 6 m wide,
    2.6 m high, one 1.2 m gap each) at lane-drawn positions and gap
    offsets, towards a lane-drawn goal behind them.  The fences are
    sampled as cfg.corridor.max_obstacles surface points in generic
    position (continuous uniform, no grid ties), so every lane fills the
    obstacle buffer with its own cloud.  The kinodynamic reference is the
    piecewise-linear path start -> gap 1 -> gap 2 -> goal walked at a
    lane-drawn speed <= v_max; the previous plan is hover at the start.
    Generated in bulk with numpy; keys are PIPELINE_ARG_KEYS."""
    mcfg = cfg.model
    N = mcfg.N
    M = cfg.corridor.max_obstacles
    rng = np.random.default_rng(seed)
    gap = 1.2
    fx = np.stack([rng.uniform(1.2, 1.8, B), rng.uniform(2.8, 3.4, B)], 1)
    glo = np.stack([rng.uniform(-0.6, 0.6, B), rng.uniform(-1.6, -0.4, B)], 1)

    # fence points: y uniform over the wall minus its gap, z over the height
    which = rng.integers(0, 2, (B, M))
    u = rng.uniform(0.0, 6.0 - gap, (B, M))
    lo = np.take_along_axis(glo, which, 1)
    y = -3.0 + u
    y = np.where(y >= lo, y + gap, y)
    obstacles = np.stack(
        [np.take_along_axis(fx, which, 1), y, rng.uniform(0.0, 2.6, (B, M))],
        -1,
    )

    x0 = np.array([0.0, 0.0, 1.2])
    goals = np.stack(
        [rng.uniform(4.2, 5.0, B), rng.uniform(-1.5, 1.5, B),
         rng.uniform(1.0, 1.6, B)], -1,
    )
    wp = np.stack(
        [np.tile(x0, (B, 1)),
         np.stack([fx[:, 0], glo[:, 0] + 0.5 * gap, np.full(B, 1.2)], -1),
         np.stack([fx[:, 1], glo[:, 1] + 0.5 * gap, np.full(B, 1.2)], -1),
         goals],
        axis=1,
    )                                                      # (B, 4, 3)
    seg = np.linalg.norm(np.diff(wp, axis=1), axis=-1)
    cum = np.concatenate([np.zeros((B, 1)), np.cumsum(seg, axis=1)], axis=1)
    v_ref = rng.uniform(1.0, 1.9, (B, 1))
    s = np.minimum(np.arange(K)[None] * mcfg.dt * v_ref, cum[:, -1:])
    # piecewise-linear interpolation of every lane at once
    k = np.clip((s[..., None] >= cum[:, None, 1:]).sum(-1), 0, 2)
    c0 = np.take_along_axis(cum, k, 1)
    c1 = np.take_along_axis(cum, k + 1, 1)
    w = ((s - c0) / np.maximum(c1 - c0, 1e-12))[..., None]
    p0 = np.take_along_axis(wp, k[..., None], 1)
    p1 = np.take_along_axis(wp, (k + 1)[..., None], 1)
    kino_path = p0 + w * (p1 - p0)                         # (B, K, 3)
    kino_size = np.minimum(
        np.ceil(cum[:, -1] / (mcfg.dt * v_ref[:, 0])).astype(np.int32) + 1, K
    )

    hover = np.zeros((N + 1, 17))
    hover[:, 3] = hover[:, 7] = mcfg.hover_thrust
    hover[:, 8:11] = x0
    state = np.zeros((B, 9))
    state[:, 0:3] = x0
    lanes = dict(
        mpc_output=np.broadcast_to(hover, (B, N + 1, 17)),
        kino_path=kino_path,
        kino_size=kino_size.astype(np.int32),
        t_offset=np.zeros(B),
        state_mpc=state,
        f_ext=rng.uniform(-1.0, 1.0, (B, 3)),
        end_pt=goals,
        obstacles=obstacles,
        obstacle_mask=np.ones((B, M), bool),
        use_final=np.zeros(B, bool),
    )
    return {
        k: (np.ascontiguousarray(v, dtype) if v.dtype.kind == "f" else v)
        for k, v in lanes.items()
    }


# the corridor/solver caps the realism suites run at
PARITY_SCENE_CFG = dataclasses.replace(
    DEFAULT_CONFIG,
    solver=dataclasses.replace(
        DEFAULT_CONFIG.solver, tiers=((16, 0.25), (18, 0.0625))
    ),
    corridor=dataclasses.replace(
        DEFAULT_CONFIG.corridor,
        max_obstacles=512, shrink_iters=8, max_obs_planes=12,
    ),
)
