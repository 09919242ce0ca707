"""Kinodynamic search tests: heuristic parity vs NumPy transcription,
end-to-end searches on synthetic voxel scenes, disturbance bias."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu.mapping import occ_grid as og
from forces_resilient_planner_tpu.search import kinodynamic as kd

MAP = dataclasses.replace(
    DEFAULT_CONFIG.map, size=(10.0, 10.0, 4.0), origin=(-5.0, -5.0, -1.0)
)
SRCH = dataclasses.replace(
    DEFAULT_CONFIG.search, expand_width=8, node_capacity=4096, max_rounds=64
)
TUBE = DEFAULT_CONFIG.tube
RNG = np.random.default_rng(5)


# ---- NumPy transcription of the heuristic (kinodynamic_astar.cpp:322-501) --
def np_cubic(a, b, c, d):
    a2, a1, a0 = b / a, c / a, d / a
    Q = (3 * a1 - a2 * a2) / 9
    R = (9 * a1 * a2 - 27 * a0 - 2 * a2**3) / 54
    D = Q**3 + R * R
    if D > 0:
        S = np.cbrt(R + np.sqrt(D))
        T = np.cbrt(R - np.sqrt(D))
        return [-a2 / 3 + S + T]
    if D == 0:
        S = np.cbrt(R)
        return [-a2 / 3 + 2 * S, -a2 / 3 - S]
    th = np.arccos(R / np.sqrt(-(Q**3)))
    return [
        2 * np.sqrt(-Q) * np.cos(th / 3) - a2 / 3,
        2 * np.sqrt(-Q) * np.cos((th + 2 * np.pi) / 3) - a2 / 3,
        2 * np.sqrt(-Q) * np.cos((th + 4 * np.pi) / 3) - a2 / 3,
    ]


def np_quartic(a, b, c, d, e):
    a3, a2, a1, a0 = b / a, c / a, d / a, e / a
    ys = np_cubic(1, -a2, a1 * a3 - 4 * a0, 4 * a2 * a0 - a1**2 - a3**2 * a0)
    y1 = ys[0]
    r = a3**2 / 4 - a2 + y1
    if r < 0:
        return []
    R = np.sqrt(r)
    if R != 0:
        D = np.sqrt(max(0.75 * a3**2 - R**2 - 2 * a2
                        + 0.25 * (4 * a3 * a2 - 8 * a1 - a3**3) / R, np.nan))
        E = np.sqrt(max(0.75 * a3**2 - R**2 - 2 * a2
                        - 0.25 * (4 * a3 * a2 - 8 * a1 - a3**3) / R, np.nan))
    else:
        D = np.sqrt(max(0.75 * a3**2 - 2 * a2 + 2 * np.sqrt(y1**2 - 4 * a0), np.nan))
        E = np.sqrt(max(0.75 * a3**2 - 2 * a2 - 2 * np.sqrt(y1**2 - 4 * a0), np.nan))
    out = []
    if not np.isnan(D):
        out += [-a3 / 4 + R / 2 + D / 2, -a3 / 4 + R / 2 - D / 2]
    if not np.isnan(E):
        out += [-a3 / 4 - R / 2 + E / 2, -a3 / 4 - R / 2 - E / 2]
    return out


def np_heuristic(x1, x2, w_time, max_vel, tie_breaker):
    dp = x2[:3] - x1[:3]
    v0, v1 = x1[3:], x2[3:]
    c1 = -36 * dp @ dp
    c2 = 24 * (v0 + v1) @ dp
    c3 = -4 * (v0 @ v0 + v0 @ v1 + v1 @ v1)
    ts = np_quartic(w_time, 0, c3, c2, c1)
    t_bar = np.max(np.abs(dp)) / max_vel
    ts.append(t_bar)
    best, t_d = 1e8, t_bar
    for t in ts:
        if t < t_bar:
            continue
        c = -c1 / (3 * t**3) - c2 / (2 * t**2) - c3 / t + w_time * t
        if c < best:
            best, t_d = c, t
    return (1 + tie_breaker) * best, t_d


def test_heuristic_matches_numpy():
    for _ in range(50):
        x1 = RNG.uniform(-3, 3, 6)
        x2 = RNG.uniform(-3, 3, 6)
        x1[3:] = RNG.uniform(-2, 2, 3)
        x2[3:] = RNG.uniform(-2, 2, 3)
        want, want_t = np_heuristic(
            x1, x2, SRCH.w_time, SRCH.max_vel, SRCH.tie_breaker
        )
        got, got_t = kd.estimate_heuristic(
            jnp.asarray(x1), jnp.asarray(x2),
            SRCH.w_time, SRCH.max_vel, SRCH.tie_breaker,
        )
        assert abs(float(got) - want) < 1e-6 * max(1, abs(want)), (float(got), want)
        assert abs(float(got_t) - want_t) < 1e-6 * max(1, abs(want_t))


def _search(grid, start, goal, v0=None, ext=None, init=False, a0=None):
    v0 = np.zeros(3) if v0 is None else np.asarray(v0)
    ext = np.zeros(3) if ext is None else np.asarray(ext)
    a0 = np.zeros(3) if a0 is None else np.asarray(a0)
    return kd.search(
        grid,
        jnp.asarray(start), jnp.asarray(v0, jnp.float64), jnp.asarray(a0, jnp.float64),
        jnp.asarray(goal), jnp.zeros(3, jnp.float64),
        jnp.asarray(ext, jnp.float64),
        init, SRCH, TUBE, MAP,
    )


def test_free_space_reaches_end():
    grid = og.make_grid(MAP, jnp.float64)
    start = np.array([-3.0, 0.0, 1.2])
    goal = np.array([0.5, 0.5, 1.2])
    res = _search(grid, start, goal)
    assert int(res.status) in (kd.REACH_END, kd.REACH_END_BUT_SHOT_FAILS)
    path, size = kd.get_kino_traj(res, jnp.zeros(3, jnp.float64), 0.05)
    path = np.asarray(path)[: int(size)]
    np.testing.assert_allclose(path[0], start, atol=1e-9)
    # end of sampled path near goal voxel tolerance (1/res = 1.0 m)
    assert np.linalg.norm(path[-1] - goal) < 1.5


def test_wall_with_gap_path_is_collision_free():
    grid = og.make_grid(MAP, jnp.float64)
    # wall at x=0 with a gap around y in [0.8, 2.2] (wider than the
    # 1.5x-inflated ego chord of ~0.81 m)
    ys = np.arange(-5, 5, 0.1)
    zs = np.arange(-1, 3, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.zeros(yy.size), yy.ravel(), zz.ravel()], -1)
    keep = ~((pts[:, 1] > 0.8) & (pts[:, 1] < 2.2) & (pts[:, 2] > 0.5) & (pts[:, 2] < 2.0))
    pts = pts[keep]
    grid = og.set_occupancy(grid, jnp.asarray(pts), jnp.ones(len(pts), bool), MAP)
    start = np.array([-2.5, 1.5, 1.2])
    goal = np.array([2.5, 1.5, 1.2])
    res = _search(grid, start, goal)
    assert int(res.status) in (kd.REACH_END, kd.REACH_END_BUT_SHOT_FAILS, kd.REACH_HORIZON)
    path, size = kd.get_kino_traj(res, jnp.zeros(3, jnp.float64), 0.05)
    path = np.asarray(path)[: int(size)]
    # every sample collision-free w.r.t. the inflated ego box
    for p in path[::3]:
        st = og.voxel_state(grid, jnp.asarray(p), MAP)
        assert int(st) == 0, p
    # it actually crossed the wall
    assert path[-1][0] > 1.0


def test_fully_blocked_returns_no_path():
    grid = og.make_grid(MAP, jnp.float64)
    ys = np.arange(-5, 5, 0.1)
    zs = np.arange(-1, 3, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    for xw in (0.0, 0.1, 0.2):  # thick full wall
        pts = np.stack([np.full(yy.size, xw), yy.ravel(), zz.ravel()], -1)
        grid = og.set_occupancy(grid, jnp.asarray(pts), jnp.ones(len(pts), bool), MAP)
    start = np.array([-2.0, 0.0, 1.2])
    goal = np.array([2.0, 0.0, 1.2])
    res = _search(grid, start, goal)
    assert int(res.status) == kd.NO_PATH


def test_disturbance_bias_changes_inputs_not_feasibility():
    """stateTransit adds external_acc to every sample
    (kinodynamic_astar.cpp:828-845): the planned path must stay feasible
    under the disturbance it assumes."""
    grid = og.make_grid(MAP, jnp.float64)
    start = np.array([-3.0, 0.0, 1.2])
    goal = np.array([0.5, 0.0, 1.2])
    ext = np.array([1.0, 0.5, 0.0])
    res = _search(grid, start, goal, ext=ext)
    assert int(res.status) in (kd.REACH_END, kd.REACH_END_BUT_SHOT_FAILS, kd.REACH_HORIZON)
    # velocities along edges stay within bounds (the expansion gate)
    ns = int(res.n_edges)
    for i in range(ns):
        s1 = kd.state_transit(
            res.edge_states[i], res.edge_inputs[i], jnp.asarray(ext),
            res.edge_durs[i],
        )
        assert np.all(np.abs(np.asarray(s1[3:])) <= SRCH.max_vel + 1e-9)


def test_init_expansion_uses_start_acc():
    grid = og.make_grid(MAP, jnp.float64)
    start = np.array([-3.0, 0.0, 1.2])
    goal = np.array([1.0, 0.0, 1.2])
    a0 = np.array([1.5, 0.0, 0.0])
    res = _search(grid, start, goal, v0=[1.0, 0, 0], init=True, a0=a0)
    assert int(res.status) in (kd.REACH_END, kd.REACH_END_BUT_SHOT_FAILS, kd.REACH_HORIZON)
    # the first edge must carry the start acceleration as its input
    np.testing.assert_allclose(np.asarray(res.edge_inputs[0]), a0, atol=1e-12)


def test_vmapped_search_matches_single():
    """Batched front-end: jax.vmap(kd.search) over scenarios must produce
    exactly the B=1 results lane by lane (fixed shapes, no data-dependent
    control flow — the batched reformulation of HOT LOOP 1,
    kinodynamic_astar.cpp:17-286, batches for free)."""
    grid = og.make_grid(MAP, jnp.float64)
    # a small obstacle block so collision handling is exercised
    ys = np.arange(-1.0, 1.0, 0.1)
    zs = np.arange(0.5, 2.0, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.0), yy.ravel(), zz.ravel()], -1)
    grid = og.set_occupancy(grid, jnp.asarray(pts), jnp.ones(len(pts), bool), MAP)

    B = 4
    rng = np.random.default_rng(11)
    starts = np.array([[-3.0, 0.0, 1.2]] * B) + rng.uniform(-0.3, 0.3, (B, 3))
    goals = np.array([[2.5, 0.5, 1.2]] * B) + rng.uniform(-0.5, 0.5, (B, 3))
    v0s = rng.uniform(-0.5, 0.5, (B, 3))
    exts = rng.uniform(-0.8, 0.8, (B, 3))
    z3 = jnp.zeros(3, jnp.float64)

    batched = jax.vmap(
        lambda s, v, g, e: kd.search(
            grid, s, v, z3, g, z3, e, False, SRCH, TUBE, MAP
        ),
        in_axes=(0, 0, 0, 0),
    )
    rb = batched(
        jnp.asarray(starts), jnp.asarray(v0s), jnp.asarray(goals),
        jnp.asarray(exts),
    )
    for i in range(B):
        ri = kd.search(
            grid, jnp.asarray(starts[i]), jnp.asarray(v0s[i]), z3,
            jnp.asarray(goals[i]), z3, jnp.asarray(exts[i]),
            False, SRCH, TUBE, MAP,
        )
        for name, bv, sv in zip(rb._fields, rb, ri):
            np.testing.assert_array_equal(
                np.asarray(bv[i]), np.asarray(sv),
                err_msg=f"lane {i} field {name}",
            )
