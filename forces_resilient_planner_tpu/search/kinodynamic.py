"""Kinodynamic front-end search, batch-shaped.

Re-design of path_searching/src/kinodynamic_astar.cpp (priority-queue
best-first search over a double-integrator lattice) as a bounded-round
batched frontier expansion with fixed-size tables:

  - node pool: fixed-capacity struct-of-arrays; a dense voxel->slot table
    replaces the hash map (kinodynamic_astar.h:66-97) — exact dedup,
    O(1) gather/scatter.
  - each round expands the top-K open nodes by f-score simultaneously
    (K = SearchConfig.expand_width); K=1 reproduces the reference's strict
    best-first order, larger K trades node-order parity for batched
    throughput (path feasibility/quality is preserved, SURVEY.md section 7).
  - the disturbance bias is kept: every input sample has external_acc
    added in the state transition (stateTransit, kinodynamic_astar.cpp:
    828-845).
  - the 125-input lattice (+-max_acc step max_acc/2), duration tau =
    max_tau, init-expansion with start_acc over 8 sub-durations, per-axis
    velocity gate, 15-substep collision check via OccMap::checkState,
    same-voxel pruning, Pontryagin quartic heuristic and the one-shot
    cubic connection all follow kinodynamic_astar.cpp:17-424.

Returns the reference's status codes: REACH_HORIZON=1, REACH_END=2,
NO_PATH=3, REACH_END_BUT_SHOT_FAILS=4 (kinodynamic_astar.h:160).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import MapConfig, SearchConfig, TubeConfig
from forces_resilient_planner_tpu.mapping import occ_grid as og

_PREC = jax.lax.Precision.HIGHEST

REACH_HORIZON = 1
REACH_END = 2
NO_PATH = 3
REACH_END_BUT_SHOT_FAILS = 4

_INF = 1e30


def state_transit(state: jnp.ndarray, um: jnp.ndarray, ext_acc: jnp.ndarray,
                  tau: jnp.ndarray) -> jnp.ndarray:
    """Double integrator with disturbance bias (kinodynamic_astar.cpp:828-845)."""
    a = um + ext_acc
    p = state[..., :3] + state[..., 3:] * tau[..., None] + 0.5 * tau[..., None] ** 2 * a
    v = state[..., 3:] + tau[..., None] * a
    return jnp.concatenate([p, v], axis=-1)


# ---------------------------------------------------------------------------
# Pontryagin heuristic: quartic root closed form (kinodynamic_astar.cpp:322-501)
# ---------------------------------------------------------------------------
def _cubic_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d (3 slots, nan = absent)."""
    a2 = b / a
    a1 = c / a
    a0 = d / a
    Q = (3 * a1 - a2 * a2) / 9.0
    R = (9 * a1 * a2 - 27 * a0 - 2 * a2**3) / 54.0
    D = Q**3 + R * R
    sqD = jnp.sqrt(jnp.abs(D))
    # D > 0: one real root
    S = jnp.cbrt(R + sqD)
    T = jnp.cbrt(R - sqD)
    r1_pos = -a2 / 3 + (S + T)
    # D < 0: three real roots
    theta = jnp.arccos(jnp.clip(R / jnp.sqrt(jnp.maximum(-(Q**3), 1e-300)), -1, 1))
    sq = 2 * jnp.sqrt(jnp.maximum(-Q, 0.0))
    r1_neg = sq * jnp.cos(theta / 3) - a2 / 3
    r2_neg = sq * jnp.cos((theta + 2 * math.pi) / 3) - a2 / 3
    r3_neg = sq * jnp.cos((theta + 4 * math.pi) / 3) - a2 / 3
    nan = jnp.full_like(a2, jnp.nan)
    pos = D > 0
    return (
        jnp.where(pos, r1_pos, r1_neg),
        jnp.where(pos, nan, r2_neg),
        jnp.where(pos, nan, r3_neg),
    )


def _quartic_roots(a, b, c, d, e):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e (4 slots, nan = absent);
    Ferrari via resolvent cubic, mirroring kinodynamic_astar.cpp:426-501."""
    a3 = b / a
    a2 = c / a
    a1 = d / a
    a0 = e / a
    y1, _, _ = _cubic_roots(
        jnp.ones_like(a3), -a2, a1 * a3 - 4 * a0, 4 * a2 * a0 - a1**2 - a3**2 * a0
    )
    r = a3**2 / 4 - a2 + y1
    bad = r < 0
    R = jnp.sqrt(jnp.maximum(r, 0.0))
    nz = R != 0
    termR = jnp.where(
        nz,
        0.75 * a3**2 - R**2 - 2 * a2,
        0.75 * a3**2 - 2 * a2,
    )
    inner = jnp.where(
        nz,
        0.25 * (4 * a3 * a2 - 8 * a1 - a3**3) / jnp.where(nz, R, 1.0),
        2 * jnp.sqrt(jnp.maximum(y1**2 - 4 * a0, 0.0))
        * jnp.sign(jnp.maximum(y1**2 - 4 * a0, 0.0)),
    )
    D2 = termR + inner
    E2 = termR - inner
    nanv = jnp.full_like(a3, jnp.nan)
    Dv = jnp.where(D2 >= 0, jnp.sqrt(jnp.maximum(D2, 0.0)), jnp.nan)
    Ev = jnp.where(E2 >= 0, jnp.sqrt(jnp.maximum(E2, 0.0)), jnp.nan)
    r1 = -a3 / 4 + R / 2 + Dv / 2
    r2 = -a3 / 4 + R / 2 - Dv / 2
    r3 = -a3 / 4 - R / 2 + Ev / 2
    r4 = -a3 / 4 - R / 2 - Ev / 2
    return tuple(jnp.where(bad, nanv, r) for r in (r1, r2, r3, r4))


def estimate_heuristic(x1: jnp.ndarray, x2: jnp.ndarray, w_time: float,
                       max_vel: float, tie_breaker: float):
    """Minimum of int ||u||^2 + w_time over double-integrator connections
    (kinodynamic_astar.cpp:322-357).  Returns (heu, optimal_time)."""
    dp = x2[..., :3] - x1[..., :3]
    v0 = x1[..., 3:6]
    v1 = x2[..., 3:6]
    c1 = -36.0 * jnp.sum(dp * dp, -1)
    c2 = 24.0 * jnp.sum((v0 + v1) * dp, -1)
    c3 = -4.0 * (jnp.sum(v0 * v0, -1) + jnp.sum(v0 * v1, -1) + jnp.sum(v1 * v1, -1))
    c4 = jnp.zeros_like(c1)
    c5 = jnp.full_like(c1, w_time)
    roots = _quartic_roots(c5, c4, c3, c2, c1)
    t_bar = jnp.max(jnp.abs(dp), -1) / max_vel
    ts = jnp.stack(list(roots) + [t_bar], axis=-1)

    def cost_of(t):
        ok = jnp.isfinite(t) & (t >= t_bar[..., None]) & (t > 1e-12)
        tt = jnp.where(ok, t, 1.0)
        c = (
            -c1[..., None] / (3 * tt**3)
            - c2[..., None] / (2 * tt**2)
            - c3[..., None] / tt
            + w_time * tt
        )
        return jnp.where(ok, c, _INF)

    costs = cost_of(ts)
    k = jnp.argmin(costs, axis=-1)
    cost = jnp.take_along_axis(costs, k[..., None], -1)[..., 0]
    t_d = jnp.take_along_axis(ts, k[..., None], -1)[..., 0]
    cost = jnp.where(jnp.isfinite(cost) & (cost < _INF), cost, _INF)
    t_d = jnp.where(cost < _INF, t_d, t_bar)
    return (1.0 + tie_breaker) * cost, t_d


# ---------------------------------------------------------------------------
# one-shot cubic connection (computeShotTraj, kinodynamic_astar.cpp:359-424)
# ---------------------------------------------------------------------------
def compute_shot(
    grid: og.OccGrid, state1: jnp.ndarray, state2: jnp.ndarray, t_d: jnp.ndarray,
    scfg: SearchConfig, tcfg: TubeConfig, mcfg: MapConfig,
):
    """Cubic polynomial p(t) = d + c t + b t^2 + a t^3 hitting state2 at t_d.
    Velocity/acceleration limit checks are disabled (matching the commented
    `return false` at kinodynamic_astar.cpp:403-407); bounds + collision
    checks are enabled.  Returns (coef (3,4) low->high, ok)."""
    p0 = state1[:3]
    dp = state2[:3] - p0
    v0 = state1[3:6]
    v1 = state2[3:6]
    dv = v1 - v0
    td = jnp.maximum(t_d, 1e-4)
    a = (-12.0 / td**3 * (dp - v0 * td) + 6.0 / td**2 * dv) / 6.0
    b = 0.5 * (6.0 / td**2 * (dp - v0 * td) - 2.0 / td * dv)
    coef = jnp.stack([p0, v0, b, a], axis=-1)  # (3, 4)

    ts = (jnp.arange(1, 11, dtype=state1.dtype) / 10.0) * td  # t_delta = td/10
    tp = jnp.stack([jnp.ones_like(ts), ts, ts**2, ts**3], axis=-1)     # (10,4)
    tv = jnp.stack([jnp.zeros_like(ts), jnp.ones_like(ts), 2 * ts, 3 * ts**2], -1)
    pos = jnp.matmul(tp, coef.T, precision=_PREC)   # (10, 3)
    vel = jnp.matmul(tv, coef.T, precision=_PREC)
    half = jnp.asarray(
        [mcfg.size[0] / 2, mcfg.size[1] / 2, mcfg.size[2] / 2], state1.dtype
    )
    in_bounds = jnp.all(
        (pos[:, 0] > -half[0]) & (pos[:, 0] < half[0])
        & (pos[:, 1] > -half[1]) & (pos[:, 1] < half[1])
        & (pos[:, 2] > 0.1) & (pos[:, 2] < half[2])
    )
    free = jax.vmap(
        lambda p, v: og.check_state(
            grid, p, v, scfg.clearance_inflate, tcfg.ego_r, tcfg.ego_h, mcfg
        )
    )(pos, vel)
    ok = in_bounds & jnp.all(free)
    return coef, ok


# ---------------------------------------------------------------------------
# main search
# ---------------------------------------------------------------------------
class SearchResult(NamedTuple):
    status: jnp.ndarray          # REACH_* codes
    # path as edges root->leaf: parent states + (input, duration) per edge
    edge_states: jnp.ndarray     # (D, 6) parent state of each edge
    edge_inputs: jnp.ndarray     # (D, 3)
    edge_durs: jnp.ndarray       # (D,)
    n_edges: jnp.ndarray
    term_state: jnp.ndarray      # (6,) terminate-node state
    shot_coef: jnp.ndarray       # (3, 4)
    shot_time: jnp.ndarray
    shot_ok: jnp.ndarray
    iterations: jnp.ndarray


def _input_lattice(scfg: SearchConfig, dtype) -> jnp.ndarray:
    ax = np.arange(-scfg.max_acc, scfg.max_acc + 1e-3, scfg.max_acc * 0.5)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    return jnp.asarray(g, dtype)  # (125, 3)


MAX_EDGES = 64


def search(
    grid: og.OccGrid,
    start_p: jnp.ndarray, start_v: jnp.ndarray, start_a: jnp.ndarray,
    end_p: jnp.ndarray, end_v: jnp.ndarray,
    ext_acc: jnp.ndarray,
    init_search: bool,
    scfg: SearchConfig, tcfg: TubeConfig, mcfg: MapConfig,
) -> SearchResult:
    dtype = start_p.dtype
    C = scfg.node_capacity
    K = scfg.expand_width
    shape = mcfg.grid_shape
    n_vox = shape[0] * shape[1] * shape[2]
    res = scfg.resolution
    origin = jnp.asarray(mcfg.origin, dtype)
    half = jnp.asarray([mcfg.size[0] / 2, mcfg.size[1] / 2, mcfg.size[2] / 2], dtype)
    tol = math.ceil(1.0 / scfg.resolution)

    def pos_to_vox(p):
        # search uses its own resolution grid (posToIndex, line 808-813)
        return jnp.floor((p - origin) / res).astype(jnp.int32)

    def vox_key(v):
        return v[..., 0] * (shape[1] * shape[2]) + v[..., 1] * shape[2] + v[..., 2]

    end_state = jnp.concatenate([end_p, end_v])
    end_vox = pos_to_vox(end_p)

    # node tables
    states = jnp.zeros((C, 6), dtype)
    g_sc = jnp.full((C,), _INF, dtype)
    f_sc = jnp.full((C,), _INF, dtype)
    parent = jnp.full((C,), -1, jnp.int32)
    inputs_t = jnp.zeros((C, 3), dtype)
    durs_t = jnp.zeros((C,), dtype)
    status = jnp.zeros((C,), jnp.int32)
    vox_tab = jnp.full((n_vox,), -1, jnp.int32)

    s0 = jnp.concatenate([start_p, start_v])
    h0, _ = estimate_heuristic(s0, end_state, scfg.w_time, scfg.max_vel, scfg.tie_breaker)
    states = states.at[0].set(s0)
    g_sc = g_sc.at[0].set(0.0)
    f_sc = f_sc.at[0].set(scfg.lambda_heu * h0)
    status = status.at[0].set(1)
    vox_tab = vox_tab.at[vox_key(pos_to_vox(start_p))].set(0)
    n_used = jnp.asarray(1, jnp.int32)

    lattice = _input_lattice(scfg, dtype)  # (125, 3)
    n_lat = lattice.shape[0]

    def check_collision(cur_state, um, tau):
        """15-substep collision sweep (kinodynamic_astar.cpp:190-201)."""
        ks = jnp.arange(1, scfg.check_num + 1, dtype=dtype) / scfg.check_num
        n = scfg.check_num
        xt = state_transit(
            jnp.tile(cur_state[None], (n, 1)),
            jnp.tile(um[None], (n, 1)),
            ext_acc,
            tau * ks,
        )
        free = jax.vmap(
            lambda s: og.check_state(
                grid, s[:3], s[3:], scfg.clearance_inflate, tcfg.ego_r,
                tcfg.ego_h, mcfg,
            )
        )(xt)
        return jnp.all(free)

    def expand(tbl, parent_ids, cand_states, cand_inputs, cand_durs,
               cand_parent_g, cand_ok):
        """Insert candidate batch into tables.  cand_*: (M, ...)."""
        states, g_sc, f_sc, parent, inputs_t, durs_t, status, vox_tab, n_used = tbl
        M = cand_states.shape[0]
        pos = cand_states[:, :3]
        vel = cand_states[:, 3:]

        in_b = (
            (pos[:, 0] > -half[0]) & (pos[:, 0] < half[0])
            & (pos[:, 1] > -half[1]) & (pos[:, 1] < half[1])
            & (pos[:, 2] > 0.1) & (pos[:, 2] < half[2])
        )
        vel_ok = jnp.all(jnp.abs(vel) <= scfg.max_vel, axis=-1)
        vox = pos_to_vox(pos)
        key = vox_key(vox)
        parent_vox = pos_to_vox(states[parent_ids][:, :3])
        not_same = jnp.any(vox != parent_vox, axis=-1)

        coll_free = jax.vmap(check_collision)(
            states[parent_ids], cand_inputs, cand_durs
        )

        gn = (jnp.sum(cand_inputs**2, -1) + scfg.w_time) * cand_durs + cand_parent_g
        heu, _ = estimate_heuristic(
            cand_states, end_state[None], scfg.w_time, scfg.max_vel, scfg.tie_breaker
        )
        fn = gn + scfg.lambda_heu * heu

        slot = vox_tab[jnp.clip(key, 0, n_vox - 1)]
        closed = (slot >= 0) & (status[jnp.clip(slot, 0, C - 1)] == 2)
        valid = cand_ok & in_b & vel_ok & not_same & coll_free & ~closed

        # intra-batch dedup: min-f per voxel key
        skey = jnp.where(valid, key, n_vox)
        order = jnp.lexsort((fn, skey))
        k_sorted = skey[order]
        first = jnp.concatenate(
            [jnp.asarray([True]), k_sorted[1:] != k_sorted[:-1]]
        )
        keep = first & (k_sorted < n_vox)
        # gather back in sorted order
        cs = cand_states[order]
        ci = cand_inputs[order]
        cd = cand_durs[order]
        cp = parent_ids[order]
        cg = gn[order]
        cf = fn[order]
        ck = k_sorted
        cslot = vox_tab[jnp.clip(ck, 0, n_vox - 1)]

        is_new = keep & (cslot < 0)
        improve = keep & (cslot >= 0) & (cg < g_sc[jnp.clip(cslot, 0, C - 1)]) & (
            status[jnp.clip(cslot, 0, C - 1)] == 1
        )

        new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        new_slot = n_used + new_rank
        cap_ok = new_slot < C
        is_new = is_new & cap_ok
        write_slot = jnp.where(is_new, new_slot, jnp.where(improve, cslot, C))

        states = states.at[write_slot].set(cs, mode="drop")
        g_sc = g_sc.at[write_slot].set(cg, mode="drop")
        f_sc = f_sc.at[write_slot].set(cf, mode="drop")
        parent = parent.at[write_slot].set(cp, mode="drop")
        inputs_t = inputs_t.at[write_slot].set(ci, mode="drop")
        durs_t = durs_t.at[write_slot].set(cd, mode="drop")
        status = status.at[write_slot].set(1, mode="drop")
        vox_tab = vox_tab.at[jnp.where(is_new, ck, n_vox)].set(
            new_slot, mode="drop"
        )
        n_used = (n_used + jnp.sum(is_new.astype(jnp.int32))).astype(jnp.int32)
        return (states, g_sc, f_sc, parent, inputs_t, durs_t, status, vox_tab, n_used)

    tbl = (states, g_sc, f_sc, parent, inputs_t, durs_t, status, vox_tab, n_used)

    # --- init expansion: start_acc over 8 sub-durations (lines 119-125) ----
    if init_search:
        j = jnp.arange(1, scfg.init_sub_durations + 1, dtype=dtype)
        taus = j * (scfg.init_max_tau / scfg.init_sub_durations)
        cs = state_transit(
            jnp.tile(s0[None], (scfg.init_sub_durations, 1)),
            jnp.tile(start_a[None], (scfg.init_sub_durations, 1)),
            ext_acc,
            taus[:, None][:, 0],
        )
        pids = jnp.zeros((scfg.init_sub_durations,), jnp.int32)
        tbl = expand(
            tbl, pids, cs,
            jnp.tile(start_a[None], (scfg.init_sub_durations, 1)),
            taus, jnp.zeros((scfg.init_sub_durations,), dtype),
            jnp.ones((scfg.init_sub_durations,), bool),
        )
        # close the root
        tbl = tbl[:6] + (tbl[6].at[0].set(2),) + tbl[7:]

    # root termination pre-check (the reference checks on first pop; with the
    # init pre-expansion the root is already closed, so check explicitly)
    root_vox = pos_to_vox(start_p)
    root_done = jnp.all(jnp.abs(root_vox - end_vox) <= tol)

    # --- main loop ---------------------------------------------------------
    def cond(carry):
        tbl, it, done, term = carry
        status = tbl[6]
        any_open = jnp.any(status == 1)
        return (~done) & (it < scfg.max_rounds) & any_open

    def body(carry):
        tbl, it, done, term = carry
        (states, g_sc, f_sc, parent, inputs_t, durs_t, status, vox_tab, n_used) = tbl
        f_open = jnp.where(status == 1, f_sc, _INF)
        neg_top, top_idx = jax.lax.top_k(-f_open, K)
        top_valid = -neg_top < _INF

        best = top_idx[0]
        best_p = states[best, :3]
        best_vox = pos_to_vox(best_p)
        near_end = jnp.all(jnp.abs(best_vox - end_vox) <= tol)
        reach_hor = jnp.linalg.norm(best_p - start_p) >= scfg.horizon
        terminate = near_end | reach_hor
        term_new = jnp.where(terminate, best, term)
        done_new = terminate

        # close the expanded nodes
        status = status.at[jnp.where(top_valid, top_idx, C)].set(2, mode="drop")
        tbl = (states, g_sc, f_sc, parent, inputs_t, durs_t, status, vox_tab, n_used)

        # expansion: K x 125 candidates, tau = max_tau (time_res = 1)
        tau = jnp.asarray(scfg.max_tau, dtype)
        par_states = states[top_idx]                       # (K, 6)
        cs = state_transit(
            par_states[:, None, :].repeat(n_lat, 1).reshape(-1, 6),
            jnp.tile(lattice[None], (K, 1, 1)).reshape(-1, 3),
            ext_acc,
            jnp.full((K * n_lat,), tau, dtype),
        )
        pids = jnp.where(top_valid, top_idx, 0)[:, None].repeat(n_lat, 1).reshape(-1)
        pg = g_sc[pids]
        cinp = jnp.tile(lattice[None], (K, 1, 1)).reshape(-1, 3)
        cdur = jnp.full((K * n_lat,), tau, dtype)
        cok = top_valid[:, None].repeat(n_lat, 1).reshape(-1)
        tbl = expand(tbl, pids, cs, cinp, cdur, pg, cok)

        return (tbl, it + 1, done_new, term_new)

    carry = (tbl, jnp.asarray(0, jnp.int32), root_done, jnp.asarray(0, jnp.int32))
    tbl, iters, done, term = jax.lax.while_loop(cond, body, carry)
    (states, g_sc, f_sc, parent, inputs_t, durs_t, status, vox_tab, n_used) = tbl

    # --- retrieve path root->leaf ------------------------------------------
    def back_step(idx, _):
        nxt = jnp.where(idx >= 0, parent[jnp.clip(idx, 0, C - 1)], -1)
        return nxt, idx

    _, chain = jax.lax.scan(back_step, term, None, length=MAX_EDGES + 1)
    # chain: leaf, parent, ..., root, -1, -1...
    valid_chain = chain >= 0
    n_nodes = jnp.sum(valid_chain.astype(jnp.int32))
    n_edges = jnp.maximum(n_nodes - 1, 0)
    # edges root->leaf: edge j connects chain[n_nodes-1-j-1]'s parent... we
    # need per-edge (parent state, input, duration) = child node's fields
    child_pos = n_edges - 1 - jnp.arange(MAX_EDGES)   # reversed order
    child_idx = jnp.where(
        (child_pos >= 0) & (child_pos < MAX_EDGES + 1),
        chain[jnp.clip(child_pos, 0, MAX_EDGES)],
        -1,
    )
    ci = jnp.clip(child_idx, 0, C - 1)
    edge_states = states[jnp.clip(parent[ci], 0, C - 1)]
    edge_inputs = inputs_t[ci]
    edge_durs = jnp.where(child_idx >= 0, durs_t[ci], 0.0)

    term_state = states[jnp.clip(term, 0, C - 1)]

    # --- termination classification + one-shot ------------------------------
    term_vox = pos_to_vox(term_state[:3])
    near_end = jnp.all(jnp.abs(term_vox - end_vox) <= tol) & done
    _, t_shot = estimate_heuristic(
        term_state, end_state, scfg.w_time, scfg.max_vel, scfg.tie_breaker
    )
    coef, shot_ok_raw = compute_shot(
        grid, term_state, end_state, t_shot, scfg, tcfg, mcfg
    )
    shot_ok = shot_ok_raw & near_end

    no_parent = parent[jnp.clip(term, 0, C - 1)] < 0
    stat = jnp.where(
        near_end & shot_ok,
        REACH_END,
        jnp.where(
            near_end & no_parent & ~shot_ok,
            NO_PATH,
            jnp.where(
                near_end & ~shot_ok,
                REACH_END_BUT_SHOT_FAILS,
                jnp.where(done, REACH_HORIZON, NO_PATH),
            ),
        ),
    )

    return SearchResult(
        status=stat,
        edge_states=edge_states,
        edge_inputs=edge_inputs,
        edge_durs=edge_durs,
        n_edges=n_edges,
        term_state=term_state,
        shot_coef=coef,
        shot_time=t_shot,
        shot_ok=shot_ok,
        iterations=iters,
    )


# ---------------------------------------------------------------------------
# trajectory sampling (getKinoTraj, kinodynamic_astar.cpp:648-695)
# ---------------------------------------------------------------------------
MAX_SAMPLES = 512
_EDGE_S = 11  # max samples per edge: max_tau/Ts + 1


def get_kino_traj(
    result: SearchResult, ext_acc: jnp.ndarray, delta_t: float,
    max_samples: int = MAX_SAMPLES,
):
    """Resample the found path at delta_t.  Returns (path (S,3), size).

    Faithful to the reference's per-edge sampling t = tau, tau-dt, ..., >=0
    (then globally reversed), including the duplicate samples at interior
    nodes; plus the one-shot cubic tail sampled at t = dt..t_shot.
    """
    dtype = result.edge_states.dtype
    D = result.edge_states.shape[0]

    # per-edge sample counts and ascending times
    nk = jnp.floor(result.edge_durs / delta_t + 1e-5).astype(jnp.int32) + 1
    nk = jnp.where(jnp.arange(D) < result.n_edges, nk, 0)
    j = jnp.arange(_EDGE_S)
    t_asc = result.edge_durs[:, None] - (nk[:, None] - 1 - j[None]) * delta_t
    valid_e = j[None] < nk[:, None]

    pts_e = state_transit(
        result.edge_states[:, None, :].repeat(_EDGE_S, 1).reshape(-1, 6),
        result.edge_inputs[:, None, :].repeat(_EDGE_S, 1).reshape(-1, 3),
        ext_acc,
        jnp.maximum(t_asc.reshape(-1), 0.0),
    )[:, :3]
    valid_e = valid_e.reshape(-1)

    # shot tail
    n_shot_f = jnp.floor(result.shot_time / delta_t + 1e-9).astype(jnp.int32)
    n_shot = jnp.where(result.shot_ok, jnp.minimum(n_shot_f, max_samples), 0)
    ts = (jnp.arange(1, max_samples + 1, dtype=dtype)) * delta_t
    tp = jnp.stack([jnp.ones_like(ts), ts, ts**2, ts**3], axis=-1)
    pts_s = tp @ result.shot_coef.T
    valid_s = jnp.arange(max_samples) < n_shot

    all_pts = jnp.concatenate([pts_e, pts_s], axis=0)
    all_valid = jnp.concatenate([valid_e, valid_s])

    # stable compaction into a fixed buffer
    order = jnp.argsort(~all_valid, stable=True)
    out = all_pts[order[:max_samples]]
    size = jnp.minimum(jnp.sum(all_valid.astype(jnp.int32)), max_samples)
    out = jnp.where(jnp.arange(max_samples)[:, None] < size, out, out[0][None])
    return out, size


# ---------------------------------------------------------------------------
# auxiliary path queries (getCurPos / getSamples,
# kinodynamic_astar.cpp:593-806) — cold-path host utilities kept for API
# parity; the planner's hot path uses get_kino_traj.
# ---------------------------------------------------------------------------
def get_cur_pos(result: SearchResult, ext_acc, index_time: float,
                max_tau: float, end_pt) -> np.ndarray:
    """Position at a time offset along the path (getCurPos, 593-643).

    Mirrors the reference's assumption that every edge has duration max_tau
    (it indexes state_list with index_time / max_tau_).
    """
    ext = np.asarray(ext_acc, float)
    n_edges = int(result.n_edges)
    states = np.asarray(result.edge_states, float)
    inputs = np.asarray(result.edge_inputs, float)
    if index_time < n_edges * max_tau:
        k = int(index_time / max_tau)
        tau = index_time % max_tau
        x0 = states[k]
        a = inputs[k] + ext
        return x0[:3] + x0[3:] * tau + 0.5 * tau * tau * a
    t_shot = float(result.shot_time)
    coef = np.asarray(result.shot_coef, float)
    if index_time < n_edges * max_tau + t_shot:
        if bool(result.shot_ok):
            tau = index_time - n_edges * max_tau
            tv = np.array([1.0, tau, tau**2, tau**3])
            return coef @ tv
        return np.asarray(result.term_state[:3], float)
    if bool(result.shot_ok):
        return np.asarray(end_pt, float)
    return np.asarray(result.term_state[:3], float)


def get_samples(result: SearchResult, ext_acc, ts: float):
    """Uniform resampling with boundary derivatives (getSamples, 699-806).

    Returns (point_set list root->goal, [start_vel, end_vel, start_acc,
    end_acc]).
    """
    ext = np.asarray(ext_acc, float)
    n_edges = int(result.n_edges)
    durs = np.asarray(result.edge_durs, float)[:n_edges]
    states = np.asarray(result.edge_states, float)[:n_edges]
    inputs = np.asarray(result.edge_inputs, float)[:n_edges]
    shot_ok = bool(result.shot_ok)
    t_shot = float(result.shot_time) if shot_ok else 0.0
    coef = np.asarray(result.shot_coef, float)

    T_sum = float(durs.sum()) + t_shot
    if T_sum <= 0:
        return [], []
    K = int(T_sum / ts)
    ts_eff = T_sum / (K + 1)

    pts = []
    seg = n_edges  # n_edges = shot segment marker; edges are 0..n_edges-1
    t = t_shot if shot_ok else (durs[-1] if n_edges else 0.0)
    if not shot_ok:
        seg = n_edges - 1
    ti = T_sum
    while ti > -1e-5:
        if shot_ok and seg == n_edges:
            tv = np.array([1.0, t, t**2, t**3])
            pts.append(coef @ tv)
            t -= ts_eff
            if t < -1e-5:
                seg -= 1
                if seg >= 0:
                    t += durs[seg]
        else:
            x0 = states[seg]
            a = inputs[seg] + ext
            pts.append(x0[:3] + x0[3:] * t + 0.5 * t * t * a)
            t -= ts_eff
            if t < -1e-5 and seg > 0:
                seg -= 1
                t += durs[seg]
        ti -= ts_eff
    pts.reverse()

    start_vel = states[0, 3:] if n_edges else np.zeros(3)
    if shot_ok:
        end_vel = coef @ np.array([0.0, 1.0, 2 * t_shot, 3 * t_shot**2])
        end_acc = coef @ np.array([0.0, 0.0, 2.0, 6 * t_shot])
    else:
        last = states[-1] if n_edges else np.zeros(6)
        end_vel = last[3:] + durs[-1] * (inputs[-1] + ext) if n_edges else np.zeros(3)
        end_acc = inputs[-1] if n_edges else np.zeros(3)
    start_acc = inputs[0] if n_edges else np.zeros(3)
    return pts, [np.asarray(start_vel), np.asarray(end_vel),
                 np.asarray(start_acc), np.asarray(end_acc)]
