"""Occupancy mapping: log-odds voxel grid + batched raycasting.

Array equivalent of occ_grid/src/occ_map.cpp + raycast.cpp:
  - dense log-odds buffer, linear layout x*ny*nz + y*nz + z
    (occ_map.cpp:92,105), init clamp_min_log (occ_map.cpp:831)
  - voxel state: -1 outside map, 0 outside local window or free,
    1 occupied iff log-odds > min_occupancy_log (occ_map.cpp:95-117)
  - depth-image projection (projectDepthImage, occ_map.cpp:314-439)
  - Amanatides-Woo backward raycast with batched hit/miss log-odds update
    (raycastProcess, occ_map.cpp:441-533).  The per-ray early-break
    dedup caches (cache_traverse_/cache_rayend_) are an incremental-CPU
    optimization; the batched formulation scatters per-voxel hit/total
    counts and applies the same majority rule
    (hit >= all - hit ? hit_log : miss_log) in one pass — identical
    update semantics without sequential caches.
  - collision checks checkPosSurround / checkState (occ_map.cpp:625-684);
    the velocity-oriented two-line test samples lines at sub-resolution
    spacing instead of exact voxel traversal (equivalent coverage).

The grid is a pytree (buffer + local window), all ops jit/vmap-able; shapes
come statically from MapConfig.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import MapConfig

_PREC = jax.lax.Precision.HIGHEST


class OccGrid(NamedTuple):
    buffer: jnp.ndarray      # (nx, ny, nz) float log odds
    local_min: jnp.ndarray   # (3,) local-window bounds [m]
    local_max: jnp.ndarray   # (3,)


def make_grid(cfg: MapConfig, dtype=jnp.float32) -> OccGrid:
    shape = cfg.grid_shape
    origin = jnp.asarray(cfg.origin, dtype)
    size = jnp.asarray(cfg.size, dtype)
    return OccGrid(
        buffer=jnp.full(shape, cfg.clamp_min_log, dtype),
        local_min=origin,
        local_max=origin + size,
    )


def pos_to_index(pos: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    origin = jnp.asarray(cfg.origin, pos.dtype)
    return jnp.floor((pos - origin) / cfg.resolution).astype(jnp.int32)


def in_map(idx: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    shape = jnp.asarray(cfg.grid_shape)
    return jnp.all((idx >= 0) & (idx < shape), axis=-1)


def voxel_state(grid: OccGrid, pos: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """-1 outside map / 0 free (or outside local window) / 1 occupied."""
    idx = pos_to_index(pos, cfg)
    inside = in_map(idx, cfg)
    in_local = jnp.all((pos >= grid.local_min) & (pos <= grid.local_max), axis=-1)
    ic = jnp.clip(idx, 0, jnp.asarray(cfg.grid_shape) - 1)
    occ = grid.buffer[ic[..., 0], ic[..., 1], ic[..., 2]] > cfg.min_occupancy_log
    state = jnp.where(occ & in_local, 1, 0)
    return jnp.where(inside, state, -1)


def set_occupancy(grid: OccGrid, points: jnp.ndarray, mask: jnp.ndarray,
                  cfg: MapConfig) -> OccGrid:
    """Global-map mode: mark voxels occupied (occ_map.cpp:84-93)."""
    idx = pos_to_index(points, cfg)
    ok = mask & in_map(idx, cfg)
    idx = jnp.where(ok[:, None], idx, -1)
    buf = grid.buffer.at[idx[:, 0], idx[:, 1], idx[:, 2]].max(
        jnp.asarray(cfg.clamp_max_log, grid.buffer.dtype), mode="drop"
    )
    return grid._replace(buffer=buf)


def check_pos_surround(
    grid: OccGrid, pos: jnp.ndarray, inflate_ratio: float,
    ego_r: float, ego_h: float, cfg: MapConfig,
) -> jnp.ndarray:
    """True = free box around pos (checkPosSurround, occ_map.cpp:625-643).

    Any voxel state != 0 (occupied or outside map) collides.
    """
    xs = math.ceil(ego_r * inflate_ratio / cfg.resolution)
    zs = math.ceil(ego_h * inflate_ratio / cfg.resolution)
    ox = jnp.arange(-xs, xs + 1, dtype=pos.dtype) * cfg.resolution
    oz = jnp.arange(-zs, zs + 1, dtype=pos.dtype) * cfg.resolution
    dx, dy, dz = jnp.meshgrid(ox, ox, oz, indexing="ij")
    offs = jnp.stack([dx, dy, dz], axis=-1).reshape(-1, 3)
    pts = pos[None, :] + offs
    return jnp.all(voxel_state(grid, pts, cfg) == 0)


def _line_samples(a: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    t = jnp.linspace(0.0, 1.0, n, dtype=a.dtype)[:, None]
    return a[None] + t * (b - a)[None]


def check_state(
    grid: OccGrid, pos: jnp.ndarray, vel: jnp.ndarray, inflate_ratio: float,
    ego_r: float, ego_h: float, cfg: MapConfig,
    n_h: int = 12, n_v: int = 4,
) -> jnp.ndarray:
    """Velocity-oriented two-line free check (checkState, occ_map.cpp:645-684).

    Horizontal chord perpendicular to the horizontal velocity + vertical
    segment; True = free.
    """
    vh = vel[:2]
    vh = jnp.where(jnp.linalg.norm(vh) < 1e-4, jnp.ones(2, pos.dtype), vh)
    cw = jnp.stack([vh[1], -vh[0]])
    cw = cw / jnp.maximum(jnp.linalg.norm(cw), 1e-12) * ego_r * inflate_ratio
    cw3 = jnp.concatenate([cw, jnp.zeros(1, pos.dtype)])
    up = pos + jnp.asarray([0.0, 0.0, ego_h * inflate_ratio], pos.dtype)
    dn = pos - jnp.asarray([0.0, 0.0, ego_h * inflate_ratio], pos.dtype)
    pts = jnp.concatenate(
        [_line_samples(pos + cw3, pos - cw3, n_h), _line_samples(up, dn, n_v)]
    )
    return jnp.all(voxel_state(grid, pts, cfg) == 0)


# ---------------------------------------------------------------------------
# depth projection + raycast update
# ---------------------------------------------------------------------------
def project_depth(
    depth: jnp.ndarray,        # (rows, cols) metric depth [m], <=0 invalid
    R_wc: jnp.ndarray,         # (3, 3) camera-to-world rotation
    t_wc: jnp.ndarray,         # (3,) camera position in world
    cfg: MapConfig,
    fx: float, fy: float, cx: float, cy: float,
):
    """Unproject depth pixels to world points (projectDepthImage,
    occ_map.cpp:314-439, skip_pixel + margin subsampling).
    Returns (points (M,3), valid (M,))."""
    rows, cols = depth.shape
    s = cfg.skip_pixel
    m = cfg.depth_filter_margin
    vs = jnp.arange(m, rows - m, s)
    us = jnp.arange(m, cols - m, s)
    vv, uu = jnp.meshgrid(vs, us, indexing="ij")
    d = depth[vv, uu]
    valid = (d >= cfg.depth_filter_mindist) & jnp.isfinite(d)
    d_eff = jnp.clip(d, 0.0, cfg.depth_filter_maxdist)
    x = (uu.astype(d.dtype) - cx) * d_eff / fx
    y = (vv.astype(d.dtype) - cy) * d_eff / fy
    pc = jnp.stack([x, y, d_eff], axis=-1).reshape(-1, 3)
    pw = jnp.matmul(pc, R_wc.T, precision=_PREC) + t_wc[None]
    return pw, valid.reshape(-1)


def _raycast_voxels(
    start: jnp.ndarray, end: jnp.ndarray, max_steps: int, cfg: MapConfig
):
    """Amanatides-Woo voxel traversal from start to end (world coords), the
    start voxel excluded (raycastProcess skips the projected point's voxel,
    occ_map.cpp:487-489).  Returns (voxels (S,3) int32, valid (S,))."""
    res = cfg.resolution
    s = start / res
    e = end / res
    x0 = jnp.floor(s).astype(jnp.int32)
    x1 = jnp.floor(e).astype(jnp.int32)
    d = e - s
    step = jnp.sign(d).astype(jnp.int32)

    def intbound(sv, dv):
        sv = jnp.mod(jnp.mod(sv, 1.0) + 1.0, 1.0)
        return jnp.where(
            dv > 0, (1.0 - sv) / dv, jnp.where(dv < 0, sv / (-dv), jnp.inf)
        )

    tmax0 = intbound(s, d)
    tdelta = jnp.where(step != 0, jnp.abs(1.0 / jnp.where(d == 0, 1.0, d)), jnp.inf)

    def body(carry, _):
        x, tmax, alive = carry
        axis = jnp.argmin(tmax)
        x_new = x.at[axis].add(step[axis])
        tmax_new = tmax.at[axis].add(tdelta[axis])
        at_end = jnp.all(x == x1)
        alive_new = alive & ~at_end
        x_out = jnp.where(alive_new, x_new, x)
        tmax_out = jnp.where(alive_new, tmax_new, tmax)
        return (x_out, tmax_out, alive_new), (x_out, alive_new)

    (_, _, _), (vox, valid) = jax.lax.scan(
        body, (x0, tmax0, jnp.asarray(True)), None, length=max_steps
    )
    return vox, valid


def raycast_update(
    grid: OccGrid,
    points: jnp.ndarray,      # (M, 3) world-frame depth points
    point_valid: jnp.ndarray, # (M,)
    t_wc: jnp.ndarray,        # (3,) camera position
    cfg: MapConfig,
) -> OccGrid:
    """Batched log-odds update (raycastProcess, occ_map.cpp:441-533)."""
    dtype = grid.buffer.dtype
    shape = cfg.grid_shape
    nynz = shape[1] * shape[2]
    nz = shape[2]
    n_total = shape[0] * nynz
    max_steps = int(cfg.max_ray_length / cfg.resolution * 2 + 4)

    length = jnp.linalg.norm(points - t_wc[None], axis=-1)
    too_short = length < cfg.min_ray_length
    too_long = length > cfg.max_ray_length
    dirn = (points - t_wc[None]) / jnp.maximum(length, 1e-9)[:, None]
    end_pts = jnp.where(
        too_long[:, None], t_wc[None] + dirn * cfg.max_ray_length, points
    )
    use = point_valid & ~too_short
    is_hit = use & ~too_long  # clipped rays mark their end as a miss

    # endpoint votes
    end_idx = pos_to_index(end_pts, cfg)
    end_ok = use & in_map(end_idx, cfg)
    end_flat = jnp.where(
        end_ok,
        end_idx[:, 0] * nynz + end_idx[:, 1] * nz + end_idx[:, 2],
        n_total,  # dropped
    )

    # traversal votes (miss) — vmap the scan over rays
    vox, vvalid = jax.vmap(
        lambda p: _raycast_voxels(p, t_wc, max_steps, cfg)
    )(end_pts)
    vvalid = vvalid & use[:, None]
    vok = vvalid & in_map(vox, cfg)
    vflat = jnp.where(
        vok, vox[..., 0] * nynz + vox[..., 1] * nz + vox[..., 2], n_total
    ).reshape(-1)

    ones_e = jnp.ones(end_flat.shape, dtype)
    hits = jnp.zeros((n_total,), dtype).at[end_flat].add(
        jnp.where(is_hit, 1.0, 0.0), mode="drop"
    )
    total = (
        jnp.zeros((n_total,), dtype)
        .at[end_flat].add(ones_e, mode="drop")
        .at[vflat].add(jnp.ones(vflat.shape, dtype), mode="drop")
    )

    log_update = jnp.where(
        hits >= total - hits, cfg.prob_hit_log, cfg.prob_miss_log
    ).astype(dtype)
    touched = total > 0
    buf = grid.buffer.reshape(-1)
    new_buf = jnp.clip(
        buf + jnp.where(touched, log_update, 0.0),
        cfg.clamp_min_log,
        cfg.clamp_max_log,
    )
    return grid._replace(buffer=new_buf.reshape(shape))


def update_local_window(
    grid: OccGrid, cam_pos: jnp.ndarray, sensor_range: jnp.ndarray
) -> OccGrid:
    """Local map window follows the sensor (occ_map.cpp:273-274)."""
    return grid._replace(
        local_min=cam_pos - sensor_range, local_max=cam_pos + sensor_range
    )


def occupied_cloud(grid: OccGrid, cfg: MapConfig, max_points: int,
                   window_only: bool = True):
    """Extract occupied voxel centers as a fixed-size padded buffer + mask.

    window_only=True is the local_view_cloud (localOccVisCallback,
    occ_map.cpp:177-215: occupied voxels INSIDE the sensor-following
    window) — the cloud the reference feeds corridor generation
    (nmpc_solver.cpp:990-995).  window_only=False is the
    history_view_cloud (globalOccVisCallback, occ_map.cpp:150-175: the
    whole map).
    """
    shape = cfg.grid_shape
    n = shape[0] * shape[1] * shape[2]
    flat = jnp.arange(n)
    iz = flat % shape[2]
    iy = (flat // shape[2]) % shape[1]
    ix = flat // (shape[1] * shape[2])
    origin = jnp.asarray(cfg.origin, grid.buffer.dtype)
    centers = (
        jnp.stack([ix, iy, iz], axis=-1).astype(grid.buffer.dtype) + 0.5
    ) * cfg.resolution + origin

    occ = (grid.buffer > cfg.min_occupancy_log).reshape(-1)
    if window_only:
        occ = occ & jnp.all(
            (centers >= grid.local_min[None])
            & (centers <= grid.local_max[None]),
            axis=-1,
        )
    idx_sorted = jnp.argsort(~occ)  # occupied first (stable)
    sel = idx_sorted[:max_points]
    mask = occ[sel]
    pts = centers[sel]
    return pts, mask


def history_cloud(grid: OccGrid, cfg: MapConfig, max_points: int):
    """Whole-map occupied cloud (history_view_cloud analog,
    occ_map.cpp:150-175)."""
    return occupied_cloud(grid, cfg, max_points, window_only=False)


def project_depth_shift_filter(
    depth: jnp.ndarray,        # current metric depth (rows, cols)
    R_wc: jnp.ndarray, t_wc: jnp.ndarray,
    last_depth: jnp.ndarray,   # previous frame
    last_R_wc: jnp.ndarray, last_t_wc: jnp.ndarray,
    cfg: MapConfig,
    fx: float, fy: float, cx: float, cy: float,
):
    """Temporal-consistency ("shift") depth filter
    (projectDepthImage use_shift_filter branch, occ_map.cpp:357-430).

    Each unprojected point is reprojected into the previous camera frame; it
    is kept if the previous depth there agrees within
    depth_filter_tolerance, or if it reprojects outside the previous image
    (a newly-revealed point).  Returns (points (M,3), valid (M,)).
    """
    pw, valid = project_depth(depth, R_wc, t_wc, cfg, fx, fy, cx, cy)
    # reproject into the last camera frame
    rel = pw - last_t_wc[None]
    pc = jnp.einsum("ji,nj->ni", last_R_wc, rel,
                    precision=_PREC)                  # R^T (p - t)
    z = pc[:, 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    uu = pc[:, 0] * fx / safe_z + cx
    vv = pc[:, 1] * fy / safe_z + cy
    rows, cols = depth.shape
    in_img = (uu >= 0) & (uu < cols) & (vv >= 0) & (vv < rows) & (z > 0)
    ui = jnp.clip(uu.astype(jnp.int32), 0, cols - 1)
    vi = jnp.clip(vv.astype(jnp.int32), 0, rows - 1)
    drift = jnp.abs(last_depth[vi, ui] - z)
    consistent = drift < cfg.depth_filter_tolerance
    keep = valid & (jnp.where(in_img, consistent, True))
    return pw, keep
