"""Safe-flight-corridor generation: ellipsoid decomposition, array-shaped.

Re-expression of DecompROS' line-segment decomposition
(decomp_util/line_segment.h:134-211, decomp_util/decomp_base.h:63-83,
decomp_geometry/{ellipsoid,polyhedron}.h) as fixed-shape, bounded-iteration
masked array programs: every data-dependent `while obstacles remain` loop
becomes a fixed-trip fori_loop with an obstacle validity mask, so the whole
corridor pipeline jits and vmaps over (stages x scenarios).

Differences from the reference (documented, deliberate):
  - iteration caps: ellipsoid shrink loops and the supporting-hyperplane
    loop run a fixed number of rounds (CorridorConfig.shrink_iters /
    max_obs_planes).  The reference loops until the inside-set empties;
    caps are chosen so realistic scenes converge, and the polyhedron loop
    is capped at 24 obstacle planes + 6 bbox walls = nh = 30 rows
    (setup.m:36).  The reference's C++ wrapper silently truncates to the
    first 30 rows and can drop bbox walls (forces_normal.cpp:118-129);
    here bbox walls always survive.
  - obstacle buffers are fixed-size (max_obstacles) with a validity mask.

The planner always calls dilate with offset_x = 0
(ellipsoid_decomp.h:62-86), so the offset branch of find_ellipsoid is
specialized away.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from forces_resilient_planner_tpu.config import CorridorConfig
from forces_resilient_planner_tpu.dynamics.quadrotor import euler_to_rot

_PREC = jax.lax.Precision.HIGHEST
_BIG = 1e30


def _mm(a, b):
    """True-f32 (or f64) matrix product: no TF32 on tensor cores."""
    return jnp.matmul(a, b, precision=_PREC)


def _ellipsoid_C(Rf, axes):
    """C = Rf diag(axes) Rf^T."""
    return _mm(Rf * axes[None, :], Rf.T)


def seed_rotation(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Line-aligned frame with zero roll (geometric_utils.h:27-35)."""
    v = p2 - p1
    pitch = jnp.arctan2(-v[2], jnp.linalg.norm(v[:2]))
    yaw = jnp.arctan2(v[1], v[0])
    rpy = jnp.stack([jnp.zeros_like(pitch), pitch, yaw])
    return euler_to_rot(rpy)


class Ellipsoid(NamedTuple):
    C: jnp.ndarray  # (3, 3)
    d: jnp.ndarray  # (3,)


def inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse (adjugate / det).

    jnp.linalg.inv lowers to pivoted LU — a large HLO that blows up
    compile time when it appears inside scan bodies (the decomposition
    loops call it every iteration).  The adjugate form is ~30 elementwise
    ops and keeps compiles fast.
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = -(d * i - f * g)
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack(
        [
            jnp.stack([co00, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([co01, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([co02, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def ellipsoid_dist(E: Ellipsoid, pts: jnp.ndarray) -> jnp.ndarray:
    """||C^{-1}(p - d)|| (decomp_geometry/ellipsoid.h:19-21).

    Written as scalar-expanded elementwise ops instead of an einsum: the
    batched (lanes, M, 3) dot output is exactly the kind of intermediate
    XLA materializes in HBM, and the decomposition loops call this every
    round — elementwise form fuses into one pass over (lanes, M).
    """
    Cinv = inv3(E.C)
    r0 = pts[..., 0] - E.d[..., 0, None]
    r1 = pts[..., 1] - E.d[..., 1, None]
    r2 = pts[..., 2] - E.d[..., 2, None]
    q0 = Cinv[..., 0, 0, None] * r0 + Cinv[..., 0, 1, None] * r1 + Cinv[..., 0, 2, None] * r2
    q1 = Cinv[..., 1, 0, None] * r0 + Cinv[..., 1, 1, None] * r1 + Cinv[..., 1, 2, None] * r2
    q2 = Cinv[..., 2, 0, None] * r0 + Cinv[..., 2, 1, None] * r1 + Cinv[..., 2, 2, None] * r2
    return jnp.sqrt(q0 * q0 + q1 * q1 + q2 * q2)


def _closest_masked(dists: jnp.ndarray, mask: jnp.ndarray):
    d = jnp.where(mask, dists, _BIG)
    idx = jnp.argmin(d)
    return idx, d[idx]


def find_ellipsoid(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    obs: jnp.ndarray,
    obs_mask: jnp.ndarray,
    cfg: CorridorConfig,
) -> Ellipsoid:
    """Sphere-seeded iterative axis shrink (line_segment.h:134-211, offset=0)."""
    dtype = p1.dtype
    f = 0.5 * jnp.linalg.norm(p1 - p2)
    f = jnp.maximum(f, 1e-6)
    Ri = seed_rotation(p1, p2)
    d = 0.5 * (p1 + p2)
    eps = cfg.epsilon

    E0 = Ellipsoid(C=f * jnp.eye(3, dtype=dtype), d=d)
    dist0 = ellipsoid_dist(E0, obs)
    inside0 = obs_mask & (dist0 <= 1.0)

    axes0 = jnp.array([f, f, f], dtype)

    # ---- phase 1: shrink middle axis (b), re-rolling the frame ----------
    def phase1(carry, _):
        axes, Rf, inside = carry
        E = Ellipsoid(
            C=_ellipsoid_C(Rf, jnp.stack([axes[0], axes[1], axes[1]])),
            d=d,
        )
        dists = ellipsoid_dist(E, obs)
        any_inside = jnp.any(inside)
        idx, _ = _closest_masked(dists, inside)
        pw = obs[idx]
        p_loc = _mm(Ri.T, pw - d)
        roll = jnp.arctan2(p_loc[2], p_loc[1])
        cr, sr = jnp.cos(roll), jnp.sin(roll)
        Rx = jnp.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]], dtype)
        Rf_new = _mm(Ri, Rx)
        p_r = _mm(Rf_new.T, pw - d)
        denom = 1.0 - (p_r[0] / axes[0]) ** 2
        b_new = jnp.where(
            (p_r[0] < axes[0]) & (denom > 1e-12),
            jnp.abs(p_r[1]) / jnp.sqrt(jnp.maximum(denom, 1e-12)),
            axes[1],
        )
        axes_new = axes.at[1].set(b_new)
        Rf_out = jnp.where(any_inside, Rf_new, Rf)
        axes_out = jnp.where(any_inside, axes_new, axes)
        E_new = Ellipsoid(
            C=_ellipsoid_C(
                Rf_out, jnp.stack([axes_out[0], axes_out[1], axes_out[1]])),
            d=d,
        )
        new_dists = ellipsoid_dist(E_new, obs)
        inside_new = inside & (1.0 - new_dists > eps)
        inside_out = jnp.where(any_inside, inside_new, inside)
        return (axes_out, Rf_out, inside_out), None

    (axes1, Rf, _), _ = jax.lax.scan(
        phase1, (axes0, Ri, inside0), None, length=cfg.shrink_iters
    )

    # ---- phase 2: shrink vertical axis (c), frame fixed ------------------
    # reset with old axes[2] (= f) and re-filter from the *initial* inside set
    axes2_init = jnp.array([axes1[0], axes1[1], f], dtype)
    E2 = Ellipsoid(C=_ellipsoid_C(Rf, axes2_init), d=d)
    inside2 = obs_mask & (ellipsoid_dist(E2, obs) <= 1.0) & (dist0 <= 1.0)

    def phase2(carry, _):
        axes, inside = carry
        E = Ellipsoid(C=_ellipsoid_C(Rf, axes), d=d)
        dists = ellipsoid_dist(E, obs)
        any_inside = jnp.any(inside)
        idx, _ = _closest_masked(dists, inside)
        pw = obs[idx]
        p_r = _mm(Rf.T, pw - d)
        dd = 1.0 - (p_r[0] / axes[0]) ** 2 - (p_r[1] / axes[1]) ** 2
        c_new = jnp.where(
            dd > eps, jnp.abs(p_r[2]) / jnp.sqrt(jnp.maximum(dd, 1e-12)), axes[2]
        )
        axes_new = axes.at[2].set(c_new)
        axes_out = jnp.where(any_inside, axes_new, axes)
        E_new = Ellipsoid(C=_ellipsoid_C(Rf, axes_out), d=d)
        inside_new = inside & (1.0 - ellipsoid_dist(E_new, obs) > eps)
        inside_out = jnp.where(any_inside, inside_new, inside)
        return (axes_out, inside_out), None

    (axes_f, _), _ = jax.lax.scan(
        phase2, (axes2_init, inside2), None, length=cfg.shrink_iters
    )
    return Ellipsoid(C=_ellipsoid_C(Rf, axes_f), d=d)


class PlaneSet(NamedTuple):
    points: jnp.ndarray   # (P, 3) plane anchor points
    normals: jnp.ndarray  # (P, 3) outward normals
    valid: jnp.ndarray    # (P,) bool


def find_polyhedron(
    E: Ellipsoid, obs: jnp.ndarray, obs_mask: jnp.ndarray, max_planes: int
) -> PlaneSet:
    """Supporting-hyperplane peeling (decomp_base.h:63-83).

    Each round: take the ellipsoid-closest remaining obstacle, add the
    tangent plane there (normal C^{-1}C^{-T}(p-d), ellipsoid.h:52-57),
    discard obstacles strictly outside (signed_dist >= 0 removed:
    decomp_base.h:71-74 keeps < 0).
    """
    dtype = obs.dtype
    Cinv = inv3(E.C)
    M = _mm(Cinv, Cinv.T)

    def round_fn(remain, _):
        any_left = jnp.any(remain)
        dists = ellipsoid_dist(E, obs)
        idx, _ = _closest_masked(dists, remain)
        pw = obs[idx]
        n = _mm(M, pw - E.d)
        n = n / jnp.maximum(jnp.linalg.norm(n), 1e-12)
        sd = jnp.einsum("j,nj->n", n, obs - pw[None], precision=_PREC)
        remain_new = remain & (sd < 0)
        remain_out = jnp.where(any_left, remain_new, remain)
        pt = jnp.where(any_left, pw, jnp.zeros(3, dtype))
        nn = jnp.where(any_left, n, jnp.zeros(3, dtype))
        return remain_out, (pt, nn, any_left)

    _, (pts, ns, valid) = jax.lax.scan(
        round_fn, obs_mask, None, length=max_planes
    )
    return PlaneSet(points=pts, normals=ns, valid=valid)


def local_bbox_planes(
    p1: jnp.ndarray, p2: jnp.ndarray, bbox: jnp.ndarray
) -> PlaneSet:
    """6 virtual walls aligned to the segment (line_segment.h:47-85)."""
    dtype = p1.dtype
    v = p2 - p1
    dirv = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
    dir_h = jnp.array([dirv[1], -dirv[0], 0.0], dtype)
    nh = jnp.linalg.norm(dir_h)
    dir_h = jnp.where(nh < 1e-12, jnp.array([-1.0, 0.0, 0.0], dtype), dir_h / jnp.maximum(nh, 1e-12))
    dir_v = jnp.cross(dirv, dir_h)
    pts = jnp.stack(
        [
            p1 + dir_h * bbox[1],
            p1 - dir_h * bbox[1],
            p2 + dirv * bbox[0],
            p1 - dirv * bbox[0],
            p1 + dir_v * bbox[2],
            p1 - dir_v * bbox[2],
        ]
    )
    ns = jnp.stack([dir_h, -dir_h, dirv, -dirv, dir_v, -dir_v])
    return PlaneSet(points=pts, normals=ns, valid=jnp.ones(6, bool))


def bbox_filter_obstacles(
    p1: jnp.ndarray, p2: jnp.ndarray, bbox: jnp.ndarray,
    obs: jnp.ndarray, obs_mask: jnp.ndarray, eps: float,
) -> jnp.ndarray:
    """set_obs keeps only points inside the local bbox (decomp_base.h:33-38,
    polyhedron.h inside() is epsilon-tolerant)."""
    ps = local_bbox_planes(p1, p2, bbox)
    sd = jnp.einsum("pj,nj->pn", ps.normals, obs, precision=_PREC) - jnp.einsum(
        "pj,pj->p", ps.normals, ps.points, precision=_PREC
    )[:, None]
    inside = jnp.all(sd <= eps, axis=0)
    return obs_mask & inside


def planes_to_constraints(
    planes: PlaneSet, interior: jnp.ndarray, nh: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Outward-oriented A x <= b (polyhedron.h:98-147).  Pads to nh rows.

    Invalid rows are zeroed: 0 * x <= 0 is feasible under the solver's
    hu = 1e-5 slack, matching the reference's zero-padding
    (forces_normal.cpp:125-133).
    """
    n = planes.normals
    c = jnp.einsum("pj,pj->p", planes.points, n, precision=_PREC)
    flip = jnp.einsum("pj,j->p", n, interior, precision=_PREC) - c > 0
    sgn = jnp.where(flip, -1.0, 1.0)
    A = n * sgn[:, None]
    b = c * sgn
    A = jnp.where(planes.valid[:, None], A, 0.0)
    b = jnp.where(planes.valid, b, 0.0)
    P = A.shape[0]
    if P < nh:
        A = jnp.concatenate([A, jnp.zeros((nh - P, 3), A.dtype)], axis=0)
        b = jnp.concatenate([b, jnp.zeros((nh - P,), b.dtype)], axis=0)
    return A[:nh], b[:nh]


class CorridorResult(NamedTuple):
    A: jnp.ndarray          # (nh, 3)
    b: jnp.ndarray          # (nh,)
    ellipsoid_C: jnp.ndarray
    ellipsoid_d: jnp.ndarray


def compact_obstacles(
    p1: jnp.ndarray, p2: jnp.ndarray, bbox: jnp.ndarray,
    obs: jnp.ndarray, obs_mask: jnp.ndarray, k: int, eps: float,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather the k in-bbox obstacles closest to the segment midpoint.

    The decomposition loops only ever see in-bbox points (set_obs,
    decomp_base.h:33-38), so when they fit in k slots this is a pure
    reindexing; overflow drops the farthest points first (deviation,
    documented at CorridorConfig.max_active_obstacles).
    """
    mask = bbox_filter_obstacles(p1, p2, bbox, obs, obs_mask, eps)
    mid = 0.5 * (p1 + p2)
    d2 = jnp.sum((obs - mid[None]) ** 2, axis=-1)
    score = jnp.where(mask, d2, jnp.inf)
    neg_score, idx = jax.lax.top_k(-score, k)
    return obs[idx], neg_score > -jnp.inf


def decompose_segment(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    obs: jnp.ndarray,
    obs_mask: jnp.ndarray,
    cfg: CorridorConfig,
    nh: int = 30,
) -> CorridorResult:
    """Full line-segment decomposition -> padded (A, b) with nh rows.

    Row layout: [obstacle planes (max_obs_planes), bbox walls (6)].
    """
    bbox = jnp.asarray(cfg.local_bbox, p1.dtype)
    k = cfg.max_active_obstacles
    if k and k < obs.shape[0]:
        obs, mask = compact_obstacles(
            p1, p2, bbox, obs, obs_mask, k, cfg.epsilon
        )
    else:
        mask = bbox_filter_obstacles(p1, p2, bbox, obs, obs_mask, cfg.epsilon)
    E = find_ellipsoid(p1, p2, obs, mask, cfg)
    obs_planes = find_polyhedron(E, obs, mask, cfg.max_obs_planes)
    wall_planes = local_bbox_planes(p1, p2, bbox)
    planes = PlaneSet(
        points=jnp.concatenate([obs_planes.points, wall_planes.points]),
        normals=jnp.concatenate([obs_planes.normals, wall_planes.normals]),
        valid=jnp.concatenate([obs_planes.valid, wall_planes.valid]),
    )
    mid = 0.5 * (p1 + p2)
    A, b = planes_to_constraints(planes, mid, nh)
    return CorridorResult(A=A, b=b, ellipsoid_C=E.C, ellipsoid_d=E.d)
