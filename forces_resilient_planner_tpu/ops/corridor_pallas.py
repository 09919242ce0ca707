"""Pallas kernel (Triton route): whole-horizon safe-flight-corridor decomposition.

The XLA formulation (engine/pipeline.py::build_corridors, a vmap of
corridor/decomp.py::decompose_segment over scenarios and stages) runs ~56
masked fixed-point rounds per stage (ellipsoid shrink x2 + hyperplane
peel).  Each round is a rolled scan step that re-reads the (B, M, 3)
obstacle buffer and writes (B, N, M) distance arrays through device
memory; XLA cannot fuse across the scan steps.

This kernel runs one program per scenario.  The program loads the
scenario's obstacle cloud (M x 3 f32, 24 KB at M = 2048) into registers
once and runs every stage's complete decomposition (bbox filter,
sphere-seeded shrink, supporting-hyperplane peel, bbox walls,
outward-oriented rows) on it.  Each round's closest obstacle is one
block-wide argmin; its coordinates come back as one scalar load.

Numerics vs corridor/decomp.py (same math, different expression):
  - ellipsoid distances use the diagonal form ||diag(1/a) Rf^T (p-d)||
    instead of inv3(C) (identical for C = Rf diag(a) Rf^T);
  - rotation angles are never materialized: cos/sin come from normalized
    vector components (atan2-free);
  - argmin ties select the lowest index, like _closest_masked.
Parity: tests/test_ops.py (interpret mode, f64) vs decompose_segment.

Reference anchors: decomp_util/line_segment.h:47-211,
decomp_util/decomp_base.h:33-83, decomp_geometry/polyhedron.h:98-147,
nmpc_solver.cpp:288-332 (2-point seed usage).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from forces_resilient_planner_tpu.config import CorridorConfig

NH = 30
NUM_WARPS = 4
# below this many scenarios the per-scenario programs cannot fill the
# card's SMs, and the XLA path is kept
MIN_BATCH = 128
_BIG = 1e30


def corridor_kernel_enabled(dtype, batch: int, ccfg: CorridorConfig) -> bool:
    """The one place that chooses the corridor kernel over the XLA path."""
    return (
        jax.default_backend() == "gpu"
        and dtype == jnp.float32
        and batch >= MIN_BATCH
        and not ccfg.max_active_obstacles
    )


def _corridor_kernel(p1_ref, p2_ref, ox_ref, oy_ref, oz_ref, m_ref,
                     A_ref, b_ref, *, ccfg: CorridorConfig, n_stages: int,
                     nh: int):
    ox = ox_ref[...]                                         # (M,)
    oy = oy_ref[...]
    oz = oz_ref[...]
    m0 = m_ref[...]                                          # f32 {0, 1}
    dtype = ox.dtype
    eps = ccfg.epsilon
    bb0, bb1, bb2 = ccfg.local_bbox
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)

    def ell_dist(R, a0, a1, a2, d):
        """||diag(1/a) R^T (o - d)|| over the cloud."""
        rx, ry, rz = ox - d[0], oy - d[1], oz - d[2]
        q0 = (R[0][0] * rx + R[1][0] * ry + R[2][0] * rz) / a0
        q1 = (R[0][1] * rx + R[1][1] * ry + R[2][1] * rz) / a1
        q2 = (R[0][2] * rx + R[1][2] * ry + R[2][2] * rz) / a2
        return jnp.sqrt(q0 * q0 + q1 * q1 + q2 * q2)

    def closest(alive, dists):
        """(any alive, coordinates of the lowest-index closest alive point)."""
        any_alive = jnp.max(alive) > 0.5
        score = jnp.where(alive > 0.5, dists, _BIG)
        idx = jax.lax.argmin(score, 0, jnp.int32)
        return any_alive, (ox_ref[idx], oy_ref[idx], oz_ref[idx])

    def rows_out(n, r, pt, nv, valid, d):
        """Outward-oriented A x <= b row (polyhedron.h:98-147)."""
        c = pt[0] * nv[0] + pt[1] * nv[1] + pt[2] * nv[2]
        flip = (nv[0] * d[0] + nv[1] * d[1] + nv[2] * d[2] - c) > 0
        sgn = jnp.where(flip, -one, one) * valid
        for k in range(3):
            A_ref[n, r, k] = nv[k] * sgn
        b_ref[n, r] = c * sgn

    def stage(n, carry):
        p1 = [p1_ref[n, k] for k in range(3)]
        p2 = [p2_ref[n, k] for k in range(3)]

        # ---- segment frame (geometric_utils.h:27-35, atan2-free) ---------
        vx, vy, vz = p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]
        nxy = jnp.sqrt(vx * vx + vy * vy)
        nv = jnp.sqrt(vx * vx + vy * vy + vz * vz)
        deg_y = nxy < 1e-12
        cy = jnp.where(deg_y, one, vx / jnp.where(deg_y, one, nxy))
        sy = jnp.where(deg_y, zero, vy / jnp.where(deg_y, one, nxy))
        deg_p = nv < 1e-12
        cp = jnp.where(deg_p, one, nxy / jnp.where(deg_p, one, nv))
        sp = jnp.where(deg_p, zero, -vz / jnp.where(deg_p, one, nv))
        # Ri = Rz(yaw) @ Ry(pitch)  (roll = 0)
        Ri = ((cy * cp, -sy, cy * sp),
              (sy * cp, cy, sy * sp),
              (-sp, zero, cp))
        d = (0.5 * (p1[0] + p2[0]), 0.5 * (p1[1] + p2[1]),
             0.5 * (p1[2] + p2[2]))

        # ---- local bbox walls (line_segment.h:47-85) ---------------------
        nv_safe = jnp.maximum(nv, 1e-12)
        dvx, dvy, dvz = vx / nv_safe, vy / nv_safe, vz / nv_safe
        nh_ = jnp.sqrt(dvy * dvy + dvx * dvx)
        deg_h = nh_ < 1e-12
        hx = jnp.where(deg_h, -one, dvy / jnp.where(deg_h, one, nh_))
        hy = jnp.where(deg_h, zero, -dvx / jnp.where(deg_h, one, nh_))
        hz = zero
        wx = dvy * hz - dvz * hy
        wy = dvz * hx - dvx * hz
        wz = dvx * hy - dvy * hx
        walls = (
            ((p1[0] + hx * bb1, p1[1] + hy * bb1, p1[2] + hz * bb1),
             (hx, hy, hz)),
            ((p1[0] - hx * bb1, p1[1] - hy * bb1, p1[2] - hz * bb1),
             (-hx, -hy, -hz)),
            ((p2[0] + dvx * bb0, p2[1] + dvy * bb0, p2[2] + dvz * bb0),
             (dvx, dvy, dvz)),
            ((p1[0] - dvx * bb0, p1[1] - dvy * bb0, p1[2] - dvz * bb0),
             (-dvx, -dvy, -dvz)),
            ((p1[0] + wx * bb2, p1[1] + wy * bb2, p1[2] + wz * bb2),
             (wx, wy, wz)),
            ((p1[0] - wx * bb2, p1[1] - wy * bb2, p1[2] - wz * bb2),
             (-wx, -wy, -wz)),
        )

        # ---- bbox obstacle filter (decomp_base.h:33-38) ------------------
        inside_f = m0
        for (ptx, pty, ptz), (wnx, wny, wnz) in walls:
            sd = wnx * ox + wny * oy + wnz * oz - (
                wnx * ptx + wny * pty + wnz * ptz)
            inside_f = inside_f * (sd <= eps).astype(dtype)

        # ---- find_ellipsoid (line_segment.h:134-211, offset=0) -----------
        f = jnp.maximum(0.5 * nv, 1e-6)
        a0 = f
        dist0 = ell_dist(Ri, f, f, f, d)

        # phase 1: shrink the middle axis, re-rolling the frame.  The
        # distances carried into a round are the ones the previous round
        # computed for the updated ellipsoid.
        def phase1(_, st):
            R, a1, inside, dists = st
            gate, (px, py, pz) = closest(inside, dists)
            rx, ry, rz = px - d[0], py - d[1], pz - d[2]
            ly = Ri[0][1] * rx + Ri[1][1] * ry + Ri[2][1] * rz
            lz = Ri[0][2] * rx + Ri[1][2] * ry + Ri[2][2] * rz
            hroll = jnp.sqrt(ly * ly + lz * lz)
            deg_r = hroll < 1e-12
            cr = jnp.where(deg_r, one, ly / jnp.where(deg_r, one, hroll))
            sr = jnp.where(deg_r, zero, lz / jnp.where(deg_r, one, hroll))
            # R_new = Ri @ Rx(roll)
            Rn = tuple(
                (Ri[i][0], Ri[i][1] * cr + Ri[i][2] * sr,
                 Ri[i][2] * cr - Ri[i][1] * sr)
                for i in range(3)
            )
            pr0 = Rn[0][0] * rx + Rn[1][0] * ry + Rn[2][0] * rz
            pr1 = Rn[0][1] * rx + Rn[1][1] * ry + Rn[2][1] * rz
            denom = 1.0 - (pr0 / a0) ** 2
            b_new = jnp.where(
                (pr0 < a0) & (denom > 1e-12),
                jnp.abs(pr1) / jnp.sqrt(jnp.maximum(denom, 1e-12)),
                a1,
            )
            R = tuple(tuple(jnp.where(gate, Rn[i][j], R[i][j]) for j in range(3))
                      for i in range(3))
            a1 = jnp.where(gate, b_new, a1)
            new_d = ell_dist(R, a0, a1, a1, d)
            inside = jnp.where(
                gate, inside * (1.0 - new_d > eps).astype(dtype), inside)
            return R, a1, inside, new_d

        Rf, a1, _, _ = jax.lax.fori_loop(
            0, ccfg.shrink_iters, phase1,
            (Ri, f, inside_f * (dist0 <= 1.0).astype(dtype), dist0),
        )

        # phase 2: vertical axis, frame fixed, re-filtered inside set
        d2 = ell_dist(Rf, a0, a1, f, d)
        inside2 = (inside_f * (d2 <= 1.0).astype(dtype)
                   * (dist0 <= 1.0).astype(dtype))

        def phase2(_, st):
            a2, inside, dists = st
            gate, (px, py, pz) = closest(inside, dists)
            rx, ry, rz = px - d[0], py - d[1], pz - d[2]
            pr0 = Rf[0][0] * rx + Rf[1][0] * ry + Rf[2][0] * rz
            pr1 = Rf[0][1] * rx + Rf[1][1] * ry + Rf[2][1] * rz
            pr2 = Rf[0][2] * rx + Rf[1][2] * ry + Rf[2][2] * rz
            dd = 1.0 - (pr0 / a0) ** 2 - (pr1 / a1) ** 2
            c_new = jnp.where(
                dd > eps, jnp.abs(pr2) / jnp.sqrt(jnp.maximum(dd, 1e-12)), a2)
            a2 = jnp.where(gate, c_new, a2)
            new_d = ell_dist(Rf, a0, a1, a2, d)
            inside = jnp.where(
                gate, inside * (1.0 - new_d > eps).astype(dtype), inside)
            return a2, inside, new_d

        a2, _, dists = jax.lax.fori_loop(
            0, ccfg.shrink_iters, phase2, (f, inside2, d2))

        # ---- find_polyhedron peel (decomp_base.h:63-83) ------------------
        # distances w.r.t. the final ellipsoid are loop-invariant
        def peel(r, remain):
            gate, (px, py, pz) = closest(remain, dists)
            # n = Cinv Cinv^T (p - d) = Rf diag(1/a^2) Rf^T (p - d)
            rx, ry, rz = px - d[0], py - d[1], pz - d[2]
            t0 = (Rf[0][0] * rx + Rf[1][0] * ry + Rf[2][0] * rz) / (a0 * a0)
            t1 = (Rf[0][1] * rx + Rf[1][1] * ry + Rf[2][1] * rz) / (a1 * a1)
            t2 = (Rf[0][2] * rx + Rf[1][2] * ry + Rf[2][2] * rz) / (a2 * a2)
            nx = Rf[0][0] * t0 + Rf[0][1] * t1 + Rf[0][2] * t2
            ny = Rf[1][0] * t0 + Rf[1][1] * t1 + Rf[1][2] * t2
            nz = Rf[2][0] * t0 + Rf[2][1] * t1 + Rf[2][2] * t2
            nn = jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
            nx, ny, nz = nx / nn, ny / nn, nz / nn
            sd = nx * (ox - px) + ny * (oy - py) + nz * (oz - pz)
            remain = jnp.where(gate, remain * (sd < 0).astype(dtype), remain)
            valid = gate.astype(dtype)
            rows_out(n, r, (px * valid, py * valid, pz * valid),
                     (nx * valid, ny * valid, nz * valid), valid, d)
            return remain

        jax.lax.fori_loop(0, ccfg.max_obs_planes, peel, inside_f)

        for k, (pt, wn) in enumerate(walls):
            rows_out(n, ccfg.max_obs_planes + k, pt, wn, one, d)
        for r in range(ccfg.max_obs_planes + 6, nh):   # zero padding rows
            for k in range(3):
                A_ref[n, r, k] = zero
            b_ref[n, r] = zero
        return carry

    jax.lax.fori_loop(0, n_stages, stage, 0)


def _next_pow2(m: int) -> int:
    return max(16, 1 << (m - 1).bit_length())


@functools.partial(jax.jit, static_argnames=("ccfg", "nh", "interpret"))
def decompose_stages(
    p1: jnp.ndarray,        # (B, N, 3) stage seed starts
    p2: jnp.ndarray,        # (B, N, 3) stage seed ends
    obs: jnp.ndarray,       # (B, M, 3)
    obs_mask: jnp.ndarray,  # (B, M) bool
    ccfg: CorridorConfig,
    nh: int = NH,
    *,
    interpret: bool = False,
):
    """All-stage decomposition, batch-leading in and out.

    Returns (A (B, N, nh, 3), b (B, N, nh)): max_obs_planes peel rows,
    6 bbox walls, zero padding — decompose_segment's row layout.  The
    cloud is padded with masked points to a power of two (Triton block
    sizes)."""
    if nh < ccfg.max_obs_planes + 6:
        raise ValueError(f"nh={nh} < max_obs_planes + 6")
    B, N = p1.shape[0], p1.shape[1]
    M = obs.shape[1]
    dtype = p1.dtype
    Mp = _next_pow2(M)
    obs = jnp.pad(obs.astype(dtype), ((0, 0), (0, Mp - M), (0, 0)))
    mask = jnp.pad(obs_mask, ((0, 0), (0, Mp - M))).astype(dtype)

    kern = functools.partial(
        _corridor_kernel, ccfg=ccfg, n_stages=N, nh=nh)
    seed_spec = pl.BlockSpec((None, N, 3), lambda b: (b, 0, 0))
    cloud_spec = pl.BlockSpec((None, Mp), lambda b: (b, 0))
    return pl.pallas_call(
        kern,
        grid=(B,),
        in_specs=[seed_spec, seed_spec] + [cloud_spec] * 4,
        out_specs=[
            pl.BlockSpec((None, N, nh, 3), lambda b: (b, 0, 0, 0)),
            pl.BlockSpec((None, N, nh), lambda b: (b, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, N, nh, 3), dtype),
            jax.ShapeDtypeStruct((B, N, nh), dtype),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="corridor_decompose",
    )(p1, p2, obs[..., 0], obs[..., 1], obs[..., 2], mask)
