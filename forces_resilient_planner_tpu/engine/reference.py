"""Reference sampling along the kino path + yaw computation.

Equivalent of NMPCSolver::getCurTraj / calculate_yaw
(nmpc_solver.cpp:109-142, 834-862) as fixed-shape array ops; the yaw
low-pass filter is a 20-step lax.scan (sequential by construction).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

_PI = 3.1415926  # the reference's PI constant, exactly (nmpc_solver.cpp:3)


class ReferenceResult(NamedTuple):
    ref_pos: jnp.ndarray   # (N, 3)
    ref_yaw: jnp.ndarray   # (N,)
    stage0_jump: jnp.ndarray  # ||ref_0 - predicted stage-1 pos|| (replan trigger)


def sample_references(
    kino_path: jnp.ndarray,   # (K, 3) padded
    kino_size: jnp.ndarray,   # scalar int, actual sample count
    t_offset: jnp.ndarray,    # seconds since kino path start
    last_yaw: jnp.ndarray,    # mpc_output[1][16] (nmpc_solver.cpp:486)
    pred_pos1: jnp.ndarray,   # mpc_output[1] position (jump check, line 136)
    N: int,
    Ts: float,
    lookahead: int = 5,
) -> ReferenceResult:
    dtype = kino_path.dtype
    K = kino_path.shape[0]
    i = jnp.arange(N, dtype=dtype)
    index_time = i * Ts + t_offset
    kino_idx = jnp.floor(index_time / Ts).astype(jnp.int32)
    frac = jnp.mod(index_time, Ts) / Ts
    last = jnp.maximum(kino_size - 1, 0)

    idx0 = jnp.clip(kino_idx, 0, K - 1)
    idx1 = jnp.clip(kino_idx + 1, 0, K - 1)
    p0 = kino_path[idx0]
    p1 = kino_path[idx1]
    interp = p0 + frac[:, None] * (p1 - p0)
    ref_pos = jnp.where(
        (kino_idx + 1 < kino_size)[:, None], interp, kino_path[last][None]
    )

    fwd_idx = jnp.where(kino_idx + lookahead < kino_size, kino_idx + lookahead, last)
    fwd_pos = kino_path[jnp.clip(fwd_idx, 0, K - 1)]

    # sequential yaw LPF (calculate_yaw, nmpc_solver.cpp:834-862)
    def yaw_step(last_y, inp):
        rp, fp = inp
        d = fp - rp
        yaw_t = jnp.where(
            jnp.linalg.norm(d) > 0.1, jnp.arctan2(d[1], d[0]), last_y
        )
        big = jnp.abs(yaw_t - last_y) > _PI
        yaw_w = jnp.where(
            big, jnp.where(yaw_t > 0, yaw_t - 2 * _PI, yaw_t + 2 * _PI), yaw_t
        )
        y = 0.2 * last_y + 0.8 * yaw_w
        return y, y

    # unroll=N: the 20-step LPF as a rolled scan lowers to 20 sequential
    # tiny kernels whose launch overhead dominated the batched refs phase;
    # unrolled it fuses into the surrounding program
    _, ref_yaw = jax.lax.scan(
        yaw_step, last_yaw, (ref_pos, fwd_pos), unroll=N
    )
    jump = jnp.linalg.norm(ref_pos[0] - pred_pos1)
    return ReferenceResult(ref_pos=ref_pos, ref_yaw=ref_yaw, stage0_jump=jump)


def wrap_yaw_outputs(Z: jnp.ndarray) -> jnp.ndarray:
    """Yaw unwrap of solver outputs to (-pi, pi]
    (updateFORCESResults, nmpc_solver.cpp:531-541)."""
    yaw = Z[:, 16]
    yaw = jnp.where(yaw < -_PI, yaw + 2 * _PI, yaw)
    yaw = jnp.where(yaw > _PI, yaw - 2 * _PI, yaw)
    return Z.at[:, 16].set(yaw)
