"""Interpret-mode parity checks for the corridor Pallas kernel.

Run AS A SUBPROCESS from tests (tests/test_ops.py): executing interpret-
mode kernels inline in a long-lived process has left XLA:CPU in a state
where later unrelated compiles abort.

Usage:  python tools/kernel_parity_debug.py corridor|corridor_padding
Prints CORRIDOR_PARITY_OK / CORRIDOR_PADDING_OK on success.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # parity runs at f64
import jax.numpy as jnp  # noqa: E402


def _check(ccfg, nh, B, N, M, seed, masked_lanes=()):
    """Kernel (interpret mode) vs decompose_segment, stage by stage."""
    from forces_resilient_planner_tpu.corridor.decomp import decompose_segment
    from forces_resilient_planner_tpu.ops import corridor_pallas

    rng = np.random.default_rng(seed)
    p1 = rng.uniform([-1, -1, 0.8], [1, 1, 1.6], (B, N, 3))
    yaw = rng.uniform(-np.pi, np.pi, (B, N))
    p2 = p1 + 0.1 * np.stack(
        [np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)], -1
    )
    obs = rng.uniform([-3, -3, -0.5], [3, 3, 3], (B, M, 3))
    mask = rng.uniform(size=(B, M)) < 0.9
    for lane in masked_lanes:
        mask[lane] = False

    A_k, b_k = corridor_pallas.decompose_stages(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(obs),
        jnp.asarray(mask), ccfg, nh, interpret=True,
    )
    assert A_k.shape == (B, N, nh, 3) and b_k.shape == (B, N, nh)
    for bi in range(B):
        for ni in range(N):
            ref = decompose_segment(
                jnp.asarray(p1[bi, ni]), jnp.asarray(p2[bi, ni]),
                jnp.asarray(obs[bi]), jnp.asarray(mask[bi]), ccfg, nh,
            )
            np.testing.assert_allclose(
                np.asarray(A_k[bi, ni]), np.asarray(ref.A), atol=1e-9,
                err_msg=f"A b={bi} n={ni} caps={ccfg.max_obs_planes}",
            )
            np.testing.assert_allclose(
                np.asarray(b_k[bi, ni]), np.asarray(ref.b), atol=1e-9,
                err_msg=f"b b={bi} n={ni}",
            )
    return np.asarray(A_k), np.asarray(b_k)


def check_corridor():
    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG

    for ccfg, nh in (
        (dataclasses.replace(
            DEFAULT_CONFIG.corridor, shrink_iters=6, max_obs_planes=24), 30),
        (dataclasses.replace(
            DEFAULT_CONFIG.corridor, shrink_iters=4, max_obs_planes=12), 30),
    ):
        _check(ccfg, nh, B=2, N=3, M=128, seed=31)
        print(f"[corridor] caps={ccfg.max_obs_planes}: OK")
    print("CORRIDOR_PARITY_OK")


def check_corridor_padding():
    """Cloud sizes that are not a power of two (padded with masked
    points), an odd batch, an all-masked cloud (only the 6 bbox walls
    survive) and zero padding rows beyond the caps (nh > planes + 6)."""
    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG

    ccfg = dataclasses.replace(
        DEFAULT_CONFIG.corridor, shrink_iters=4, max_obs_planes=8)
    A, b = _check(ccfg, 16, B=3, N=2, M=97, seed=5, masked_lanes=(1,))
    walls = np.linalg.norm(A[1], axis=-1) > 0
    assert walls[:, 8:14].all() and not walls[:, :8].any(), walls
    assert not A[:, :, 14:].any() and not b[:, :, 14:].any()
    print("CORRIDOR_PADDING_OK")


if __name__ == "__main__":
    modes = {
        "corridor": check_corridor,
        "corridor_padding": check_corridor_padding,
    }
    mode = sys.argv[1] if len(sys.argv) > 1 else "corridor"
    if mode not in modes:
        raise SystemExit(f"unknown mode {mode}")
    modes[mode]()
