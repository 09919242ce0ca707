"""Large-batch f32 robustness: the CI-side guard for the f32 KKT scaling
floor (solver/ipm.py:119-133).

The benchmark runs f32 at batch 4096 and reports solved=1.0; the f64
parity suite proves 1e-3 agreement lane-by-lane on small batches.  This
test closes the gap ON CPU: 512 corridor-active lanes solved at f32 must
(a) keep a high solved fraction and (b) agree with the f64 solve of the
identical problems to 1e-3 at p99 over the control sequence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from forces_resilient_planner_tpu.engine import batch as bm
from tests.test_sharding_realism import CFG, _corridor_scenarios


@pytest.mark.slow
def test_f32_large_batch_corridor_scenes_match_f64():
    B = 512
    scen64 = _corridor_scenarios(B, dtype=jnp.float64)
    scen32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        scen64,
    )

    res32 = bm.solve_scenarios(scen32, CFG)
    res64 = bm.solve_scenarios(scen64, CFG)

    ec32 = np.asarray(res32.exit_code) == 1
    ec64 = np.asarray(res64.exit_code) == 1
    assert ec64.mean() >= 0.9, f"f64 solved {ec64.mean()}"
    # f32 must not lose more than a sliver of the f64-solved lanes
    assert ec32.mean() >= ec64.mean() - 0.02, (
        f"f32 solved {ec32.mean()} vs f64 {ec64.mean()}"
    )

    both = ec32 & ec64
    u32 = np.asarray(res32.Z)[:, :, 0:4][both]
    u64 = np.asarray(res64.Z)[:, :, 0:4][both]
    du = np.abs(u32 - u64).reshape(both.sum(), -1).max(axis=1)  # per lane
    # distributional guard: p99 of per-lane max control deviation
    assert np.percentile(du, 99) <= 1e-3, (
        f"p99 {np.percentile(du, 99):.2e} max {du.max():.2e}"
    )
    # and no pathological outlier beyond 5e-3
    assert du.max() <= 5e-3, f"max {du.max():.2e}"
