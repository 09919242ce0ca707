"""Tests for the Pallas corridor kernel (ops/corridor_pallas.py) and the
fixed-structure matrix exponential (ops/expm.py).

Oracle for the kernel: corridor/decomp.py::decompose_segment, which is
itself tested against the reference's geometry (test_corridor.py).  The
kernel is the same algorithm in another expression, so at f64 the
tolerances are tight.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu.ops import corridor_pallas


def _run_kernel_debug(mode, marker):
    """All interpret-mode kernel executions run in SUBPROCESSES
    (tools/kernel_parity_debug.py): inline interpret kernels have left
    XLA:CPU in a state where later unrelated compiles segfault/abort."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "tools" / "kernel_parity_debug.py"),
         mode],
        capture_output=True, text=True, timeout=540, cwd=str(root),
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert marker in out.stdout, out.stdout[-3000:]


def test_routing_flag(monkeypatch):
    """The kernel is chosen from what the code observes: a GPU backend,
    f32, a batch that fills the card, no obstacle compaction."""
    ccfg = DEFAULT_CONFIG.corridor
    enabled = corridor_pallas.corridor_kernel_enabled
    assert not enabled(jnp.float32, 4096, ccfg)             # CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert enabled(jnp.float32, 4096, ccfg)
    assert enabled(jnp.float32, corridor_pallas.MIN_BATCH, ccfg)
    assert not enabled(jnp.float32, corridor_pallas.MIN_BATCH - 1, ccfg)
    assert not enabled(jnp.float64, 4096, ccfg)
    assert not enabled(
        jnp.float32, 4096,
        dataclasses.replace(ccfg, max_active_obstacles=256))


def test_corridor_kernel_interpret_matches_decompose_segment():
    """ops/corridor_pallas.py (interpret mode) vs decompose_segment."""
    _run_kernel_debug("corridor", "CORRIDOR_PARITY_OK")


def test_corridor_kernel_padding_and_masked_clouds():
    """Non-power-of-two clouds, an odd batch, an all-masked cloud and
    zero padding rows, still vs decompose_segment."""
    _run_kernel_debug("corridor_padding", "CORRIDOR_PADDING_OK")


def test_corridor_kernel_lowers_to_triton_for_cuda():
    """The kernel lowers through the Pallas Triton route for a CUDA
    target at production widths (B=4096, 2,048-point clouds, 20 stages):
    what this host can check of the card's compile without a card."""
    B, N, M = 4096, DEFAULT_CONFIG.model.N, DEFAULT_CONFIG.corridor.max_obstacles
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((B, N, 3), f32),) * 2 + (
        jax.ShapeDtypeStruct((B, M, 3), f32),
        jax.ShapeDtypeStruct((B, M), jnp.bool_),
    )
    fn = jax.jit(lambda p1, p2, o, m: corridor_pallas.decompose_stages(
        p1, p2, o, m, DEFAULT_CONFIG.corridor, DEFAULT_CONFIG.model.nh))
    exp = jax.export.export(
        fn, platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(*args)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert "num_warps = %d" % corridor_pallas.NUM_WARPS in text
    assert exp.out_avals[0].shape == (B, N, DEFAULT_CONFIG.model.nh, 3)


@pytest.mark.gpu
def test_corridor_kernel_on_card_matches_xla():
    """The kernel compiled for the card vs the XLA decomposition, both in
    f64 on the card at the real cloud width (chip_smoke's corridor
    phase)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA card (JAX backend 'gpu')")
    import chip_smoke

    rec = chip_smoke.phase_corridor(B=16)
    assert rec["ok"], rec


def test_expm_fixed_matches_jax_scipy():
    """ops/expm.py::expm_fixed vs jax.scipy.linalg.expm over random batches
    spanning several norm decades (the tube Phi*dt matrices live at
    ||A||_1 ~ 1-3; also check the scaled regimes)."""
    import jax.scipy.linalg as jsl

    from forces_resilient_planner_tpu.ops.expm import expm_fixed

    rng = np.random.default_rng(7)
    for n in (9, 18):
        for scale in (0.05, 1.0, 8.0, 60.0):
            A = jnp.asarray(rng.normal(0, 1.0, (16, n, n)) * scale / np.sqrt(n))
            want = jax.vmap(jsl.expm)(A)
            got = expm_fixed(A)
            err = float(jnp.max(jnp.abs(got - want) / (1.0 + jnp.abs(want))))
            assert err < 1e-9, (n, scale, err)


def test_expm_fixed_tube_phi_regime():
    """On actual closed-loop Phi*dt matrices from the tube propagator."""
    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.ops.expm import expm_fixed
    from forces_resilient_planner_tpu.solver.problems import hover_warm_start
    from forces_resilient_planner_tpu.tube.lyapunov import closed_loop_phi

    import jax.scipy.linalg as jsl

    C = DEFAULT_CONFIG
    rng = np.random.default_rng(1)
    x0 = jnp.zeros(9).at[2].set(1.2)
    Z = hover_warm_start(x0, C.model)
    K = jnp.asarray(C.tube.K)
    for i in range(8):
        x = Z[i % Z.shape[0], 8:17] + jnp.asarray(rng.normal(0, 0.3, 9))
        u = Z[i % Z.shape[0], 0:4] + jnp.asarray(rng.normal(0, 0.2, 4))
        Phi = closed_loop_phi(x, u, K, C.model) * C.model.dt
        want = jsl.expm(Phi)
        got = expm_fixed(Phi)
        assert float(jnp.max(jnp.abs(got - want))) < 1e-11
