"""CPU checks of what surrounds the GPU path: the smoke script refuses a
host without a GPU, and the compile cache is placed from outside."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On a CPU-only host, and in a directory that holds chip_smoke.py
    and nothing else of the repo, the script exits non-zero and prints no
    ok line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0, out.stdout + out.stderr
    assert '"ok": true' not in out.stdout, out.stdout


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing else
    is configured; otherwise the fixed directory given by the caller."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "from_env")
    code = (
        "import sys, jax; sys.path.insert(0, sys.argv[1]);"
        "from forces_resilient_planner_tpu.utils.compile_cache import "
        "use_compile_cache as u;"
        "print(u(sys.argv[2]));"
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT), str(tmp_path / "fixed")],
        env=env, capture_output=True, text=True, timeout=120, check=True,
    )
    used, configured = out.stdout.strip().splitlines()[-2:]
    want = tmp_path / ("from_env" if env_dir else "fixed")
    assert used == str(want)
    assert configured == str(want)


def test_trace_reduction_maps_kernels_to_phases():
    """bench.py's trace reduction: fusions named after their HLO
    instruction ('.' -> '_' in kernel names), instructions without scope
    metadata take the scope of the computation they call, a Pallas kernel
    is matched by its phase-prefixed name, and busy time is the union of
    the kernel intervals."""
    import bench

    hlo = "\n".join([
        "%fused_tube.1 (p: f32[4]) -> f32[4] {",
        '  ROOT %m.1 = f32[4] multiply(%p, %p), '
        'metadata={op_name="jit(f)/tube/mul"}',
        "}",
        "ENTRY %main (x: f32[4]) -> f32[4] {",
        "  %loop_multiply_fusion.2 = f32[4] fusion(%x), kind=kLoop, "
        "calls=%fused_tube.1",
        '  ROOT %while.3 = f32[4] while(%x), body=%b, '
        'metadata={op_name="jit(f)/solve/while"}',
        "}",
    ])
    scopes = bench.hlo_op_scopes(hlo)
    assert scopes["loop_multiply_fusion_2"] == "tube"
    events = [
        ("s", "loop_multiply_fusion_2", 0.0, 10.0, "command_buffer", "m"),
        ("s", "corridor_decompose", 5.0, 10.0, "", "m"),
        ("s", "MemcpyD2D", 30.0, 5.0, "while.3", "m"),
        ("s", "mystery", 40.0, 10.0, "", "m"),
    ]
    red = bench.reduce_trace(events, scopes)
    assert red["phase_kernels"] == {"corridor": 1, "other": 1, "solve": 1,
                                    "tube": 1}
    assert red["window_ms"] == 50.0 / 1e6
    assert red["busy_ms"] == 30.0 / 1e6          # [0, 15) + [30, 35) + [40, 50)
    assert abs(red["idle_share"] - 0.4) < 1e-12
