"""Test harness: run on a virtual 8-device CPU mesh, f64 enabled.

The suite runs on the CPU (JAX_PLATFORMS=cpu unless the environment names
a platform).  Multi-device sharding is validated on virtual CPU devices
(xla_force_host_platform_device_count).  Tests marked `gpu` compile the
real kernels for an NVIDIA card and skip elsewhere; run them on the card
with `JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0 tests/`.
chip_smoke.py runs the same comparisons as one of its phases.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

from forces_resilient_planner_tpu.utils.compile_cache import use_compile_cache

jax.config.update("jax_enable_x64", True)

# persistent XLA:CPU compile cache, READ-mostly: (a) repeat suite runs
# skip most compiles, (b) late-suite backend_compile_and_load calls have
# segfaulted nondeterministically after ~100 tests of accumulated
# compiler state (observed in test_sharding / test_solver_parity /
# test_solver_stress on different runs) — cache LOADS take a different
# path and shrink the number of live compiles per process.  The WRITE
# path (put_executable_and_time -> CPU executable serialization) has
# ALSO segfaulted late-suite (test_solver_stress ~100 tests deep), so
# the write threshold is set above any test-sized compile: entries are
# only ever written by short dedicated warm runs
# (python -m pytest tests/test_ipm_lanes.py tests/test_pipeline.py -q
# with the threshold lowered via JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS).
use_compile_cache(
    os.path.join(ROOT, ".jax_cache_cpu"),
    min_compile_secs=float(
        os.environ.get("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "3600")),
)

