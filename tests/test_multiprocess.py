"""Real multi-process execution of the sharded sweep (SURVEY.md §4:
"multi-host tests via jax multi-process simulation"; BASELINE scaling row).

Spawns 2 OS processes, each with 4 virtual CPU devices, joined through
jax.distributed.initialize — the same initialization path a real N-host
cluster uses (one process per host, mesh outer axis across processes).
Asserts the replicated sweep statistics from both processes agree with a
single-process 8-device run of the identical scenario set.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_mp_sweep_worker.py"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sweep_matches_single_process():
    port = _free_port()
    coordinator = f"localhost:{port}"
    n_procs, local_devices = 2, 4

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}"
    )
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(ROOT)

    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coordinator, str(n_procs), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=str(ROOT),
            env=env,
        )
        for i in range(n_procs)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MPRESULT "):
                r = json.loads(line[len("MPRESULT "):])
                results[r["process"]] = r
    assert set(results) == {0, 1}, f"missing results: {outs}"

    # single-process reference on the identical scenario set (the pytest
    # process has 8 virtual devices from conftest)
    import jax

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.parallel import mesh as pm

    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        solver=dataclasses.replace(DEFAULT_CONFIG.solver, max_iters=25),
    )
    mesh = pm.make_mesh(jax.devices()[:8], shape=(2, 4))
    res, stats = pm.monte_carlo_sweep(cfg, mesh, n_goals=8, n_forces=4, seed=7)

    assert float(stats.n_solved) > 0  # a meaningful comparison, not 0 == 0
    for pid in (0, 1):
        r = results[pid]
        assert r["n"] == float(stats.n)
        assert r["n_solved"] == float(stats.n_solved)
        np.testing.assert_allclose(
            r["mean_iters"], float(stats.mean_iters), rtol=1e-6
        )
        np.testing.assert_allclose(
            r["mean_cost"], float(stats.mean_cost), rtol=1e-4
        )
        np.testing.assert_allclose(
            r["max_kkt_solved"], float(stats.max_kkt_solved), rtol=1e-3
        )
    # both processes saw identical replicated stats
    assert results[0]["n_solved"] == results[1]["n_solved"]
    assert results[0]["mean_cost"] == results[1]["mean_cost"]
    # per-process exit codes cover disjoint halves of the batch: together
    # they account for every solved lane
    total_local = sum(
        sum(r["local_exit_codes"]) for r in results.values()
    )
    assert total_local == int(stats.n_solved)
