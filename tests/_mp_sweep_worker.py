"""Multi-process sweep worker (launched by test_multiprocess.py).

Each process owns a slice of virtual CPU devices
(--xla_force_host_platform_device_count in XLA_FLAGS, set by the parent),
joins the jax.distributed coordination service, builds the GLOBAL mesh
over all processes' devices, and runs the sharded Monte-Carlo sweep.
The replicated SweepStats are printed as one JSON line; the parent
asserts they match a single-process run of the identical scenario set.

This is the DCN/process-boundary axis of the design (SURVEY.md §2.4 /
§4): on a real pod the same code initializes one process per host and
the mesh's outer axis rides DCN.

Usage: python _mp_sweep_worker.py <coordinator> <num_procs> <proc_id>
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)

import dataclasses

import numpy as np

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
from forces_resilient_planner_tpu.parallel import mesh as pm


def main():
    n_procs = int(sys.argv[2])
    pid = int(sys.argv[3])
    assert jax.process_count() == n_procs
    devs = jax.devices()
    assert len(devs) == n_procs * len(jax.local_devices()), (
        f"global {len(devs)} local {len(jax.local_devices())}"
    )

    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        solver=dataclasses.replace(DEFAULT_CONFIG.solver, max_iters=25),
    )
    # outer axis = process boundary (DCN analog), inner = local devices
    mesh = pm.make_mesh(
        devs, shape=(n_procs, len(devs) // n_procs)
    )
    res, stats = pm.monte_carlo_sweep(
        cfg, mesh, n_goals=8, n_forces=4, seed=7
    )
    out = {
        "process": pid,
        "n": float(stats.n),
        "n_solved": float(stats.n_solved),
        "mean_iters": float(stats.mean_iters),
        "max_kkt_solved": float(stats.max_kkt_solved),
        "mean_cost": float(stats.mean_cost),
        "local_exit_codes": np.asarray(
            [int((s.data == 1).sum())
             for s in res.exit_code.addressable_shards]
        ).tolist(),
    }
    print("MPRESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
