"""Sharded-sweep scaling study on virtual CPU devices -> SCALING.md.

Strong scaling of the Monte-Carlo sweep (fixed global batch) over
1/2/4/8-device single-process meshes, plus a 2-process x 4-device run
through jax.distributed (the multi-host initialization path).  Virtual
CPU devices share the same physical cores, so wall-clock here measures
the sharding machinery (shard_map, tier compaction per shard, collective
stats), not chip speedup; the table documents that the batch axis scales
mechanically and what per-device dispatch overhead looks like.  On real
hardware the same code spans device meshes over NVLink or the network.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         python tools/scaling_study.py
"""
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.parallel import mesh as pm

    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        solver=dataclasses.replace(
            DEFAULT_CONFIG.solver, tiers=((16, 0.25), (18, 0.0625))
        ),
    )
    from forces_resilient_planner_tpu.engine import batch as bm

    n_goals, n_forces = 64, 16   # B = 1024 global, fixed (strong scaling)

    def scenarios(seed):
        rng = np.random.default_rng(seed)
        goals = rng.uniform([-4, -4, 1.0], [4, 4, 1.6], (n_goals, 3))
        forces = rng.uniform(-2.0, 2.0, (n_forces, 3))
        halves = np.array([[6.0, 6.0, 2.0]])
        return bm.make_scenarios(cfg, goals, forces, halves)

    rows = []
    for nd in (1, 2, 4, 8):
        devs = jax.devices()[:nd]
        mesh = pm.make_mesh(devs, shape=(1, nd))
        run = pm.make_sharded_solver(cfg, mesh)  # compiled ONCE per mesh
        t0 = time.perf_counter()
        res, stats = run(pm.shard_scenarios(scenarios(3), mesh))
        _ = float(stats.mean_cost)
        compile_s = time.perf_counter() - t0
        laps = []
        for rep in range(3):
            scen = pm.shard_scenarios(scenarios(10 + rep), mesh)
            t0 = time.perf_counter()
            res, stats = run(scen)
            _ = float(stats.mean_cost)
            laps.append(time.perf_counter() - t0)
        wall = float(np.mean(laps))
        B = int(stats.n)
        rows.append(
            dict(
                devices=nd, processes=1, B=B, wall_s=wall,
                solves_per_s=B / wall,
                solved=float(stats.n_solved) / B,
                compile_s=compile_s,
            )
        )
        print(f"[scaling] {rows[-1]}", flush=True)

    # 2-process x 4-device run (multi-host initialization path).  Reuses
    # the pytest worker; stats printed by process 0.
    import json
    import os
    import socket

    s = socket.socket(); s.bind(("localhost", 0))
    port = s.getsockname()[1]; s.close()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_mp_sweep_worker.py"),
             f"localhost:{port}", "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT), env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    mp_wall = time.perf_counter() - t0
    mp_row = None
    for line in outs[0].splitlines():
        if line.startswith("MPRESULT "):
            r = json.loads(line[len("MPRESULT "):])
            mp_row = dict(
                devices=8, processes=2, B=int(r["n"]),
                wall_s=mp_wall,
                solved=r["n_solved"] / r["n"],
                note="end-to-end incl. startup+compile (tiny B=32 problem)",
            )
    print(f"[scaling] {mp_row}", flush=True)

    lines = [
        "# SCALING — sharded sweep over virtual CPU device meshes",
        "",
        "Strong scaling of `parallel/mesh.py::monte_carlo_sweep` (global "
        f"batch {rows[0]['B']}, production tier schedule) over 1/2/4/8 "
        "virtual CPU devices in one process, plus a 2-process x 4-device "
        "run through `jax.distributed.initialize` (the multi-host path, "
        "tests/test_multiprocess.py).",
        "",
        "Virtual devices share the same physical cores: wall-clock "
        "measures the sharding machinery (shard_map with device-local "
        "tier compaction, collective sweep stats), not chip speedup — "
        "the expectation on shared cores is roughly FLAT wall-clock with "
        "zero parallel efficiency loss from the sharding layer itself. "
        "On real cards the same mesh axis spans NVLink or the network.",
        "",
        "| devices | processes | global B | wall/sweep [s] | sweeps' "
        "solves/s | solved |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['devices']} | {r['processes']} | {r['B']} | "
            f"{r['wall_s']:.2f} | {r['solves_per_s']:.0f} | "
            f"{r['solved']:.3f} |"
        )
    if mp_row:
        lines.append(
            f"| {mp_row['devices']} (2 hosts) | 2 | {mp_row['B']} | "
            f"{mp_row['wall_s']:.1f} (incl. startup/compile) | — | "
            f"{mp_row['solved']:.3f} |"
        )
    lines += [
        "",
        "Multi-process stats are asserted equal to the single-process "
        "result in `tests/test_multiprocess.py`.",
        "",
    ]
    (ROOT / "SCALING.md").write_text("\n".join(lines))
    print("wrote SCALING.md", flush=True)


if __name__ == "__main__":
    main()
