"""BASELINE config 5: 100k+ scenario Monte-Carlo resilience sweep with
chunk checkpointing and kill/resume recovery.

Default scale: 25 chunks x 4096 scenarios (256 goals x 16 forces) =
102,400 solves — the "100k+ scenario sweep" of BASELINE.json configs[4],
run for real on one card.  Each chunk is dispatched through the streamed
two-executable sweep (engine/batch.py::solve_scenario_stream's pattern:
expansion + lane-major tiered solve, dispatch of chunk k+1 issued before
chunk k synchronizes) and checkpointed via SweepCheckpointer, so a killed
job resumes from the last completed chunk (the capability the reference
lacks entirely — SURVEY.md section 5, checkpoint/resume).

Writes MC_SWEEP.json at the repo root (git-ignored run output):
aggregate solves/s, resilience rate, exit-code family breakdown
(solver/forces_api.py::EXIT_NAMES), iteration histogram, resume count.

One card:
  python examples/config5_monte_carlo.py                 # full 102k run
  python examples/config5_monte_carlo.py --chunks 4      # smoke
Multi-device (virtual CPU mesh; the sharded path of parallel/mesh.py):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/config5_monte_carlo.py --mesh --chunks 4 --goals 16
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np

import sys

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def chunk_seeds(chunk: int, n_goals: int, n_forces: int):
    """Deterministic per-chunk scenario seeds (disjoint across chunks)."""
    rng = np.random.default_rng(777_000 + chunk)
    goals = rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (n_goals, 3))
    forces = rng.uniform(-1.5, 1.5, (n_forces, 3))
    return goals, forces


def summarize(ck, chunks, wall_s, n_resumed, extra=None):
    """Aggregate chunk checkpoints -> MC_SWEEP.json."""
    from forces_resilient_planner_tpu.solver.forces_api import EXIT_NAMES

    ecs, iters = [], []
    for c in chunks:
        d = ck.load_chunk(c)
        ecs.append(np.asarray(d[0]))
        iters.append(np.asarray(d[1]))
    ec = np.concatenate(ecs)
    it = np.concatenate(iters)
    hist, _ = np.histogram(it, bins=np.arange(0, 65))
    out = {
        "n_scenarios": int(ec.size),
        "n_chunks": len(chunks),
        "resilience_rate": float((ec == 1).mean()),
        "exit_code_fracs": {
            name: float((ec == code).mean())
            for code, name in EXIT_NAMES.items()
        },
        "mean_iters": float(it.mean()),
        "max_iters": int(it.max()),
        "iters_p99": float(np.percentile(it, 99)),
        "wall_s": round(wall_s, 2),
        # aggregate rate incl. one-time init/compile-load; the steady-state
        # chunk cadence (chunks after the first, sync+checkpoint included)
        # is the honest sustained figure
        "solves_per_s": round(ec.size / wall_s, 1) if wall_s > 0 else None,
        "resumed_chunks": int(n_resumed),
        **(extra or {}),
    }
    (ROOT / "MC_SWEEP.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return out


def run_mesh(args, C, ck, done):
    """Sharded path over a device mesh (parallel/mesh.py) — the
    multi-host shape; collective sweep stats cross the mesh."""
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.parallel import mesh as pm

    mesh = pm.make_mesh()
    print("mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)))
    t0 = time.perf_counter()
    for chunk in range(args.chunks):
        if chunk in done:
            continue
        res, stats = pm.monte_carlo_sweep(
            C, mesh, n_goals=args.goals, n_forces=args.forces,
            seed=1234 + chunk, dtype=jnp.float32,
        )
        ck.save_chunk(
            chunk, (np.asarray(res.exit_code), np.asarray(res.iters))
        )
        print(f"chunk {chunk}: n={int(stats.n)} "
              f"solved={int(stats.n_solved)}", flush=True)
    return time.perf_counter() - t0, None


def run_streamed(args, C, ck, done):
    """One-card streamed sweep: dispatch chunk k+1 before syncing
    chunk k (the production serving pattern), checkpoint as results
    land."""
    from forces_resilient_planner_tpu.engine import batch as bm

    HALVES = np.array([[5.0, 5.0, 2.0]])
    todo = [c for c in range(args.chunks) if c not in done]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    # warm/compile on the first pending chunk
    g, f = chunk_seeds(todo[0], args.goals, args.forces)
    r0 = bm.solve_scenario_grid(C, g, f, HALVES)
    ck.save_chunk(todo[0], (np.asarray(r0.exit_code), np.asarray(r0.iters)))
    print(f"chunk {todo[0]}: solved="
          f"{float(np.asarray(r0.exit_code == 1).mean()):.4f}", flush=True)
    # stream the rest with a bounded in-flight window (keeps device queue
    # full without holding 20+ result sets in HBM)
    window = 4
    pending = []
    t_stream = time.perf_counter()
    sets = [(c, *chunk_seeds(c, args.goals, args.forces)) for c in todo[1:]]
    for c, g, f in sets:
        pending.append((c, bm.solve_scenario_grid(C, g, f, HALVES)))
        if len(pending) >= window:
            c0, r = pending.pop(0)
            ck.save_chunk(c0, (np.asarray(r.exit_code), np.asarray(r.iters)))
            print(f"chunk {c0}: solved="
                  f"{float(np.asarray(r.exit_code == 1).mean()):.4f}",
                  flush=True)
    for c0, r in pending:
        ck.save_chunk(c0, (np.asarray(r.exit_code), np.asarray(r.iters)))
        print(f"chunk {c0}: solved="
              f"{float(np.asarray(r.exit_code == 1).mean()):.4f}", flush=True)
    wall = time.perf_counter() - t0
    steady = None
    if len(sets):
        per = (time.perf_counter() - t_stream) / len(sets)
        steady = round(args.goals * args.forces / per, 1)
        print(f"steady-state: {steady:.0f} solves/s "
              f"({per * 1e3:.1f} ms/chunk)", flush=True)
    return wall, steady


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=25)
    ap.add_argument("--goals", type=int, default=256)
    ap.add_argument("--forces", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "mc_sweep_ckpt"))
    ap.add_argument("--mesh", action="store_true",
                    help="sharded mesh path (parallel/mesh.py)")
    ap.add_argument("--no-summary", action="store_true")
    args = ap.parse_args()

    import jax

    import bench

    bench.setup_cache()

    from forces_resilient_planner_tpu.utils.checkpoint import SweepCheckpointer

    if args.mesh:
        from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    else:
        import bench

        C = bench.bench_config()   # tiered schedule, cache-shared with bench

    ck = SweepCheckpointer(args.ckpt_dir)
    done = ck.done_chunks()
    n_resumed = len([c for c in done if c < args.chunks])
    if n_resumed:
        print(f"resuming: {n_resumed}/{args.chunks} chunks checkpointed",
              flush=True)
    wall, steady = (run_mesh if args.mesh else run_streamed)(
        args, C, ck, done
    )
    if not args.no_summary:
        summarize(
            ck, list(range(args.chunks)), wall, n_resumed,
            extra={
                "chunk_batch": args.goals * args.forces,
                "device": str(jax.devices()[0]),
                "mode": "mesh" if args.mesh else "streamed",
                "steady_state_solves_per_s": steady,
            },
        )


if __name__ == "__main__":
    main()
