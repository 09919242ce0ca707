"""Smoke run of the planner's main path on NVIDIA cards.

    python chip_smoke.py           # one card: solver, corridor, pipeline,
                                   # closed_loop and fleet phases
    python chip_smoke.py --four    # four cards: the sharded 4 x 4096 sweep
                                   # against the same scenarios on one card,
                                   # shard by shard

Each phase prints one JSON line with its numbers and checks; the card's
name and power limit come first.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
and appears only when every phase passed; otherwise the script exits
non-zero.  It refuses to run when JAX finds no GPU.

Phases (one card, deployment sizes):
  solver      engine/batch.py::solve_scenario_grid at B=4096 (bench.py's
              workload): exit-code census, (ec == 1) share >= 0.99, no
              NaN-guard (-6) lane, 16 lanes re-solved by the f64 oracle
              within 1e-3 (BASELINE.json).
  corridor    the corridor kernel compiled for the card at the real width
              (2,048-point clouds, 20 stages, production caps) against the
              XLA decomposition, both in f64 on the card.
  pipeline    engine/pipeline_batch.py::nmpc_step_batched at B=4096, every
              lane with its own seeded scene filling the obstacle buffer;
              f64 geometric audit of 32 lanes' corridors (zero obstacle
              penetration) and f64 re-solve of 16 lanes' NLPs (1e-3).
  closed_loop ResilientPlanner + QuadSim on the config-3 fence scene with
              time-varying wind at DEFAULT_CONFIG's map and search sizes:
              goal reached, fence never crossed; solve p50/p99 vs 50 ms.
  fleet       engine/fleet.py::run_fleet at B=128: reached and collided
              shares, outcome counts.
The f64 references run in a CPU-only child process (JAX_PLATFORMS=cpu):
this process is the only one that opens the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

TOL_U = 1e-3          # device vs f64 controls (BASELINE.json)
TOL_FOUR_U = 1e-4     # four-card vs one-card controls


def _emit(rec: dict):
    print(json.dumps(rec, default=float), flush=True)


def _timed_first_call(fn):
    """(result, seconds) of a first call, which includes its compile."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def phase_solver(n_goals=256, n_forces=16, n_oracle=16):
    import bench
    from forces_resilient_planner_tpu.engine import batch as bm
    from forces_resilient_planner_tpu.oracle import certify

    C = bench.bench_config()
    g0, f0 = bench.bench_seeds(1, n_goals, n_forces)
    _, first_s = _timed_first_call(
        lambda: bm.solve_scenario_grid(C, g0, f0, bench.HALVES))
    g, f = bench.bench_seeds(1000, n_goals, n_forces)
    t0 = time.perf_counter()
    r = bm.solve_scenario_grid(C, g, f, bench.HALVES)
    ec = np.asarray(r.exit_code)
    steady_s = time.perf_counter() - t0
    iters = np.asarray(r.iters)
    u = np.asarray(r.Z[:, :, 0:4])
    codes, counts = np.unique(ec, return_counts=True)
    lanes = certify.pick_lanes(ec, iters, n_oracle)
    orc = certify.run_cpu_child("oracle", dict(
        goals=g, forces=f, halves=bench.HALVES, lanes=lanes, u=u[lanes]))
    solved = float((ec == 1).mean())
    return dict(
        ok=bool(solved >= 0.99 and not (ec == -6).any()
                and len(lanes) == n_oracle
                and orc["max_u_diff"] <= TOL_U),
        batch=int(ec.size),
        census={int(c): int(n) for c, n in zip(codes, counts)},
        solved_frac=solved,
        iters_mean=float(iters.mean()),
        iters_max=int(iters.max()),
        first_call_s=first_s,
        steady_call_s=steady_s,
        oracle_lanes=int(len(lanes)),
        oracle_max_u_diff=orc["max_u_diff"],
        oracle_status=orc["oracle_status"],
        tol=TOL_U,
    )


def _stage_seeds(lanes, cfg):
    """Per-stage corridor seed segments along each lane's reference."""
    N = cfg.model.N
    p1 = lanes["kino_path"][:, :N].astype(np.float64)
    d = np.diff(lanes["kino_path"][:, : N + 1].astype(np.float64), axis=1)
    yaw = np.arctan2(d[..., 1], d[..., 0])
    p2 = p1 + cfg.corridor.seed_len * np.stack(
        [np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)], -1)
    return p1, p2


def phase_corridor(B=64, tol=1e-6):
    import jax
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    from forces_resilient_planner_tpu.engine.pipeline import decompose_stages
    from forces_resilient_planner_tpu.engine.scenarios import pipeline_lanes
    from forces_resilient_planner_tpu.ops import corridor_pallas

    lanes = pipeline_lanes(C, B, seed=7, dtype=np.float64)
    p1, p2 = _stage_seeds(lanes, C)
    xla = jax.jit(jax.vmap(
        lambda a, b, o, m: decompose_stages(a, b, o, m, C)))
    kern = lambda *a: corridor_pallas.decompose_stages(  # noqa: E731
        *a, C.corridor, C.model.nh)
    out = {}
    for name, dtype, enable in (("f64", jnp.float64, True),
                                ("f32", jnp.float32, False)):
        with jax.enable_x64(enable):
            args = (jnp.asarray(p1, dtype), jnp.asarray(p2, dtype),
                    jnp.asarray(lanes["obstacles"], dtype),
                    jnp.asarray(lanes["obstacle_mask"]))
            (Ak, bk), first_s = _timed_first_call(lambda: kern(*args))
            Ax, bx = jax.block_until_ready(xla(*args))
            Ak, bk, Ax, bx = (np.asarray(v, np.float64)
                              for v in (Ak, bk, Ax, bx))
        dA = np.abs(Ak - Ax).max(axis=(-1, -2))
        db = np.abs(bk - bx).max(axis=-1)
        out[name] = dict(
            max_abs_diff=float(max(dA.max(), db.max())),
            stages_agree_1e4=float(((dA <= 1e-4) & (db <= 1e-4)).mean()),
            kernel_first_call_s=first_s,
        )
    return dict(
        # f64 is the exact comparison: f32 argmin ties flip plane
        # selections between any two implementations (PARITY.md), so the
        # f32 agreement share is reported, not gated
        ok=bool(out["f64"]["max_abs_diff"] <= tol),
        batch=B, stages=C.model.N,
        cloud=int(lanes["obstacles"].shape[1]),
        caps=dict(shrink_iters=C.corridor.shrink_iters,
                  max_obs_planes=C.corridor.max_obs_planes),
        tol=tol, **out,
    )


def phase_pipeline(B=4096, n_audit=32, n_resolve=16, min_solved=0.9):
    import jax

    import bench
    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    from forces_resilient_planner_tpu.oracle import certify
    from forces_resilient_planner_tpu.ops import corridor_pallas

    N = C.model.N
    step = bench.make_pipeline_fn(C)
    _, first_s = _timed_first_call(lambda: step(bench.pipeline_inputs(B, 10)))
    a = bench.pipeline_inputs(B, 11)
    t0 = time.perf_counter()
    r = jax.block_until_ready(step(a))
    steady_s = time.perf_counter() - t0
    ec = np.asarray(r.exit_code)
    iters = np.asarray(r.iters)
    codes, counts = np.unique(ec, return_counts=True)

    audit = np.linspace(0, B - 1, n_audit).astype(int)
    take = lambda x: np.asarray(x[audit])  # noqa: E731
    pen = certify.corridor_penetration(
        take(r.corridor_A), take(r.corridor_b_tight),
        take(a["obstacles"]), take(a["obstacle_mask"]))

    lanes = certify.pick_lanes(ec, iters, n_resolve)
    take = lambda x: np.asarray(x[lanes])  # noqa: E731
    mpc_in = take(a["mpc_output"])
    res = certify.run_cpu_child("resolve", dict(
        xinit=mpc_in[:, 1, 8:17], Z0=mpc_in[:, 1:N + 1],
        ref_pos=take(r.ref.ref_pos), ref_yaw=take(r.ref.ref_yaw),
        f_ext=take(a["f_ext"]), use_final=take(a["use_final"]),
        corridor_A=take(r.corridor_A), corridor_b=take(r.corridor_b_tight),
        exit_code=ec[lanes], u=take(r.mpc_output)[:, :N, 0:4],
    ))
    solved = float((ec == 1).mean())
    return dict(
        ok=bool(pen == 0.0 and solved >= min_solved
                and res["n_both_solved"] == len(lanes) == n_resolve
                and res["max_u_diff"] <= TOL_U),
        batch=B,
        cloud=int(a["obstacles"].shape[1]),
        corridor_kernel=corridor_pallas.corridor_kernel_enabled(
            a["obstacles"].dtype, B, C.corridor),
        census={int(c): int(n) for c, n in zip(codes, counts)},
        solved_frac=solved,
        iters_mean=float(iters.mean()),
        first_call_s=first_s,
        steady_call_s=steady_s,
        audit_lanes=n_audit,
        max_penetration_m=pen,
        resolve_lanes=int(len(lanes)),
        resolve_max_u_diff=res["max_u_diff"],
        resolve_exit_agree=res["exit_agree"],
        tol=TOL_U,
    )


def phase_closed_loop():
    import bench

    cl = bench._closed_loop_smoke()
    return dict(ok=bool(cl["reached"] and cl["no_collision"]), **cl)


def phase_fleet(B=128, min_reached=0.9):
    import bench

    fl = bench._fleet_bench(B=B)
    return dict(ok=bool(fl["collided_frac"] == 0.0
                        and fl["reached_frac"] >= min_reached), **fl)


def phase_four(n_goals=1024, n_forces=16):
    """The 4 x 4096-scenario sharded sweep vs the same scenarios on one
    card, solved there shard by shard (the same per-device program
    shape): identical exit codes, controls within 1e-4, and the
    collective sweep stats equal to a host recomputation."""
    import jax

    import bench
    from forces_resilient_planner_tpu.parallel import mesh as pm

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
    C = bench.bench_config()
    (r4, s4), four_s = _timed_first_call(
        lambda: pm.monte_carlo_sweep(C, pm.make_mesh(devs[:4]), n_goals,
                                     n_forces))
    mesh1 = pm.make_mesh(devs[:1])
    run1 = pm.make_sharded_solver(C, mesh1)
    scen = pm.sweep_scenarios(C, n_goals, n_forces)
    shard = scen.batch // 4
    t0 = time.perf_counter()
    parts = [
        jax.block_until_ready(run1(pm.shard_scenarios(
            jax.tree.map(lambda a: a[k * shard:(k + 1) * shard], scen),
            mesh1)))[0]
        for k in range(4)
    ]
    one_s = time.perf_counter() - t0
    ec4 = np.asarray(r4.exit_code)
    ec1 = np.concatenate([np.asarray(p.exit_code) for p in parts])
    u1 = np.concatenate([np.asarray(p.Z[:, :, 0:4]) for p in parts])
    du = float(np.abs(np.asarray(r4.Z[:, :, 0:4]) - u1).max())
    solved = ec4 == 1
    host = dict(
        n=float(ec4.size), n_solved=float(solved.sum()),
        mean_iters=float(np.asarray(r4.iters, np.float64).mean()),
        max_kkt_solved=float(np.where(
            solved, np.asarray(r4.kkt_error, np.float64), 0.0).max()),
        mean_cost=float((np.asarray(r4.Z[:, :, 0:4], np.float64) ** 2)
                        .sum(axis=(1, 2)).mean()),
    )
    dev = {k: float(getattr(s4, k)) for k in host}
    stats_ok = all(
        abs(dev[k] - host[k]) <= 1e-5 * max(1.0, abs(host[k])) for k in host)
    n_used = len(r4.exit_code.sharding.device_set)
    return dict(
        ok=bool(np.array_equal(ec4, ec1) and du <= TOL_FOUR_U and stats_ok
                and n_used == 4),
        scenarios=int(ec4.size),
        devices_used=n_used,
        exit_codes_identical=bool(np.array_equal(ec4, ec1)),
        max_u_diff=du, tol=TOL_FOUR_U,
        stats_device=dev, stats_host=host, stats_equal=stats_ok,
        solved_frac=float(solved.mean()),
        # first calls: compiles included
        four_call_s=four_s, one_card_shards_s=one_s,
    )


PHASES = {
    "solver": phase_solver,
    "corridor": phase_corridor,
    "pipeline": phase_pipeline,
    "closed_loop": phase_closed_loop,
    "fleet": phase_fleet,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sweep comparison")
    args = ap.parse_args(argv)

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform: {platform})",
              file=sys.stderr)
        return 1
    import bench

    cache = bench.setup_cache()
    print(f"card: {bench.card_info()}", flush=True)
    print(f"compile cache: {cache}", flush=True)

    phases = {"four": phase_four} if args.four else PHASES
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception as e:  # report every phase, then fail the run
            traceback.print_exc()
            rec = dict(ok=False, error=repr(e))
        _emit(dict(phase=name, wall_s=time.perf_counter() - t0, **rec))
        if not rec["ok"]:
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    _emit({"ok": True, "device": bench.device_record()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
