"""Headline benchmark: NMPC solves/s on one card at N=20 (BASELINE config 4).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...},
   "extras": {...}}

vs_baseline is measured against the reference's real-time anchor: the
FORCES-Pro-based planner solves one 20-stage NMPC per 50 ms tick
(20 solves/s, nmpc_manage.cpp:46 / BASELINE.md).

Also measured (stderr + "extras"): single-solve latency vs the 50 ms
budget (B=1, untiered), full-pipeline nmpc_step latency (B=1), the
batched full pipeline at B=4096 on per-lane scenes, the config-3 closed
loop at DEFAULT_CONFIG's map and search sizes, and the B=128 fleet.
Every section must succeed; a failed section fails the run.  The run
fails when JAX finds no GPU.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HALVES = np.array([[5.0, 5.0, 2.0]])
N_GOALS, N_FORCES = 256, 16


def bench_config():
    """The benchmarked configuration.

    Multi-level tier schedule chosen from this workload's iteration
    histogram (tools/iteration_histogram.py: 12.3% of lanes need >16
    iterations, 2.7% >17, 0.45% >18, max 21) with >=2x lane headroom per
    level.
    """
    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG

    return dataclasses.replace(
        DEFAULT_CONFIG,
        solver=dataclasses.replace(
            DEFAULT_CONFIG.solver, tiers=((16, 0.25), (18, 0.0625))
        ),
    )


def bench_seeds(seed, n_goals=N_GOALS, n_forces=N_FORCES):
    """Scenario seed set: goals x forces grid, deterministic per seed."""
    rng = np.random.default_rng(seed)
    goals = rng.uniform([-3, -3, 1.0], [3, 3, 1.6], (n_goals, 3))
    forces = rng.uniform(-1.5, 1.5, (n_forces, 3))
    return goals, forces


def setup_cache():
    """Persistent compile cache: JAX_COMPILATION_CACHE_DIR if set, else
    the checkout's fixed .jax_cache/."""
    from forces_resilient_planner_tpu.utils.compile_cache import (
        use_compile_cache,
    )

    return use_compile_cache(ROOT / ".jax_cache", min_compile_secs=1.0)


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_record() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU found (JAX platform: {platform})")


# ---- device-trace reduction ----------------------------------------------
# jax.named_scope names of the batched pipeline's phases
# (engine/pipeline_batch.py::nmpc_step_batched)
PHASE_SCOPES = ("refs", "tube", "corridor", "reuse", "tighten", "solve")


def _scope_of(op_name: str):
    return next((p for p in op_name.split("/") if p in PHASE_SCOPES), None)


def hlo_op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the phase scope in its op_name metadata.

    Instructions without metadata of their own (fusions, loops) take the
    scope of the first scoped instruction in a computation they call;
    what has none is 'other'."""
    comp_scope, inst, cur = {}, {}, None
    head = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$")
    body = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
    for line in hlo_text.splitlines():
        m = head.match(line)
        if m:
            cur = m.group(1)
            continue
        m = body.match(line)
        if not m:
            continue
        name, rest = m.groups()
        op = re.search(r'op_name="([^"]*)"', rest)
        scope = _scope_of(op.group(1)) if op else None
        calls = re.findall(
            r"(?:calls|body|condition|to_apply)=%?([\w.\-]+)", rest)
        inst[name] = (scope, calls)
        if scope and cur and cur not in comp_scope:
            comp_scope[cur] = scope
    out = {}
    for name, (scope, calls) in inst.items():
        if scope is None:
            scope = next((comp_scope[c] for c in calls if c in comp_scope),
                         None)
        # kernels are named after their instruction with '.'/'-' -> '_'
        out[name] = out[re.sub(r"[.\-]", "_", name)] = scope or "other"
    return out


def device_events(trace_dir) -> list:
    """(line, kernel, start_ns, dur_ns, hlo_op, hlo_module) of every event
    on the GPU device planes of the newest profiler trace in trace_dir."""
    from jax.profiler import ProfileData

    files = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda f: f.stat().st_mtime)
    if not files:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    data = ProfileData.from_file(str(files[-1]))
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                st = dict(e.stats)
                out.append((line.name, e.name, float(e.start_ns),
                            float(e.duration_ns), str(st.get("hlo_op", "")),
                            str(st.get("hlo_module", ""))))
    return out


def event_scope(event, scopes: dict) -> str:
    """Phase of one device event.  Kernels launched from a command buffer
    carry 'command_buffer' as their hlo_op, so the kernel name (the fusion
    instruction's name) is looked up first; a Pallas kernel is named after
    its phase (corridor_decompose)."""
    name, hlo_op = event[1], event[4]
    return (scopes.get(name) or scopes.get(hlo_op)
            or next((p for p in PHASE_SCOPES if name.startswith(p)),
                    "other"))


def reduce_trace(events, scopes: dict | None = None,
                 module: str | None = None) -> dict:
    """Device busy/idle over the traced window and kernel time per phase.

    events: device_events(...); scopes: hlo_op_scopes(...) of the traced
    program; module: keep only events of this HLO module (substring)."""
    ev = [e for e in events if module is None or module in e[5]]
    if not ev:
        return {"n_kernels": 0}
    iv = sorted((e[2], e[2] + e[3]) for e in ev)
    busy, end = 0.0, iv[0][0]
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = iv[-1][1] - iv[0][0]
    phase_ns, phase_n = {}, {}
    for e in ev:
        k = event_scope(e, scopes or {})
        phase_ns[k] = phase_ns.get(k, 0.0) + e[3]
        phase_n[k] = phase_n.get(k, 0) + 1
    return dict(
        n_kernels=len(ev),
        window_ms=window / 1e6,
        busy_ms=busy / 1e6,
        idle_share=1.0 - busy / window if window > 0 else 0.0,
        kernel_ms=sum(e[3] for e in ev) / 1e6,
        phase_ms={k: v / 1e6 for k, v in sorted(phase_ns.items())},
        phase_kernels=dict(sorted(phase_n.items())),
    )


def _throughput(C):
    """Batched-sweep throughput (the headline metric)."""
    from forces_resilient_planner_tpu.engine import batch as bm

    B = N_GOALS * N_FORCES * len(HALVES)

    # compile (scenario expansion runs on the device: only the scenario
    # seeds — a few KB — cross the host-device boundary per call)
    g0, f0 = bench_seeds(1)
    r = bm.solve_scenario_grid(C, g0, f0, HALVES)
    _ = np.asarray(r.Z)

    reps = 8
    sets = [bench_seeds(1000 + s) for s in range(reps)]
    lat, solved, iters = [], 0, []
    for g, f in sets:
        t0 = time.perf_counter()
        r = bm.solve_scenario_grid(C, g, f, HALVES)
        ec = np.asarray(r.exit_code)
        lat.append(time.perf_counter() - t0)
        solved += int((ec == 1).sum())
        iters.append(float(np.asarray(r.iters).mean()))
    lat = np.asarray(lat)

    # streamed: set k+1's dispatches are issued while set k still runs
    stream_rates, stream_solved, stream_n = [], 0, 0
    n_repeats = 5
    for rep in range(n_repeats):
        stream_sets = [
            bench_seeds(3000 + 100 * rep + s) for s in range(reps)
        ]
        t0 = time.perf_counter()
        results = bm.solve_scenario_stream(C, stream_sets, HALVES)
        stream_solved += sum(
            int(np.asarray(r.exit_code == 1).sum()) for r in results
        )
        stream_wall = time.perf_counter() - t0
        stream_rates.append(B * reps / stream_wall)
        stream_n += B * reps
    stream_rates = np.asarray(stream_rates)
    return dict(
        B=B,
        solves_per_s=float(np.median(stream_rates)),
        stream_min=float(stream_rates.min()),
        stream_max=float(stream_rates.max()),
        stream_repeats=n_repeats,
        percall_solves_per_s=B / lat.mean(),
        stream_solved_frac=stream_solved / stream_n,
        mean_ms=lat.mean() * 1e3,
        min_ms=lat.min() * 1e3,
        p99_batch_ms=float(np.percentile(lat, 99)) * 1e3,
        solved_frac=solved / (B * reps),
        iters_mean=float(np.mean(iters)),
    )


def _single_solve(C):
    """B=1 solve latency vs the reference's 50 ms budget
    (nmpc_manage.cpp:46).  Untiered (tier compaction is a batch concept)."""
    from forces_resilient_planner_tpu.engine import batch as bm

    C1 = dataclasses.replace(
        C, solver=dataclasses.replace(C.solver, tiers=())
    )
    g0, f0 = bench_seeds(1, n_goals=1, n_forces=1)
    r = bm.solve_scenario_grid(C1, g0, f0, HALVES)
    _ = np.asarray(r.Z)

    lat, solved = [], 0
    reps = 50
    for s in range(reps):
        g, f = bench_seeds(2000 + s, n_goals=1, n_forces=1)
        t0 = time.perf_counter()
        r = bm.solve_scenario_grid(C1, g, f, HALVES)
        ec = np.asarray(r.exit_code)
        lat.append(time.perf_counter() - t0)
        solved += int((ec == 1).sum())
    lat = np.asarray(lat) * 1e3
    return dict(
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        solved_frac=solved / reps,
    )


def _pipeline_step():
    """Full nmpc_step (references -> tubes -> corridors -> tighten -> solve)
    B=1 latency — the driver entry configuration
    (__graft_entry__._small_cfg), compile-warm."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge

    fn, args = ge.entry()
    jfn = jax.jit(fn)
    out = jfn(*args)
    _ = np.asarray(out[1])

    lat = []
    for s in range(30):
        a = list(args)
        rng = np.random.default_rng(s)
        a[4] = args[4] + jnp.asarray(rng.normal(0, 1e-3, 9), args[4].dtype)
        a[5] = args[5] + jnp.asarray(rng.normal(0, 1e-3, 3), args[5].dtype)
        t0 = time.perf_counter()
        out = jfn(*a)
        _ = np.asarray(out[1])
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    return dict(
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
    )


def make_pipeline_fn(cfg=None):
    """The batched full-pipeline program this benchmark times.  Returns a
    jitted fn over an arg dict (engine/scenarios.PIPELINE_ARG_KEYS) with
    the full NMPCStepResult as output."""
    import jax

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.engine.pipeline_batch import (
        nmpc_step_batched,
    )
    from forces_resilient_planner_tpu.engine.scenarios import (
        PIPELINE_ARG_KEYS,
    )

    cfg = cfg or DEFAULT_CONFIG
    return jax.jit(
        lambda a: nmpc_step_batched(*[a[k] for k in PIPELINE_ARG_KEYS],
                                    cfg=cfg)
    )


def pipeline_inputs(B, seed, cfg=None):
    """Device-resident per-lane scene inputs (engine/scenarios.py)."""
    import jax

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.engine.scenarios import pipeline_lanes

    lanes = pipeline_lanes(cfg or DEFAULT_CONFIG, B, seed=seed)
    return jax.block_until_ready(jax.device_put(lanes))


def _pipeline_batched(B=4096):
    """Batched FULL-pipeline throughput at production corridor caps
    (engine/pipeline_batch.py::nmpc_step_batched), every lane with its own
    seeded two-fence scene filling the 2,048-point obstacle buffer."""
    import jax

    step = make_pipeline_fn()
    out = step(pipeline_inputs(B, 500))
    jax.block_until_ready(out)
    # inputs staged on the device first: sweeps and fleets keep their
    # state device-resident between ticks
    sets = [pipeline_inputs(B, 501 + s) for s in range(4)]
    lat, solved = [], []
    for a in sets:
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(a))
        lat.append(time.perf_counter() - t0)
        solved.append(float(np.mean(np.asarray(out.exit_code) == 1)))
    lat = np.asarray(lat)

    from forces_resilient_planner_tpu.engine.pipeline_batch import (
        nmpc_step_stream,
    )

    t0 = time.perf_counter()
    jax.block_until_ready(nmpc_step_stream(step, sets))
    stream_wall = time.perf_counter() - t0
    return dict(
        batch=B,
        batched_steps_per_s=float(B / np.median(lat)),
        streamed_steps_per_s=float(B * len(sets) / stream_wall),
        solved_frac=float(np.mean(solved)),
    )


def _closed_loop_smoke(dtype=None):
    """Config-3 closed loop: fence scene + time-varying wind flown by the
    complete stack (occupancy map, kinodynamic search, corridors, tubes,
    solver, FSM, 100 Hz commands) at DEFAULT_CONFIG's map (40x40x6 m at
    0.1 m) and search pool.  Reports goal reached, fence never crossed,
    and the per-tick solve p50/p99 against the reference's 50 ms budget
    (nmpc_manage.cpp:46)."""
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    from forces_resilient_planner_tpu.engine.planner import ResilientPlanner
    from forces_resilient_planner_tpu.engine.simulator import (
        QuadSim,
        run_closed_loop,
    )

    planner = ResilientPlanner(C, max_cloud=2048,
                               dtype=dtype or jnp.float32)
    x0 = np.zeros(9)
    x0[2] = 1.2
    sim = QuadSim(C.model, x0.copy(), np.zeros(3))
    planner.on_odometry(x0)

    ys = np.arange(-3, 3, 0.1)
    zs = np.arange(0, 2.6, 0.1)
    yy, zz = np.meshgrid(ys, zs)
    pts = np.stack([np.full(yy.size, 1.5), yy.ravel(), zz.ravel()], -1)
    planner.set_occupied(pts[~((pts[:, 1] > -0.2) & (pts[:, 1] < 1.6))])

    def wind(t):
        return np.array([0.8 * np.sin(0.5 * t), 0.0, 0.0])

    trace = run_closed_loop(
        planner, sim, [3.5, 0.0], duration=7.0, force_schedule=wind
    )
    final = trace["pos"][-1]
    reached = bool(np.linalg.norm(final - np.array([3.5, 0.0, 1.2])) < 0.5)
    no_collision = not any(
        1.35 < p[0] < 1.65 and not (-0.2 < p[1] < 1.7) for p in trace["pos"]
    )
    # steady-state solves: the first few ticks pay one-time compiles
    samples = np.asarray(
        planner.diag.timers._phases["solve"].samples[3:]) * 1e3
    return dict(
        reached=reached,
        no_collision=no_collision,
        solve_p50_ms=float(np.percentile(samples, 50)),
        solve_p99_ms=float(np.percentile(samples, 99)),
        budget_ms=50.0,
        solves=planner.diag.solves,
        final=[float(v) for v in final],
    )


def _fleet_bench(B=128, duration=8.0, dtype=None):
    """Fleet closed loop (engine/fleet.py): B scenarios through vmapped
    search + batched NMPC + device plant on tools/fleet_probe.py's fence
    scene."""
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "tools"))
    import fleet_probe as fp

    from forces_resilient_planner_tpu.engine import fleet

    cfg = fp.fleet_cfg()
    dtype = dtype or jnp.float32
    grid, obs, mask = fp.fleet_scene(cfg, dtype)
    starts, goals, f_true = fp.fleet_lanes(B)
    res = fleet.run_fleet(
        cfg, grid, jnp.asarray(obs, dtype), mask, starts, goals, f_true,
        duration=duration, replan_every=10, dtype=dtype,
    )
    return dict(
        batch=B,
        reached_frac=res.reached_frac,
        collided_frac=res.collided_frac,
        solved_frac=res.solved_frac,
        realtime_factor=B * duration / res.wall_s,
        searches=res.searches,
        outcomes=res.outcome_counts,
        tick_codes=res.tick_code_fracs,
        mean_time_to_goal=float(np.nanmean(res.time_to_goal))
        if np.isfinite(res.time_to_goal).any() else None,
    )


def main():
    require_gpu()
    setup_cache()
    card = card_info()
    print(f"[bench] card: {card}", file=sys.stderr)

    C = bench_config()
    tp = _throughput(C)
    print(
        f"[bench] batch={tp['B']} mean={tp['mean_ms']:.3f}ms "
        f"min={tp['min_ms']:.3f}ms p99={tp['p99_batch_ms']:.3f}ms "
        f"solved={tp['solved_frac']:.4f} iters_mean={tp['iters_mean']:.3f}; "
        f"streamed median {tp['solves_per_s']:.1f} solves/s "
        f"[{tp['stream_min']:.1f}, {tp['stream_max']:.1f}]",
        file=sys.stderr,
    )
    extras = {
        "card": card,
        "percall_solves_per_s": tp["percall_solves_per_s"],
        "streamed_range": [tp["stream_min"], tp["stream_max"]],
        "streamed_repeats": tp["stream_repeats"],
        "solved_frac": tp["stream_solved_frac"],
        "iters_mean": tp["iters_mean"],
    }

    ss = _single_solve(C)
    extras["single_solve_p50_ms"] = ss["p50_ms"]
    extras["single_solve_p99_ms"] = ss["p99_ms"]
    ps = _pipeline_step()
    extras["pipeline_step_p50_ms"] = ps["p50_ms"]
    extras["pipeline_step_p99_ms"] = ps["p99_ms"]
    pb = _pipeline_batched()
    extras["pipeline_batch"] = pb["batch"]
    extras["pipeline_batched_steps_per_s"] = pb["batched_steps_per_s"]
    extras["pipeline_streamed_steps_per_s"] = pb["streamed_steps_per_s"]
    extras["pipeline_solved_frac"] = pb["solved_frac"]
    cl = _closed_loop_smoke()
    if not (cl["reached"] and cl["no_collision"]):
        raise SystemExit(f"closed loop failed: {cl}")
    extras["closed_loop_solve_p50_ms"] = cl["solve_p50_ms"]
    extras["closed_loop_solve_p99_ms"] = cl["solve_p99_ms"]
    fl = _fleet_bench()
    extras["fleet_reached_frac"] = fl["reached_frac"]
    extras["fleet_collided_frac"] = fl["collided_frac"]
    extras["fleet_realtime_factor"] = fl["realtime_factor"]
    extras["fleet_outcomes"] = fl["outcomes"]
    for k, v in extras.items():
        print(f"[bench] {k}: {v}", file=sys.stderr)

    baseline_rate = 20.0  # reference: one solve per 50 ms tick
    print(json.dumps({
        "metric": "nmpc_solves_per_s_N20_batch4096",
        "value": float(tp["solves_per_s"]),
        "unit": "solves/s",
        "vs_baseline": float(tp["solves_per_s"] / baseline_rate),
        "device": device_record(),
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
