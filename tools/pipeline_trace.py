"""Device-time attribution of the batched pipeline on one card.

Measures, at B=4096 on bench.py's per-lane scenes:
  ab        end-to-end nmpc_step_batched time with the corridor kernel vs
            the XLA corridor path, interleaved (K X X K ...) on fresh
            device-resident inputs;
  phases    one profiler trace of each variant reduced to device time per
            phase scope (refs / tube / corridor / reuse / tighten / solve)
            and the device's busy and idle share (bench.reduce_trace);
  ipm       the untiered lane-major solver on bench.py's B=4096 workload:
            device time and kernel launches per IPM iteration (one
            lockstep while-loop trip per iteration, max(iters) trips).
Prints one JSON line; the full record and each phase's heaviest kernels
go to chiprun_out/pipeline_trace.json.

Usage: python tools/pipeline_trace.py [--pairs 6]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402


def _timed(fn, *a):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*a))
    return out, time.perf_counter() - t0


def _trace(fn, *a):
    """(device events, compiled HLO text) of one call of jitted fn."""
    import jax

    hlo = fn.lower(*a).compile().as_text()
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(fn(*a))
        return bench.device_events(d), hlo


def _event_summary(events, scopes=None, top=12):
    """Per phase: its heaviest kernels (ms summed over the trace)."""
    by = collections.defaultdict(lambda: collections.defaultdict(float))
    for e in events:
        by[bench.event_scope(e, scopes or {})][e[1]] += e[3] / 1e6
    return {
        phase: dict(sorted(k.items(), key=lambda kv: -kv[1])[:top])
        for phase, k in by.items()
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=6)
    args = ap.parse_args()

    import jax

    from forces_resilient_planner_tpu.engine import batch as bm
    from forces_resilient_planner_tpu.ops import corridor_pallas
    from forces_resilient_planner_tpu.solver import ipm_lanes

    bench.require_gpu()
    bench.setup_cache()
    B = 4096
    rec = {"card": bench.card_info(), "device": bench.device_record(),
           "batch": B}

    kern = bench.make_pipeline_fn()
    xla = bench.make_pipeline_fn()
    inputs = [bench.pipeline_inputs(B, 900 + s) for s in range(4)]
    _, rec["kernel_first_call_s"] = _timed(kern, inputs[0])
    with mock.patch.object(corridor_pallas, "corridor_kernel_enabled",
                           lambda *a: False):
        _, rec["xla_first_call_s"] = _timed(xla, inputs[0])

    # interleaved A/B: K X X K, repeated, each call on the next input set
    samples = {"kernel": [], "xla": []}
    k = 0
    for p in range(args.pairs):
        order = ("kernel", "xla") if p % 2 == 0 else ("xla", "kernel")
        for name in order:
            fn = kern if name == "kernel" else xla
            _, dt = _timed(fn, inputs[k % len(inputs)])
            samples[name].append(dt * 1e3)
            k += 1
    rec["ab_ms"] = samples
    rec["ab_median_ms"] = {n: float(np.median(v)) for n, v in samples.items()}

    raw = {}
    for name, fn in (("kernel", kern), ("xla", xla)):
        with mock.patch.object(corridor_pallas, "corridor_kernel_enabled",
                               lambda *a: name == "kernel"):
            ev, hlo = _trace(fn, inputs[1])
        scopes = bench.hlo_op_scopes(hlo)
        rec[f"phases_{name}"] = bench.reduce_trace(ev, scopes)
        raw[name] = _event_summary(ev, scopes)
        raw[name + "_unmapped"] = sorted(
            {e[1] for e in ev if e[1] not in scopes})[:40]
        raw[name + "_hlo_names"] = sorted(scopes)[:40]

    # IPM iteration cost: untiered lane solver, bench workload, B=4096
    C = bench.bench_config()
    C1 = dataclasses.replace(C, solver=dataclasses.replace(C.solver, tiers=()))
    g, f = bench.bench_seeds(1000)
    scen = jax.device_put(bm.make_scenarios(C1, g, f, bench.HALVES))

    @jax.jit
    def ipm_solve(Z0, params):
        return ipm_lanes.solve_batch_lanes_tiered(Z0, params, C1.model,
                                                  C1.solver)

    r, first_s = _timed(ipm_solve, scen.Z0, scen.params)
    trips = int(np.asarray(r.iters).max())
    walls = [_timed(ipm_solve, scen.Z0, scen.params)[1] for _ in range(5)]
    ev, _ = _trace(ipm_solve, scen.Z0, scen.params)
    red = bench.reduce_trace(ev, module="ipm_solve")
    raw["ipm"] = _event_summary(ev)
    rec["ipm"] = dict(
        batch=int(scen.batch), first_call_s=first_s,
        while_trips=trips, iters_mean=float(np.asarray(r.iters).mean()),
        wall_ms_median=float(np.median(walls) * 1e3),
        device_kernel_ms=red.get("kernel_ms"),
        idle_share=red.get("idle_share"),
        kernels=red.get("n_kernels"),
        device_ms_per_iter=red.get("kernel_ms", 0.0) / trips,
        launches_per_iter=red.get("n_kernels", 0) / trips,
    )
    out = ROOT / "chiprun_out" / "pipeline_trace.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(rec, raw=raw), indent=1, default=float))
    print(json.dumps(rec, default=float), flush=True)


if __name__ == "__main__":
    main()
