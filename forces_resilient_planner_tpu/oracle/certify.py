"""Checks that certify what the device computed, independent of the device.

The accelerator runs f32; the references here run f64.  Three checks:

  oracle     — the independent f64 SLSQP oracle (oracle/cpu_oracle.py)
               re-solves scenario-grid lanes; the device's controls must
               agree to the repo's 1e-3 contract (BASELINE.json).
  resolve    — the f64 lane-major IPM re-solves the exact NLP that the
               device's batched pipeline assembled (its corridors,
               tightening, references): the solver-parity claim extended
               to pipeline-generated parameters.  Comparing controls
               THROUGH the corridor generator is not meaningful: its
               shrink/peel argmin flips plane selections at machine
               precision (PARITY.md), so the pipeline is certified on its
               own outputs.
  penetration — geometric audit in f64 numpy: how deep any obstacle sits
               inside the tightened corridor polytope the device produced.

oracle and resolve need jax_enable_x64 and must not open the accelerator
(a second JAX process on the card fails for want of memory), so they run
in a child process started with JAX_PLATFORMS=cpu in its environment:
run_cpu_child(task, arrays) -> result dict.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np


def pick_lanes(exit_code: np.ndarray, iters: np.ndarray, n: int) -> np.ndarray:
    """Hard lanes first (highest iteration counts), topped up with an even
    spread; solved lanes only (empty when nothing solved)."""
    solved = np.flatnonzero(exit_code == 1)
    if solved.size == 0:
        return solved
    hard = solved[np.argsort(iters[solved], kind="stable")[::-1][: n // 2]]
    spread = solved[np.linspace(0, solved.size - 1, n).astype(int)]
    rest = np.setdiff1d(spread, hard)
    return np.concatenate([hard, rest])[:n]


def corridor_penetration(
    A: np.ndarray,        # (L, N, nh, 3) selected corridor rows
    b: np.ndarray,        # (L, N, nh) tightened offsets
    obs: np.ndarray,      # (L, M, 3)
    mask: np.ndarray,     # (L, M)
) -> float:
    """Max depth [m] of any valid obstacle strictly inside any stage's
    polytope {x : A x <= b} over its nonzero rows (0 = sound)."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    obs = np.asarray(obs, np.float64)
    act = np.linalg.norm(A, axis=-1) > 1e-9                 # (L, N, nh)
    worst = 0.0
    for lane in range(A.shape[0]):
        o = obs[lane][np.asarray(mask[lane], bool)]        # (m, 3)
        s = np.einsum("nkj,mj->nmk", A[lane], o) - b[lane][:, None, :]
        s = np.where(act[lane][:, None, :], s, -np.inf)
        depth = -np.max(s, axis=-1)                        # (N, m)
        worst = max(worst, float(np.max(depth, initial=0.0)))
    return worst


def run_cpu_child(task: str, arrays: dict, timeout: float = 900.0) -> dict:
    """Run `task` of this module in a CPU-only f64 child process.

    The child never initializes the accelerator: JAX_PLATFORMS=cpu is in
    its environment before it imports JAX."""
    with tempfile.TemporaryDirectory() as tmp:
        inp = Path(tmp) / "in.npz"
        np.savez(inp, **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_PYTHON_CLIENT_MEM_FRACTION", None)
        root = Path(__file__).resolve().parents[2]
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
        out = subprocess.run(
            [sys.executable, "-m", __name__, task, str(inp)],
            env=env, capture_output=True, text=True, timeout=timeout,
        )
    if out.returncode != 0:
        raise RuntimeError(
            f"certify child {task!r} failed (rc {out.returncode}):\n"
            + out.stdout[-2000:] + out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---- child tasks (CPU, x64) ------------------------------------------------

def _lane_params(d, dtype):
    import jax
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG
    from forces_resilient_planner_tpu.solver import nlp

    N = DEFAULT_CONFIG.model.N
    L = d["xinit"].shape[0]
    wn = nlp.make_stage_weights(DEFAULT_CONFIG.weights, N, final=False,
                                dtype=dtype)
    wf = nlp.make_stage_weights(DEFAULT_CONFIG.weights, N, final=True,
                                dtype=dtype)
    fin = np.asarray(d["use_final"], bool)
    weights = jax.tree.map(
        lambda a, b: jnp.where(
            fin.reshape((L,) + (1,) * a.ndim), b[None], a[None]),
        wn, wf,
    )
    return nlp.NLPParams(
        xinit=jnp.asarray(d["xinit"], dtype),
        ref_pos=jnp.asarray(d["ref_pos"], dtype),
        ref_yaw=jnp.asarray(d["ref_yaw"], dtype),
        f_ext=jnp.asarray(d["f_ext"], dtype),
        corridor_A=jnp.asarray(d["corridor_A"], dtype),
        corridor_b=jnp.asarray(d["corridor_b"], dtype),
        weights=weights,
    )


def _task_oracle(d) -> dict:
    """SLSQP f64 oracle on scenario-grid lanes (engine/batch.py seeds)."""
    import jax
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    from forces_resilient_planner_tpu.engine import batch as bm
    from forces_resilient_planner_tpu.oracle.cpu_oracle import solve_oracle

    scen = bm.make_scenarios(C, d["goals"], d["forces"], d["halves"],
                             dtype=jnp.float64)
    diffs, status = [], []
    for j, lane in enumerate(d["lanes"]):
        p = jax.tree.map(lambda a: a[int(lane)], scen.params)
        Z, res = solve_oracle(p, C.model, C.solver)
        if int(res.status) != 0:
            # SLSQP often stops with status 8 AT the optimum when ftol is
            # below what the condensed f64 objective resolves
            Z, res = solve_oracle(p, C.model, C.solver, ftol=1e-10)
        diffs.append(float(np.abs(Z[:, 0:4] - d["u"][j]).max()))
        status.append(int(res.status))
    return {"max_u_diff": max(diffs), "u_diffs": diffs,
            "oracle_status": status}


def _task_resolve(d) -> dict:
    """f64 re-solve of the device-assembled pipeline NLP lanes."""
    import jax
    import jax.numpy as jnp

    from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
    from forces_resilient_planner_tpu.solver import ipm_lanes

    params = _lane_params(d, jnp.float64)
    r = jax.jit(
        lambda z, p: ipm_lanes.solve_batch_lanes_tiered(
            z, p, C.model, C.solver)
    )(jnp.asarray(d["Z0"], jnp.float64), params)
    ec = np.asarray(r.exit_code)
    both = (ec == 1) & (d["exit_code"] == 1)
    du = np.abs(np.asarray(r.Z[:, :, 0:4]) - d["u"]).reshape(len(ec), -1)
    du = du.max(axis=1)[both]
    return {
        "n_both_solved": int(both.sum()),
        "exit_agree": float((ec == d["exit_code"]).mean()),
        "max_u_diff": float(du.max()) if both.any() else None,
    }


_TASKS = {"oracle": _task_oracle, "resolve": _task_resolve}


def _child_main(task: str, path: str):
    import jax

    jax.config.update("jax_enable_x64", True)
    if jax.default_backend() != "cpu":
        raise SystemExit("certify child must run with JAX_PLATFORMS=cpu")
    d = dict(np.load(path))
    print(json.dumps(_TASKS[task](d)), flush=True)


if __name__ == "__main__":
    _child_main(sys.argv[1], sys.argv[2])
