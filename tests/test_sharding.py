"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.engine import batch as bm
from forces_resilient_planner_tpu.parallel import mesh as pm


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_batched_scenarios_solve():
    goals = np.array([[1.0, 0.0, 1.2], [0.5, 1.0, 1.3], [-1.0, 0.5, 1.1], [1.5, -0.5, 1.2]])
    forces = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    halves = np.array([[5.0, 5.0, 2.0]])
    scen = bm.make_scenarios(C, goals, forces, halves, dtype=jnp.float64)
    assert scen.batch == 8
    res = bm.solve_scenarios(scen, C)
    assert np.all(np.asarray(res.exit_code) == 1), np.asarray(res.kkt_error)


def test_sharded_sweep_matches_single_device():
    mesh = pm.make_mesh(shape=(2, 4))
    goals = np.array([[1.0, 0.0, 1.2], [0.5, 1.0, 1.3], [-1.0, 0.5, 1.1], [1.5, -0.5, 1.2]])
    forces = np.array([[0.0, 0.0, 0.0], [0.8, -0.5, 0.2]])
    halves = np.array([[5.0, 5.0, 2.0]])
    scen = bm.make_scenarios(C, goals, forces, halves, dtype=jnp.float64)

    res_local = bm.solve_scenarios(scen, C)

    scen_sh = pm.shard_scenarios(scen, mesh)
    run = pm.make_sharded_solver(C, mesh)
    res_sh, stats = run(scen_sh)

    np.testing.assert_allclose(
        np.asarray(res_sh.Z), np.asarray(res_local.Z), atol=5e-8
    )
    assert int(stats.n_solved) == 8
    # the sharded result really is distributed
    assert len(res_sh.Z.sharding.device_set) == 8


def test_monte_carlo_sweep_runs():
    mesh = pm.make_mesh(shape=(2, 4))
    res, stats = pm.monte_carlo_sweep(
        C, mesh, n_goals=4, n_forces=4, dtype=jnp.float64
    )
    assert int(stats.n) == 16
    assert int(stats.n_solved) >= 14  # nearly all trivial scenarios solve


def test_default_mesh_is_one_batch_axis():
    """One host's cards reach each other all to all: the default mesh is
    one 'batch' axis over every device; an explicit 2-D shape keeps the
    (host, chip) axes of the multi-process path."""
    mesh = pm.make_mesh()
    assert mesh.axis_names == ("batch",)
    assert mesh.devices.shape == (len(jax.devices()),)
    assert pm.batch_sharding(mesh).spec == pm.P(("batch",))
    assert pm.make_mesh(shape=(2, 4)).axis_names == ("host", "chip")
