"""Tube-propagation parity tests.

Independent check: a direct NumPy/SciPy transcription of
NMPCSolver::getDistrEllipsoid (nmpc_solver.cpp:567-611) using
scipy.linalg.solve_sylvester (the same Bartels-Stewart algorithm Eigen's
matrix_function_solve_triangular_sylvester implements), compared against the
JAX Kronecker-solve implementation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla

from forces_resilient_planner_tpu.config import DEFAULT_CONFIG as C
from forces_resilient_planner_tpu.tube import lyapunov as tl
from forces_resilient_planner_tpu.dynamics.quadrotor import euler_to_rot
from forces_resilient_planner_tpu.tube.lyapunov import (
    channel_Qd,
    closed_loop_phi,
    lyapunov_solve,
    minkowski_sum,
    propagate_tubes,
    sqrtm_psd,
    tighten_corridor,
)

RNG = np.random.default_rng(42)
K = C.K_matrix()


def rand_phi():
    x = RNG.uniform(-0.5, 0.5, 9)
    x[2] = 1.2
    u = np.array([0.1, -0.2, 0.05, 7.3])
    return np.asarray(closed_loop_phi(jnp.asarray(x), jnp.asarray(u), jnp.asarray(K), C.model))


def test_lyapunov_solve_residual():
    Phi = rand_phi()
    W = RNG.standard_normal((9, 9))
    W = W + W.T
    X = np.asarray(lyapunov_solve(jnp.asarray(Phi), jnp.asarray(W)))
    np.testing.assert_allclose(Phi @ X + X @ Phi.T, W, atol=1e-9)


def test_lyapunov_matches_scipy_sylvester():
    Phi = rand_phi()
    W = RNG.standard_normal((9, 9))
    X_scipy = sla.solve_sylvester(Phi, Phi.T, W)
    X_ours = np.asarray(lyapunov_solve(jnp.asarray(Phi), jnp.asarray(W)))
    np.testing.assert_allclose(X_ours, X_scipy, rtol=1e-8, atol=1e-10)


def reference_distr_ellipsoid(t, Q_origin, Phi, w):
    """NumPy transcription of getDistrEllipsoid (nmpc_solver.cpp:567-611),
    with the intended temp=0 initialization."""
    D = np.zeros((9, 3))
    D[3, 0] = D[4, 1] = D[5, 2] = 1.0
    temp = 0.0
    temp_Q = np.zeros((9, 9))
    for i in range(3):
        Nt = t * w[i] ** 2 * np.outer(D[:, i], D[:, i])
        Array_Q = Nt - sla.expm(-Phi * t) @ Nt @ sla.expm(-Phi.T * t)
        X = sla.solve_sylvester(Phi, Phi.T, Array_Q)
        temp += np.sqrt(np.trace(X))
        temp_Q += X / np.sqrt(np.trace(X))
    Qd = temp * temp_Q
    beta = np.sqrt(np.trace(Q_origin) / np.trace(Qd))
    Q_update = (1 + 1 / beta) * Q_origin + (1 + beta) * Qd
    position_Q = sla.expm(Phi * t) @ Q_update @ sla.expm(Phi.T * t)
    return position_Q[0:3, 0:3], Q_update


def test_channel_Qd_matches_reference_transcription():
    Phi = rand_phi()
    w = np.full(3, C.tube.ext_noise_bound)
    t = C.model.dt
    Qd_ours = np.asarray(channel_Qd(jnp.asarray(Phi), t, jnp.asarray(w)))
    # reference Qd (before the Q_origin combination)
    D = np.zeros((9, 3))
    D[3, 0] = D[4, 1] = D[5, 2] = 1.0
    temp, temp_Q = 0.0, np.zeros((9, 9))
    for i in range(3):
        Nt = t * w[i] ** 2 * np.outer(D[:, i], D[:, i])
        Array_Q = Nt - sla.expm(-Phi * t) @ Nt @ sla.expm(-Phi.T * t)
        X = sla.solve_sylvester(Phi, Phi.T, Array_Q)
        temp += np.sqrt(np.trace(X))
        temp_Q += X / np.sqrt(np.trace(X))
    np.testing.assert_allclose(Qd_ours, temp * temp_Q, rtol=1e-7, atol=1e-12)


def test_full_stage_recursion_matches_reference():
    """Run the 20-stage recursion both ways from the same hover-ish solution."""
    N = C.model.N
    Z = np.zeros((N, 17))
    Z[:, 3] = 7.3
    Z[:, 10] = 1.2
    Z[:, 11] = 0.5  # some velocity
    Z[:, 14:17] = RNG.uniform(-0.1, 0.1, (N, 3))
    res = propagate_tubes(jnp.asarray(Z), C.model, C.tube, jnp.asarray(K))

    t = C.model.dt
    w = np.full(3, C.tube.ext_noise_bound)
    Q_init = C.tube.epsilon**2 * np.eye(9)
    ego = np.diag([C.tube.ego_r**2, C.tube.ego_r**2, C.tube.ego_h**2])
    Q2_prev = None
    for i in range(N):
        x, u = Z[i, 8:17], Z[i, 0:4]
        Phi = np.asarray(
            closed_loop_phi(jnp.asarray(x), jnp.asarray(u), jnp.asarray(K), C.model)
        )
        R = np.asarray(euler_to_rot(jnp.asarray(Z[i, 14:17])))
        Q1 = R @ ego @ R.T
        if i == 0:
            Q = Q1
        else:
            beta = np.sqrt(np.trace(Q1) / np.trace(Q2_prev))
            Q = (1 + 1 / beta) * Q1 + (1 + beta) * Q2_prev
        E_ref = sla.sqrtm(Q).real
        np.testing.assert_allclose(np.asarray(res.E[i]), E_ref, rtol=1e-6, atol=1e-9)
        Q2_prev, Q_init = reference_distr_ellipsoid(t, Q_init, Phi, w)


def test_minkowski_contains_both():
    """The approximation must dominate both summands (PSD ordering)."""
    A = RNG.standard_normal((3, 3)); Q1 = A @ A.T + 0.1 * np.eye(3)
    B = RNG.standard_normal((3, 3)); Q2 = B @ B.T + 0.1 * np.eye(3)
    Q = np.asarray(minkowski_sum(jnp.asarray(Q1), jnp.asarray(Q2)))
    assert np.linalg.eigvalsh(Q - Q1).min() > -1e-10
    assert np.linalg.eigvalsh(Q - Q2).min() > -1e-10


def test_sqrtm_psd():
    A = RNG.standard_normal((3, 3))
    Q = A @ A.T + 0.05 * np.eye(3)
    E = np.asarray(sqrtm_psd(jnp.asarray(Q)))
    np.testing.assert_allclose(E @ E, Q, rtol=1e-9, atol=1e-12)


def test_tighten_corridor():
    """b_j - ||E a_j|| exactly as packed in forces_normal.cpp:111-136."""
    A = RNG.standard_normal((30, 3))
    A[10:] = 0.0  # padding rows
    b = RNG.standard_normal(30)
    b[10:] = 0.0
    M = RNG.standard_normal((3, 3))
    E = M @ M.T
    bt = np.asarray(tighten_corridor(jnp.asarray(A), jnp.asarray(b), jnp.asarray(E)))
    for j in range(10):
        assert abs(bt[j] - (b[j] - np.linalg.norm(E @ A[j]))) < 1e-10
    np.testing.assert_allclose(bt[10:], 0.0, atol=1e-12)


def test_gramian_channels_matches_van_loan_oracle():
    """channel_Qd_fast / gramian_channels (matmul-only doubling path) vs the
    Van Loan + LU oracle (channel_Qd / lyapunov_gramian) across random
    linearization points."""
    rng = np.random.default_rng(17)
    w = jnp.full((3,), C.tube.ext_noise_bound)
    for k in range(10):
        x = jnp.asarray(rng.normal(0, 0.5, 9))
        u = jnp.asarray(np.array([0, 0, 0, 7.3]) + rng.normal(0, 0.6, 4))
        Phi = tl.closed_loop_phi(x, u, jnp.asarray(C.tube.K), C.model)
        Qd_ref = tl.channel_Qd(Phi, C.model.dt, w)
        Qd_new, Mp = tl.channel_Qd_fast(Phi, C.model.dt, w)
        assert float(jnp.max(jnp.abs(Qd_new - Qd_ref))) < 1e-14
        Mp_ref = jax.scipy.linalg.expm(Phi * C.model.dt)
        assert float(jnp.max(jnp.abs(Mp - Mp_ref))) < 1e-12


def test_sqrtm_db_matches_eigh():
    rng = np.random.default_rng(3)
    for _ in range(20):
        A = rng.normal(0, 1.0, (3, 3))
        Q = A @ A.T * 10 ** rng.uniform(-4, 1)
        got = tl.sqrtm_psd_db(jnp.asarray(Q))
        want = tl.sqrtm_psd(jnp.asarray(Q))
        scale = 1e-9 + float(jnp.max(jnp.abs(want)))
        assert float(jnp.max(jnp.abs(got - want))) / scale < 1e-9


def test_f32_taylor_length_matches_kernel_and_is_f32_exact():
    """The f32 Gramian Taylor length (taylor_n_terms) is the 7-term count
    the f32 tube path runs, and it stays f32-exact vs the 12-term f64
    reference at the scaled norm <= 0.5 the doubling scheme enforces."""
    n32 = tl.taylor_n_terms(jnp.float32)
    assert n32 == 7
    assert tl.taylor_n_terms(jnp.float64) == 12

    rng = np.random.default_rng(21)
    x = jnp.asarray(rng.normal(0, 0.6, (64, 9)))
    u = jnp.asarray(np.array([0, 0, 0, 7.3]) + rng.normal(0, 0.8, (64, 4)))
    K = jnp.asarray(C.tube.K, jnp.float64)
    Phi = jax.vmap(lambda a, b: tl.closed_loop_phi(a, b, K, C.model))(x, u)
    w = jnp.full((3,), C.tube.ext_noise_bound)
    X12, M12 = tl.gramian_channels(Phi, C.model.dt, w, n_terms=12)
    Xn, Mn = tl.gramian_channels(Phi, C.model.dt, w, n_terms=n32)
    rel = float(jnp.max(jnp.abs(Xn - X12)) / jnp.max(jnp.abs(X12)))
    assert rel < 1e-8                      # below f32 eps 1.2e-7
    assert float(jnp.max(jnp.abs(Mn - M12))) < 1e-8


def test_f32_taylor_validity_bound_at_adversarial_states():
    """The 7-term f32 series is exact only while norm1(Phi * dt) <= 8, the
    budget of its 4 doublings.  Pin that bound at the solver's box
    corners: every state and input at +-its bound (max tilt, velocity,
    thrust, yaw), which is where the closed-loop Jacobian norm peaks.
    The f32 tube path has no runtime guard, so this margin must hold."""
    from forces_resilient_planner_tpu.solver import nlp

    lb, ub = (np.asarray(v) for v in nlp.variable_bounds(C.model))
    rng = np.random.default_rng(5)
    n = 256
    pick = rng.integers(0, 2, (n, 17)).astype(bool)
    z = np.where(pick, ub, lb)
    x = jnp.asarray(z[:, 8:17])
    u = jnp.asarray(z[:, 0:4])
    K = jnp.asarray(C.tube.K, jnp.float64)
    Phi = jax.vmap(lambda a, b: tl.closed_loop_phi(a, b, K, C.model))(x, u)
    norm1 = jnp.max(jnp.sum(jnp.abs(Phi * C.model.dt), axis=-2), axis=-1)
    assert float(jnp.max(norm1)) <= 8.0 / 2.0, float(jnp.max(norm1))

    w = jnp.full((3,), C.tube.ext_noise_bound)
    X12, M12 = tl.gramian_channels(Phi, C.model.dt, w, n_terms=12)
    X7, M7 = tl.gramian_channels(
        Phi, C.model.dt, w, n_terms=tl.taylor_n_terms(jnp.float32))
    rel = float(jnp.max(jnp.abs(X7 - X12)) / jnp.max(jnp.abs(X12)))
    assert rel < 1e-7, rel
    assert float(jnp.max(jnp.abs(M7 - M12) / (1.0 + jnp.abs(M12)))) < 1e-7
