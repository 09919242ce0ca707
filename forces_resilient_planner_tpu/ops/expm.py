"""Fixed-structure batched matrix exponential.

jax.scipy.linalg.expm dispatches between five Pade orders with lax.switch;
under vmap the batched predicate makes XLA evaluate EVERY branch and
select, and the per-matrix 1-norm scaling adds more data-dependent control
flow.  The tube propagator (tube/lyapunov.py) evaluates tens of thousands
of 9x9/18x18 exponentials per batched pipeline step, so this module
provides a straight-line variant: ONE Pade-13 evaluation with a masked
fixed-count squaring chain — straight-line code, fully batched, identical
math to the scipy/jax algorithm whenever the scaling bound holds.

Accuracy: Pade-13 with 1-norm scaled below theta_13 = 5.37 has truncation
error ~1e-16 (Higham 2005), far below f32 resolution; max_squarings=8
covers 1-norms up to 5.37 * 2^8 ~ 1375, beyond anything the closed-loop
Phi*dt matrices (||Phi dt||_1 ~ 1-3) can reach.  Inputs with larger norms
saturate the scaling and lose accuracy gracefully (same as scipy would
with its squaring count capped).

Reference anchor: replaces Eigen's expm calls inside getDistrEllipsoid
(nmpc_solver.cpp:567-611); parity vs jax.scipy.linalg.expm is tested in
tests/test_ops.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

# Pade-13 numerator coefficients (Higham 2005, same table as
# scipy.linalg.expm / jax.scipy.linalg.expm)
_B = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0,
    670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
    960960.0, 16380.0, 182.0, 1.0,
)
_THETA13 = 5.371920351148152


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def expm_fixed(A: jnp.ndarray, max_squarings: int = 8) -> jnp.ndarray:
    """Batched e^A via scaling + Pade-13 + masked squaring.

    A: (..., n, n).  Returns (..., n, n).  Fully shape-static: the squaring
    chain always runs max_squarings matmuls, masked per matrix.
    """
    dtype = A.dtype
    n = A.shape[-1]
    norm1 = jnp.max(jnp.sum(jnp.abs(A), axis=-2), axis=-1)  # (...,)
    # number of halvings to bring the norm below theta13
    s = jnp.ceil(jnp.log2(jnp.maximum(norm1 / _THETA13, 1.0)))
    s = jnp.clip(jnp.nan_to_num(s, nan=0.0), 0, max_squarings)
    A = A * (0.5**s)[..., None, None].astype(dtype)

    I = jnp.broadcast_to(jnp.eye(n, dtype=dtype), A.shape)
    A2 = _mm(A, A)
    A4 = _mm(A2, A2)
    A6 = _mm(A2, A4)
    b = _B
    U = _mm(
        A,
        _mm(A6, b[13] * A6 + b[11] * A4 + b[9] * A2)
        + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I,
    )
    V = (
        _mm(A6, b[12] * A6 + b[10] * A4 + b[8] * A2)
        + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I
    )
    F = jnp.linalg.solve(V - U, V + U)
    for k in range(max_squarings):
        F = jnp.where((s > k)[..., None, None], _mm(F, F), F)
    return F
