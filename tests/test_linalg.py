"""ops/linalg.py — the batched SPD factor and solves every step uses
(qacc_smooth, each Newton direction, the Euler update, noslip) — vs
numpy, across the unrolled leaf and the blocked split points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mujoco_sim_tpu.ops import linalg


def _spd(rng, batch, n):
    A = rng.standard_normal(batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("n", [1, 6, 16, 17, 33, 42, 49])
def test_cholesky_and_solves_match_numpy(n):
    rng = np.random.default_rng(n)
    A = _spd(rng, (3,), n)
    b = rng.standard_normal((3, n))
    B = rng.standard_normal((3, n, 4))
    L = np.asarray(linalg.cholesky(jnp.asarray(A)))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10,
                               atol=1e-10)
    x = np.asarray(linalg.cho_solve(jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-9, atol=1e-9)
    X = np.asarray(linalg.cho_solve_mat(jnp.asarray(L), jnp.asarray(B)))
    np.testing.assert_allclose(X, np.linalg.solve(A, B), rtol=1e-9,
                               atol=1e-9)


def test_stiff_rows_stay_finite_in_f32():
    """Newton Hessians carry efc_D ~ 1e9 rows; the f32 factor must stay
    finite and solve the dominant subspace."""
    rng = np.random.default_rng(1)
    A = _spd(rng, (4,), 12).astype(np.float32)
    A[:, 0, 0] += 1e9
    b = rng.standard_normal((4, 12)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        x = np.asarray(linalg.cho_solve(linalg.cholesky(jnp.asarray(A)),
                                        jnp.asarray(b)))
    assert np.isfinite(x).all()
    r = np.einsum("bij,bj->bi", A.astype(np.float64), x) - b
    assert np.abs(r).max() < 1e-2, np.abs(r).max()


def test_under_nested_vmap():
    """The engine calls the solves per env under vmap(env) (and vmap(slot)
    in noslip); trailing-axis code must batch like the leading-dim form."""
    rng = np.random.default_rng(2)
    A = _spd(rng, (2, 3), 7)
    b = rng.standard_normal((2, 3, 7))
    f = jax.vmap(jax.vmap(lambda a, v: linalg.cho_solve(linalg.cholesky(a),
                                                        v)))
    x = np.asarray(f(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-9, atol=1e-9)
