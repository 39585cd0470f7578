"""Batched small-matrix linear algebra in plain XLA ops.

The tiny per-env systems a robot sim produces (nv = 6..60, batched over
thousands of envs) are factored with *static* unrolled column-Cholesky /
substitution code for small n and a blocked recursive scheme (leaf =
unrolled, off-diagonal updates = batched matmuls) for larger n, so they
fuse into the step program on every backend.

Replaces the factorization path the reference delegates to libmujoco's
sparse LDL (mj_factorM / mj_solveM inside mj_step2, SURVEY.md §2.2); dense
is the right call where the batch axis supplies the parallelism.

All functions operate on the trailing dims and broadcast over any leading
batch dims; they are also safe under vmap (pure indexing on trailing axes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_LEAF = 16  # max n for fully-unrolled kernels


def _chol_unrolled(A: jax.Array) -> jax.Array:
    """Column Cholesky, fully unrolled (n <= _LEAF)."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        c = A[..., :, j]
        for k in range(j):
            c = c - cols[k] * cols[k][..., j][..., None]
        pivot = jnp.sqrt(jnp.maximum(c[..., j], 1e-30))
        c = c / pivot[..., None]
        c = jnp.where(jnp.asarray(np.arange(n) >= j), c, jnp.zeros_like(c))
        cols.append(c)
    return jnp.stack(cols, axis=-1)


def _solve_lower_unrolled(L: jax.Array, B: jax.Array) -> jax.Array:
    """L X = B with L lower-triangular (..., n, n), B (..., n, m)."""
    n = L.shape[-1]
    xs = []
    for i in range(n):
        v = B[..., i, :]
        for k in range(i):
            v = v - L[..., i, k][..., None] * xs[k]
        xs.append(v / L[..., i, i][..., None])
    return jnp.stack(xs, axis=-2)


def _solve_upper_unrolled(U: jax.Array, B: jax.Array) -> jax.Array:
    """U X = B with U upper-triangular."""
    n = U.shape[-1]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        v = B[..., i, :]
        for k in range(i + 1, n):
            v = v - U[..., i, k][..., None] * xs[k]
        xs[i] = v / U[..., i, i][..., None]
    return jnp.stack(xs, axis=-2)


def _split(n: int) -> int:
    """Split point: smallest multiple of _LEAF >= n/2 (keeps leaves full)."""
    h = (n + 1) // 2
    return min(((h + _LEAF - 1) // _LEAF) * _LEAF, n - 1) if n > _LEAF else n


def solve_lower(L: jax.Array, B: jax.Array) -> jax.Array:
    """Solve L X = B, L lower-triangular (..., n, n), B (..., n, m)."""
    n = L.shape[-1]
    if n <= _LEAF:
        return _solve_lower_unrolled(L, B)
    s = _split(n)
    L11 = L[..., :s, :s]
    L21 = L[..., s:, :s]
    L22 = L[..., s:, s:]
    X1 = solve_lower(L11, B[..., :s, :])
    rhs2 = B[..., s:, :] - L21 @ X1
    X2 = solve_lower(L22, rhs2)
    return jnp.concatenate([X1, X2], axis=-2)


def solve_upper(U: jax.Array, B: jax.Array) -> jax.Array:
    """Solve U X = B, U upper-triangular."""
    n = U.shape[-1]
    if n <= _LEAF:
        return _solve_upper_unrolled(U, B)
    s = _split(n)
    U11 = U[..., :s, :s]
    U12 = U[..., :s, s:]
    U22 = U[..., s:, s:]
    X2 = solve_upper(U22, B[..., s:, :])
    rhs1 = B[..., :s, :] - U12 @ X2
    X1 = solve_upper(U11, rhs1)
    return jnp.concatenate([X1, X2], axis=-2)


def cholesky(A: jax.Array) -> jax.Array:
    """Lower Cholesky factor of SPD A (..., n, n); blocked recursive."""
    n = A.shape[-1]
    if n <= _LEAF:
        return _chol_unrolled(A)
    s = _split(n)
    A11 = A[..., :s, :s]
    A21 = A[..., s:, :s]
    A22 = A[..., s:, s:]
    L11 = cholesky(A11)
    # L21 L11^T = A21  =>  L11 (L21^T) = A21^T
    L21T = solve_lower(L11, jnp.swapaxes(A21, -1, -2))
    L21 = jnp.swapaxes(L21T, -1, -2)
    S = A22 - L21 @ L21T
    L22 = cholesky(S)
    top = jnp.concatenate(
        [L11, jnp.zeros(L21T.shape[:-2] + (s, n - s), A.dtype)], axis=-1)
    bot = jnp.concatenate([L21, L22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def cho_solve(L: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve (L L^T) x = rhs for vector rhs (..., n)."""
    y = solve_lower(L, rhs[..., None])
    x = solve_upper(jnp.swapaxes(L, -1, -2), y)
    return x[..., 0]


def cho_solve_mat(L: jax.Array, B: jax.Array) -> jax.Array:
    """Solve (L L^T) X = B for matrix B (..., n, m)."""
    y = solve_lower(L, B)
    return solve_upper(jnp.swapaxes(L, -1, -2), y)
