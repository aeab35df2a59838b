"""Linear solvers for the normal equations.

Reference parity: src/linearsolver.jl — dense/static systems use Cholesky
with a fallback factorization when the matrix is not positive definite
(``try_cholesky!``, lines 7-26); the sparse LDLᵀ path is replaced by the
Schur-complement solver in :mod:`nllstpu.ops.schur` (batched small-block
inverses and one large GEMM in place of a sparse direct factorization; see
SURVEY.md §2 "native" table).

All solvers are jit/vmap-compatible: the not-positive-definite check is a
runtime ``lax.cond`` on NaNs in the Cholesky factor rather than an exception.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_solve(a, b):
    """Solve a x = b via Cholesky, falling back to an LU solve when ``a`` is
    not positive definite (the reference falls back to QR; for square
    nonsingular systems LU yields the same solution and maps better to XLA).
    """

    chol = jnp.linalg.cholesky(a)
    # Run the triangular solves unconditionally and gate only the LU
    # fallback behind the cond: a non-SPD matrix merely wastes the two
    # triangular solves.
    y = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(chol, y, lower=True, trans=1)
    # A failed (or NaN-poisoned) factorization always surfaces NaN on the
    # diagonal: the failing pivot is a sqrt of a negative/NaN value and every
    # later diagonal entry accumulates that row's NaNs.
    ok = jnp.all(jnp.isfinite(jnp.diagonal(chol)))

    def _lu(_):
        return jnp.linalg.solve(a, b)

    return jax.lax.cond(ok, lambda _: x, _lu, None)


def solve_symmetric(a, b):
    """Entry point used by the iterators: x = a \\ b."""
    return cholesky_solve(a, b)


def batched_cholesky_solve(a, b):
    """vmapped Cholesky-with-fallback over leading batch dims; used by the
    per-variable alternation solver (``optimize_singles``) and the Schur
    landmark elimination."""
    return jax.vmap(cholesky_solve)(a, b)


def invert_psd(a):
    """Inverse of a symmetric positive-definite matrix (reference ``invsym``,
    src/linearsolver.jl:35-36, used for covariance extraction)."""
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    return cholesky_solve(a, eye)


def batched_inv_spd(h):
    """Batched inverse of small symmetric blocks ``[n, d, d]``.

    For d ≤ 3 uses the closed-form adjugate — one fused elementwise XLA
    computation over the whole batch, where a vmapped Cholesky's runtime
    fallback ``lax.cond`` becomes a select that executes BOTH branches per
    block.  Larger blocks fall back to the vmapped Cholesky-with-fallback
    path."""
    d = h.shape[-1]
    if d == 1:
        return 1.0 / h
    if d == 2:
        a, b = h[:, 0, 0], h[:, 0, 1]
        c, e = h[:, 1, 0], h[:, 1, 1]
        det = a * e - b * c
        inv_det = 1.0 / det
        out = jnp.stack(
            [
                jnp.stack([e, -b], axis=-1),
                jnp.stack([-c, a], axis=-1),
            ],
            axis=-2,
        )
        return out * inv_det[:, None, None]
    if d == 3:
        a = h[:, 0, 0]
        b = h[:, 0, 1]
        c = h[:, 0, 2]
        e = h[:, 1, 1]
        f = h[:, 1, 2]
        g = h[:, 2, 2]
        # Cofactors of the symmetric matrix [[a,b,c],[b,e,f],[c,f,g]].
        c00 = e * g - f * f
        c01 = c * f - b * g
        c02 = b * f - c * e
        c11 = a * g - c * c
        c12 = b * c - a * f
        c22 = a * e - b * b
        det = a * c00 + b * c01 + c * c02
        inv_det = 1.0 / det
        row0 = jnp.stack([c00, c01, c02], axis=-1)
        row1 = jnp.stack([c01, c11, c12], axis=-1)
        row2 = jnp.stack([c02, c12, c22], axis=-1)
        return jnp.stack([row0, row1, row2], axis=-2) * inv_det[:, None, None]
    eye = jnp.eye(d, dtype=h.dtype)
    return jax.vmap(lambda m: cholesky_solve(m, eye))(h)


def batched_inv_spd_cm(h):
    """Components-major batched inverse of small symmetric blocks: ``h`` is
    ``[d, d, n]`` and so is the result.

    ``[d, d, n]`` keeps the long axis minor, so the closed-form cofactor
    arithmetic is elementwise over contiguous ``[n]`` slices."""
    d = h.shape[0]
    if d == 1:
        return 1.0 / h
    if d == 2:
        a, b = h[0, 0], h[0, 1]
        c, e = h[1, 0], h[1, 1]
        inv_det = 1.0 / (a * e - b * c)
        out = jnp.stack(
            [jnp.stack([e, -b]), jnp.stack([-c, a])]
        )
        return out * inv_det
    if d == 3:
        a, b, c = h[0, 0], h[0, 1], h[0, 2]
        e, f, g = h[1, 1], h[1, 2], h[2, 2]
        c00 = e * g - f * f
        c01 = c * f - b * g
        c02 = b * f - c * e
        c11 = a * g - c * c
        c12 = b * c - a * f
        c22 = a * e - b * b
        inv_det = 1.0 / (a * c00 + b * c01 + c * c02)
        out = jnp.stack(
            [
                jnp.stack([c00, c01, c02]),
                jnp.stack([c01, c11, c12]),
                jnp.stack([c02, c12, c22]),
            ]
        )
        return out * inv_det
    # Large blocks: go through the batch-major path (not a hot layout).
    inv = batched_inv_spd(jnp.moveaxis(h, -1, 0))
    return jnp.moveaxis(inv, 0, -1)
