"""Closed-form 4x4 Cholesky factor/solve — pure elementwise arithmetic.

XLA's general LU/Cholesky/eigh ops are serial and slow for tiny matrices on
an accelerator; the solver only ever factors 4x4 (n_ctrl) SPD systems, so we unroll the
factorization into scalar expressions that vectorize perfectly across the
batch/time axes under vmap.  Positive-definiteness falls out for free (all
pivots > 0), replacing the eigvalsh-based failure check.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-30


def chol4_factor(M):
    """M (4,4) SPD -> (L (4,4) lower, ok scalar bool)."""
    m00, m11, m22, m33 = M[0, 0], M[1, 1], M[2, 2], M[3, 3]

    d0 = m00
    l00 = jnp.sqrt(jnp.maximum(d0, _EPS))
    l10 = M[1, 0] / l00
    l20 = M[2, 0] / l00
    l30 = M[3, 0] / l00

    d1 = m11 - l10 * l10
    l11 = jnp.sqrt(jnp.maximum(d1, _EPS))
    l21 = (M[2, 1] - l20 * l10) / l11
    l31 = (M[3, 1] - l30 * l10) / l11

    d2 = m22 - l20 * l20 - l21 * l21
    l22 = jnp.sqrt(jnp.maximum(d2, _EPS))
    l32 = (M[3, 2] - l30 * l20 - l31 * l21) / l22

    d3 = m33 - l30 * l30 - l31 * l31 - l32 * l32
    l33 = jnp.sqrt(jnp.maximum(d3, _EPS))

    z = jnp.zeros((), M.dtype)
    L = jnp.array(
        [
            [l00, z, z, z],
            [l10, l11, z, z],
            [l20, l21, l22, z],
            [l30, l31, l32, l33],
        ]
    )
    tol = 1e-12 if M.dtype == jnp.float64 else 1e-7
    scale = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(M))), 1.0)
    ok = (d0 > tol * scale) & (d1 > tol * scale) & (d2 > tol * scale) & (d3 > tol * scale)
    return L, ok


def chol4_solve_factored(L, B):
    """Solve (L L^T) X = B for B (4,) or (4, n) via unrolled substitution."""
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    # forward: L Y = B
    y0 = B[0] / L[0, 0]
    y1 = (B[1] - L[1, 0] * y0) / L[1, 1]
    y2 = (B[2] - L[2, 0] * y0 - L[2, 1] * y1) / L[2, 2]
    y3 = (B[3] - L[3, 0] * y0 - L[3, 1] * y1 - L[3, 2] * y2) / L[3, 3]
    # backward: L^T X = Y
    x3 = y3 / L[3, 3]
    x2 = (y2 - L[3, 2] * x3) / L[2, 2]
    x1 = (y1 - L[2, 1] * x2 - L[3, 1] * x3) / L[1, 1]
    x0 = (y0 - L[1, 0] * x1 - L[2, 0] * x2 - L[3, 0] * x3) / L[0, 0]
    X = jnp.stack([x0, x1, x2, x3])
    return X[:, 0] if vec else X


def chol4_solve(M, B):
    """One-shot solve; returns (X, ok)."""
    L, ok = chol4_factor(M)
    return chol4_solve_factored(L, B), ok
