"""Small box-constrained QP solver (projected Newton, fixed iteration count).

Solves   min_d  0.5 d^T H d + g^T d   s.t.  lo <= d <= hi
for the tiny (n_ctrl = 4) per-timestep QPs of the control-limited iLQR
backward pass (the accelerator replacement for IPOPT's handling of the rotor
thrust bounds [0, 2.44] N, reference quad_policy.py:46-51).

Everything is branch-free and fixed-shape: the active set is a mask, the
"free-subspace" Newton solve is a full-size solve on a masked matrix via the
unrolled 4x4 Cholesky (solver/chol4.py — elementwise arithmetic, no XLA LU),
and the iteration count is static so the whole thing jits/vmaps cleanly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.solver.chol4 import chol4_factor, chol4_solve_factored


def _masked_matrix(H, free):
    """F H F + (I - F): exact on the free block, identity on the clamped."""
    F = free[:, None] * free[None, :]
    return H * F + jnp.diag(1.0 - free)


def boxqp(H, g, lo, hi, iters: int = 6):
    """Returns (d, free_mask) for the box QP (see module docstring).

    free_mask marks coordinates not clamped at a bound with inward gradient;
    callers zero the corresponding feedback rows (Tassa et al. 2014 style)."""
    d0 = jnp.clip(jnp.zeros_like(g), lo, hi)

    def qobj(x):
        return 0.5 * x @ (H @ x) + g @ x

    def body(_, d):
        grad = g + H @ d
        at_lo = (d <= lo + 1e-12) & (grad > 0)
        at_hi = (d >= hi - 1e-12) & (grad < 0)
        free = 1.0 - (at_lo | at_hi).astype(d.dtype)
        L, _ = chol4_factor(_masked_matrix(H, free))
        step = chol4_solve_factored(L, -(grad * free)) * free

        # NaN-robust sequential selection (an overflowed candidate must lose,
        # not poison the argmin)
        best = d
        best_val = qobj(d)
        for s in (1.0, 0.5, 0.25):
            cand = jnp.clip(d + s * step, lo, hi)
            val = qobj(cand)
            take = val < best_val
            best = jnp.where(take, cand, best)
            best_val = jnp.where(take, val, best_val)
        return best

    d = jax.lax.fori_loop(0, iters, body, d0, unroll=True)

    grad = g + H @ d
    at_lo = (d <= lo + 1e-12) & (grad > 0)
    at_hi = (d >= hi - 1e-12) & (grad < 0)
    free = 1.0 - (at_lo | at_hi).astype(d.dtype)
    return d, free
