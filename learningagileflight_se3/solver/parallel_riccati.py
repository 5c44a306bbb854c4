"""Parallel-in-time (associative-scan) Riccati backward pass.

The sequential backward sweep (solver/ilqr.py `backward`) is a reverse
`lax.scan` — O(H) sequential depth.  This module re-expresses the LQR value
recursion as an ASSOCIATIVE composition of value-function maps and evaluates
all H suffix compositions with `jax.lax.associative_scan` in O(log H) depth
(Särkkä & García-Fernández, "Temporal Parallelization of Dynamic Programming
and Linear Quadratic Control").

Each per-step element e_k = (A, b, C, eta, J) represents the map

    V_{k+1}(y) = 1/2 y'S y - v'y   ->   V_k(x) = 1/2 x'S'x - v''x
    S' = J + A' (I + S C)^{-1} S A
    v' = eta + A' (I + S C)^{-1} (v - S b)

built from the step's LQR data (dynamics x' = F x + L u, stage cost
1/2 x'X x + r'x + 1/2 u'R u + s'u + u'M x):

    A = F - L R^{-1} M        b = -L R^{-1} s       C = L R^{-1} L'
    J = X - M' R^{-1} M       eta = -(r - M' R^{-1} s)

Two such maps compose (e_earlier ∘ e_later) in closed form:

    D1 = (I + C_i J_j)^{-1}           D2 = (I + J_j C_i)^{-1}
    A = A_j D1 A_i                    b = A_j D1 (b_i + C_i eta_j) + b_j
    C = A_j D1 C_i A_j' + C_j
    eta = A_i' D2 (eta_j - J_j b_i) + eta_i
    J = A_i' D2 J_j A_i + J_i

and the composition is associative, so a suffix scan over
[e_0, ..., e_{H-1}, e_terminal] yields every V_k simultaneously; gains and
the thrust-box projection (boxQP) are then a fully-parallel vmap over steps.

When it wins: the sequential sweep is already batch-parallel over scenarios,
so at large batch the device is busy and O(H) depth is hidden.  At SMALL
batch — the deployment-critical 10 Hz single-query replanning path
(main.py:76) — the sequential sweep leaves the chip idle between tiny
dependent 17x17 ops; the associative form turns the horizon into batched
matmul work (H x (17,17) per combine round, log2(H) rounds).

Exactness: reproduces the sequential sweep's gains to machine precision for
reg=0, inactive thrust bounds, and use_ddp=False (tests/test_parallel_
riccati.py).  With regularization or active bounds the propagated value
functions differ from the sequential (clamped, reg-hybrid) recursion — the
direction remains a descent direction and the solver's Armijo line search
safeguards it, exactly as it safeguards the sequential sweep.

Reference role: the reference has no horizon-axis parallelism at all — its
IPOPT NLP (quad_OC.py:125-174) factors one 863-variable KKT system per
solve on a single CPU core.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.solver.boxqp import boxqp
from learningagileflight_se3.solver.chol4 import (
    chol4_factor,
    chol4_solve_factored,
)

NX = 13
NU = 4
NZ = NX + NU


def _combine(ei, ej):
    """Compose value maps: ei covers the EARLIER time interval, ej the later.

    Batched over a leading axis by associative_scan."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    I = jnp.eye(NZ, dtype=Ai.dtype)
    # (I + C_i J_j)^{-1} X  via LU solve; shares the factorization per pair
    CiJj = I + jnp.einsum("...ab,...bc->...ac", Ci, Jj)
    JjCi = I + jnp.einsum("...ab,...bc->...ac", Jj, Ci)
    D1Ai = jnp.linalg.solve(CiJj, Ai)
    D1Ci = jnp.linalg.solve(CiJj, Ci)
    rhs_b = bi + jnp.einsum("...ab,...b->...a", Ci, etaj)
    D1b = jnp.linalg.solve(CiJj, rhs_b[..., None])[..., 0]
    rhs_eta = etaj - jnp.einsum("...ab,...b->...a", Jj, bi)
    D2eta = jnp.linalg.solve(JjCi, rhs_eta[..., None])[..., 0]
    D2Jj = jnp.linalg.solve(JjCi, Jj)

    Ac = jnp.einsum("...ab,...bc->...ac", Aj, D1Ai)
    bc = jnp.einsum("...ab,...b->...a", Aj, D1b) + bj
    Cc = jnp.einsum("...ab,...bc,...dc->...ad", Aj, D1Ci, Aj) + Cj
    etac = jnp.einsum("...ba,...b->...a", Ai, D2eta) + etai
    Jc = jnp.einsum("...ba,...bc,...cd->...ad", Ai, D2Jj, Ai) + Ji
    Cc = 0.5 * (Cc + jnp.swapaxes(Cc, -1, -2))
    Jc = 0.5 * (Jc + jnp.swapaxes(Jc, -1, -2))
    return (Ac, bc, Cc, etac, Jc)


def make_parallel_backward(cfg, lb, ub):
    """Build parallel_backward(derivs, U, reg) with the same signature/outputs
    as the sequential sweep in make_mpc_solver: (kk, KK, dV1, dV2, fail).

    derivs is the tuple produced by ilqr.derivatives().  cfg.use_ddp's
    second-order dynamics terms are NOT included (Gauss-Newton/iLQR mode —
    they depend on the running Vz, which breaks associativity)."""

    def parallel_backward(derivs, U, reg):
        A, B, lz, lu, lzz, luz, luu, phi_z, phi_zz, ZU, pg_true = derivs
        H = U.shape[0]
        dtype = A.dtype

        def build_elements(free, u_fix):
            """Per-step elements with the control dims in `free` (4,) as
            decisions and the clamped dims held at the deviation u_fix —
            dynamics pick up the affine term c = B (u_fix ⊙ (1-free)), the
            cost folds the fixed controls into its x-linear/constant parts,
            and the masked 4x4 R solve mirrors the sequential sweep's masked
            Cholesky trick.  free=1, u_fix=0 is the plain unclamped element."""
            u_c = u_fix * (1.0 - free)                          # (H, 4)
            c_dyn = jnp.einsum("hab,hb->ha", B, u_c)            # (H, NZ)
            Bm = B * free[:, None, :]                           # masked columns
            Fm = free[:, :, None] * free[:, None, :]
            Rm = luu * Fm + jax.vmap(jnp.diag)(1.0 - free)
            s_eff = (lu + jnp.einsum("hab,hb->ha", luu, u_c)) * free
            M_eff = luz * free[:, :, None]
            r_eff = lz + jnp.einsum("hba,hb->ha", luz, u_c)

            Lfac, ok_r = jax.vmap(chol4_factor)(Rm)
            RiM = jax.vmap(chol4_solve_factored)(Lfac, M_eff)
            Ris = jax.vmap(chol4_solve_factored)(Lfac, s_eff)
            RiBt = jax.vmap(chol4_solve_factored)(
                Lfac, jnp.swapaxes(Bm, -1, -2)
            )
            Ae = A - jnp.einsum("hab,hbc->hac", Bm, RiM)
            be = c_dyn - jnp.einsum("hab,hb->ha", Bm, Ris)
            Ce = jnp.einsum("hab,hbc->hac", Bm, RiBt)
            Je = lzz - jnp.einsum("hba,hbc->hac", M_eff, RiM)
            etae = -(r_eff - jnp.einsum("hba,hb->ha", M_eff, Ris))
            Ce = 0.5 * (Ce + jnp.swapaxes(Ce, -1, -2))
            Je = 0.5 * (Je + jnp.swapaxes(Je, -1, -2))
            return (Ae, be, Ce, etae, Je), ok_r

        def scan_values(stage_elems):
            """Suffix compositions out[k] = e_k ∘ ... ∘ e_terminal -> per-step
            (S_{k+1}, Vz_{k+1}).  associative_scan(reverse=True) hands the
            combine its LATER-in-time operand first, so swap into _combine's
            (earlier, later) convention."""
            Ae, be, Ce, etae, Je = stage_elems
            zeroM = jnp.zeros((1, NZ, NZ), dtype)
            elems = (
                jnp.concatenate([Ae, zeroM]),
                jnp.concatenate([be, jnp.zeros((1, NZ), dtype)]),
                jnp.concatenate([Ce, zeroM]),
                jnp.concatenate([etae, -phi_z[None]]),
                jnp.concatenate([Je, phi_zz[None]]),
            )
            out = jax.lax.associative_scan(
                lambda a, b: _combine(b, a), elems, reverse=True
            )
            S1 = out[4][1:]     # V_{k+1} quadratic,  k = 0..H-1
            Vz1 = -out[3][1:]   # V_{k+1} gradient at the nominal
            return S1, Vz1

        # ---- gains: identical per-step formulas to the sequential sweep,
        # now a parallel vmap (boxQP included)
        def gains(a, b_, lz_k, lu_k, luz_k, luu_k, u_k, S1k, Vz1k, regk):
            Qu = lu_k + b_.T @ Vz1k
            Quz = luz_k + b_.T @ S1k @ a
            Quu = luu_k + b_.T @ S1k @ b_
            Quu_r = Quu + regk * (b_.T @ b_)
            Quz_r = Quz + regk * (b_.T @ a)
            Quu_r = 0.5 * (Quu_r + Quu_r.T)
            lo = lb - u_k
            hi = ub - u_k
            k_ff, free = boxqp(Quu_r, Qu, lo, hi, iters=cfg.boxqp_iters)
            Fm = free[:, None] * free[None, :]
            M = Quu_r * Fm + jnp.diag(1.0 - free)
            Lk, okk = chol4_factor(M)
            K = -chol4_solve_factored(Lk, Quz_r * free[:, None]) * free[:, None]
            dV1_k = k_ff @ Qu
            dV2_k = 0.5 * k_ff @ (Quu @ k_ff)
            return k_ff, K, dV1_k, dV2_k, free, okk

        regs = jnp.broadcast_to(reg, (H,))

        # pass 1: unclamped value propagation -> provisional active set
        free0 = jnp.ones((H, NU), dtype)
        elems0, ok0 = build_elements(free0, jnp.zeros((H, NU), dtype))
        S1, Vz1 = scan_values(elems0)
        kk, KK, dV1s, dV2s, free1, ok1 = jax.vmap(gains)(
            A, B, lz, lu, luz, luu, U, S1, Vz1, regs
        )

        # pass 2 (active-set refinement): re-propagate the value functions
        # with pass-1's clamped dims held at their bound deviations — the
        # control-limited feedback the sequential sweep bakes in step by
        # step — then recompute gains against the refined values.
        elems1, ok2 = build_elements(free1, kk)
        S1r, Vz1r = scan_values(elems1)
        kk, KK, dV1s, dV2s, _, ok3 = jax.vmap(gains)(
            A, B, lz, lu, luz, luu, U, S1r, Vz1r, regs
        )

        finite = (
            jnp.all(jnp.isfinite(kk))
            & jnp.all(jnp.isfinite(KK))
            & jnp.all(jnp.isfinite(S1r))
        )
        fail = (
            (~jnp.all(ok0)) | (~jnp.all(ok1)) | (~jnp.all(ok2))
            | (~jnp.all(ok3)) | (~finite)
        )
        return kk, KK, jnp.sum(dV1s), jnp.sum(dV2s), fail, pg_true

    return parallel_backward
