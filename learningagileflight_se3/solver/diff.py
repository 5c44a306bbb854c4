"""Differentiable MPC: analytic gradients of the solver output w.r.t. the
DNN-predicted traversal parameters theta = (tra_pos, tra_ang, t).

This resurrects the reference's commented-out PDP machinery
(quad_OC.py:214-306, diffPMP/getAuxSys) as a working implicit-function
custom-VJP instead of the 8-extra-IPOPT-solves finite-difference scheme
(quad_policy.py:94-112):

At the solver's fixed point, first-order optimality of the shooting problem
gives  g(U*, theta) = grad_U J = 0,  hence
    dU*/dtheta = -H^{-1} J_{U theta},   H = hess_U J (the shooting Hessian).
The VJP  theta_bar = -J_{theta U} (H^{-1} U_bar)  needs one linear solve with
H, which block-tridiagonalizes over time: we solve it EXACTLY with one
affine-LQR Riccati sweep over the DDP stage quadratics (stagewise Newton,
Dunn & Bertsekas) — the Hamiltonian second derivatives of the PDP paper,
computed here by jax.hessian on the analytic dynamics instead of CasADi
symbols.  Active rotor-thrust bounds are handled by zeroing the clamped
control dims (their dU/dtheta is 0 while the constraint stays active).

Exported:
    make_differentiable_control_solver: theta -> U* with the custom VJP; the
    downstream rollout/reward differentiates by ordinary AD, so
    d(reward)/d(theta) flows with zero extra NLP solves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.core.rotations import rodrigues_to_quat
from learningagileflight_se3.costs.gate_costs import total_trajectory_cost
from learningagileflight_se3.dynamics.quadrotor import rollout
from learningagileflight_se3.solver.analytic import (
    DynamicsTaylor,
    make_cost_quadratics,
    make_final_quadratics,
)
from learningagileflight_se3.solver.ilqr import (
    NU,
    NX,
    NZ,
    _aug_dynamics,
    _stage_cost,
    _final_cost,
    _Problem,
    make_mpc_solver,
)

_BOUND_EPS = 1e-7


def _shooting_cost(U, x0, u_last, goal, tra_pos, tra_ang, t, dt, params, weights):
    """J(U, theta) — the exact shooting objective, smooth in theta."""
    tra_quat = rodrigues_to_quat(tra_ang)
    X = rollout(x0, U, dt, params)
    return total_trajectory_cost(X, U, u_last, dt, t, goal, tra_pos, tra_quat, weights)


def _make_vjp_kernel(params: QuadParams, weights: CostWeights, cfg: SolverConfig):
    """The implicit-function VJP for ONE problem:
    vjp(U*, x0, u_last, goal, tra_pos, tra_ang, t, U_bar) -> cotangents
    (zeros_x0, zeros_u_last, goal_bar, tra_pos_bar, tra_ang_bar, t_bar).

    Pure scans over the horizon — vmaps cleanly, so it serves both the
    single-problem and the natively-batched differentiable solvers."""
    H, dt = cfg.horizon, cfg.dt
    dyn_taylor = DynamicsTaylor(params, dt)
    cost_quadratics = make_cost_quadratics(weights, cfg)
    final_quadratics = make_final_quadratics(weights)

    def vjp(*args):
        # 17x17 and 4x4 contractions at full f32 precision (a GPU's default
        # runs f32 products in TF32, ~3 significant digits)
        with jax.default_matmul_precision("highest"):
            return _vjp(*args)

    def _vjp(U, x0, u_last, goal, tra_pos, tra_ang, t, U_bar):
        dtype = U.dtype

        # rebuild problem data at the solution
        tra_quat = rodrigues_to_quat(tra_ang)
        ks = jnp.arange(H, dtype=dtype)
        t_weights = weights.tra_amp * jnp.exp(-weights.tra_decay * (dt * ks - t) ** 2)
        prob = _Problem(
            z0=jnp.concatenate([x0, u_last]),
            goal_pos=goal,
            tra_pos=tra_pos,
            tra_quat=tra_quat,
            t_weights=t_weights,
        )

        # rollout of augmented states
        def roll(z, u):
            zn = _aug_dynamics(z, u, dt, params)
            return zn, zn

        zH, Zrest = jax.lax.scan(roll, prob.z0, U)
        Z = jnp.concatenate([prob.z0[None], Zrest], axis=0)

        # closed-form linearizations + cost quadratics (solver/analytic.py)
        ZU = jnp.concatenate([Z[:-1], U], axis=1)
        A, B = dyn_taylor.jacobians(ZU)
        lz, _lu, lzz, luz, luu = cost_quadratics(
            Z[:-1], U, t_weights, goal, tra_pos, tra_quat
        )
        phi_z, phi_zz = final_quadratics(Z[H], goal)

        # adjoint (costate) pass: lam_k = lz_k + A_k^T lam_{k+1}
        def adj(lam, inp):
            a, lz_k = inp
            lam_prev = lz_k + a.T @ lam
            return lam_prev, lam

        _, lam_next = jax.lax.scan(adj, phi_z, (A, lz), reverse=True)
        # lam_next[k] is the costate entering the 2nd-order dynamics term at k

        # Hamiltonian second-order dynamics terms (exact Newton / Lagrangian
        # Hessian), contracted from the constant Taylor tensors
        H2 = dyn_taylor.hamiltonian_hessians(ZU, lam_next)
        lzz = lzz + H2[:, :NZ, :NZ]
        luz = luz + H2[:, NZ:, :NZ]
        luu = luu + H2[:, NZ:, NZ:]

        # clamp mask: active box constraints freeze those control dims
        free = ((U > cfg.u_lb + _BOUND_EPS) & (U < cfg.u_ub - _BOUND_EPS)).astype(dtype)

        # affine-LQR Riccati for  min 0.5 dq^T Hess dq + U_bar . dU
        tiny = jnp.asarray(1e-9, dtype)

        def ric(carry, inp):
            Vz, Vzz = carry
            a, b, lzz_k, luz_k, luu_k, ubar_k, free_k = inp
            Qz = a.T @ Vz
            Qu = ubar_k + b.T @ Vz
            Qzz = lzz_k + a.T @ Vzz @ a
            Quz = luz_k + b.T @ Vzz @ a
            Quu = luu_k + b.T @ Vzz @ b
            Fm = free_k[:, None] * free_k[None, :]
            M = Quu * Fm + jnp.diag(1.0 - free_k) + tiny * jnp.eye(NU, dtype=dtype)
            k_ff = -jnp.linalg.solve(M, Qu * free_k) * free_k
            K = -jnp.linalg.solve(M, Quz * free_k[:, None]) * free_k[:, None]
            Vz_n = Qz + K.T @ Qu + Quz.T @ k_ff + K.T @ (Quu @ k_ff)
            Vzz_n = Qzz + K.T @ Quz + Quz.T @ K + K.T @ Quu @ K
            Vzz_n = 0.5 * (Vzz_n + Vzz_n.T)
            return (Vz_n, Vzz_n), (k_ff, K)

        # derive the zero init from phi_z so the scan carry keeps consistent
        # manual (shard_map) varying axes — jnp.zeros would be axis-invariant
        (Vz0, _), (kk, KK) = jax.lax.scan(
            ric,
            (phi_z * 0.0, phi_zz),
            (A, B, lzz, luz, luu, U_bar, free),
            reverse=True,
        )

        def fstep(dz, inp):
            a, b, k_ff, K = inp
            du = k_ff + K @ dz
            dz_n = a @ dz + b @ du
            return dz_n, du

        _, dU = jax.lax.scan(fstep, phi_z * 0.0, (A, B, kk, KK))
        w = -dU  # w = H^{-1} U_bar  (restricted to free dims)

        # theta_bar = -grad_theta ( w . grad_U J(U*, theta) )
        def inner(goal_, tra_pos_, tra_ang_, t_):
            gU = jax.grad(_shooting_cost, argnums=0)(
                U, x0, u_last, goal_, tra_pos_, tra_ang_, t_, dt, params, weights
            )
            return jnp.sum(w * gU)

        g_goal, g_tp, g_ta, g_t = jax.grad(inner, argnums=(0, 1, 2, 3))(
            goal, tra_pos, tra_ang, t
        )
        return (
            jnp.zeros_like(x0),
            jnp.zeros_like(u_last),
            -g_goal,
            -g_tp,
            -g_ta,
            -g_t,
        )

    return vjp


def make_differentiable_control_solver(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
):
    """Returns solve_u(x0, u_last, goal, tra_pos, tra_ang, t) -> U* (H,4) with
    analytic VJPs w.r.t. (tra_pos, tra_ang, t) [and goal].  x0/u_last get zero
    cotangents (they are scenario data, never learned — deep_learning.py:24-32).

    NOTE: uses quantize_t=False internally — the 0.1 s rounding
    (quad_policy.py:70) has zero gradient; the analytic path keeps t smooth
    (SURVEY.md section 7 hard-part 2).
    """
    import dataclasses

    cfg = dataclasses.replace(cfg, quantize_t=False)
    solve = make_mpc_solver(params, weights, cfg, return_gains=False)
    vjp_kernel = _make_vjp_kernel(params, weights, cfg)

    def _fwd_solve(x0, u_last, goal, tra_pos, tra_ang, t):
        sol = solve(x0, u_last, goal, tra_pos, tra_ang, t)
        return sol.control_traj

    @jax.custom_vjp
    def solve_u(x0, u_last, goal, tra_pos, tra_ang, t):
        return _fwd_solve(x0, u_last, goal, tra_pos, tra_ang, t)

    def fwd(x0, u_last, goal, tra_pos, tra_ang, t):
        U = _fwd_solve(x0, u_last, goal, tra_pos, tra_ang, t)
        return U, (U, x0, u_last, goal, tra_pos, tra_ang, t)

    def bwd(res, U_bar):
        U, x0, u_last, goal, tra_pos, tra_ang, t = res
        return vjp_kernel(U, x0, u_last, goal, tra_pos, tra_ang, t, U_bar)

    solve_u.defvjp(fwd, bwd)
    return solve_u


def make_differentiable_control_solver_batched(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
):
    """Batched differentiable MPC: solve_u(x0 (B,13), ..., t (B,)) ->
    U* (B,H,4), same custom VJP as make_differentiable_control_solver but
    the forward pass is ONE make_batched_mpc_solver call (the fused kernels
    on a GPU, vmapped XLA elsewhere) and the backward rule is the vmapped
    implicit-function VJP kernel (already pure per-problem scans)."""
    import dataclasses

    cfg = dataclasses.replace(cfg, quantize_t=False)
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver

    bsolve = make_batched_mpc_solver(params, weights, cfg, return_gains=False)
    vjp_kernel = _make_vjp_kernel(params, weights, cfg)

    def _fwd_solve(x0, u_last, goal, tra_pos, tra_ang, t):
        return bsolve(x0, u_last, goal, tra_pos, tra_ang, t).control_traj

    @jax.custom_vjp
    def solve_u(x0, u_last, goal, tra_pos, tra_ang, t):
        return _fwd_solve(x0, u_last, goal, tra_pos, tra_ang, t)

    def fwd(x0, u_last, goal, tra_pos, tra_ang, t):
        U = _fwd_solve(x0, u_last, goal, tra_pos, tra_ang, t)
        return U, (U, x0, u_last, goal, tra_pos, tra_ang, t)

    def bwd(res, U_bar):
        U, x0, u_last, goal, tra_pos, tra_ang, t = res
        return jax.vmap(vjp_kernel)(U, x0, u_last, goal, tra_pos, tra_ang,
                                    t, U_bar)

    solve_u.defvjp(fwd, bwd)
    return solve_u
