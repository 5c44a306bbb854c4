"""Batched control-limited iLQR for the gate-traversal MPC.

Accelerator replacement for the reference's CasADi/IPOPT pipeline
(quad_OC.py:104-212): where the reference builds a fresh 863-variable lifted
NLP per call and hands it to a C++ interior-point solver, we solve the
equivalent *shooting* problem

    min_U  sum_k C_k(x_k, u_k, u_{k-1}) + phi(x_H)
    s.t.   x_{k+1} = x_k + dt f(x_k, u_k),   0 <= u <= u_ub

with iLQR: the 650 dynamics equality constraints are eliminated exactly by the
rollout, the control-rate coupling |u_k - u_{k-1}|^2 (quad_OC.py:150) is
handled by augmenting the state with the previous control
(z = [x(13); u_prev(4)] in R^17), and the rotor-thrust box constraint is
handled by a projected-Newton boxQP in the backward pass.

Design notes:
  * Fixed shapes everywhere: horizon, iteration counts, and line-search grids
    are static, so the whole solve is one XLA computation; `lax.scan` for the
    time sweeps, `lax.while_loop` with a per-problem `done` mask for the outer
    iterations (vmap-safe early exit).
  * The solve vmaps over a scenario axis (`make_batched_mpc_solver`) —
    thousands of independent MPC problems become batched (17x17)/(4x17)
    matrix ops.  The reference parallelizes the same loop with 10 forked
    CPU processes (deep_learning.py:66-72).
  * All derivatives (A_k, B_k, stage-cost quadratics, the DDP second-order
    terms) are closed forms from solver/analytic.py, validated against
    jax.jacfwd / jax.hessian in tests/test_analytic.py — replacing CasADi's
    symbolic AD (quad_OC.py:191-194).

Reference-matching details:
  * identical forward-Euler discretization without quaternion renormalization;
  * identical initialization U0 = midpoint of control bounds (quad_OC.py:142);
  * traversal time enters only through the Gaussian stage weight
    60*exp(-10*(dt*k - t)^2) and is optionally rounded to 0.1 s
    (quad_policy.py:70) under SolverConfig.quantize_t;
  * the omega bound (+-pi/2, quad_policy.py:50) is available as a soft
    quadratic penalty (w_bound_weight) — see SURVEY.md section 7 hard-parts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.core.rotations import rodrigues_to_quat
from learningagileflight_se3.costs.gate_costs import (
    final_cost,
    goal_cost,
    thrust_cost,
    traversal_cost,
)
from learningagileflight_se3.dynamics.quadrotor import euler_step
from learningagileflight_se3.solver.analytic import (
    explicit_h2,
    explicit_jacobians,
    make_cost_quadratics,
    make_final_quadratics,
)
from learningagileflight_se3.solver.boxqp import boxqp
from learningagileflight_se3.solver.chol4 import chol4_factor, chol4_solve_factored

NX = 13  # physical state
NU = 4   # rotor thrusts
NZ = NX + NU  # augmented state [x; u_prev]
NZU = NZ + NU  # concatenated (z, u)


class MPCSolution(NamedTuple):
    """Mirror of the reference's opt_sol dict (quad_OC.py:204-210)."""

    state_traj: jnp.ndarray    # (H+1, 13)
    control_traj: jnp.ndarray  # (H, 4)
    cost: jnp.ndarray          # scalar
    iterations: jnp.ndarray    # scalar int
    converged: jnp.ndarray     # scalar bool
    gains_K: jnp.ndarray       # (H, 4, 17) feedback gains (bonus over reference)
    grad_norm: jnp.ndarray     # max projected |Q_u| (KKT residual proxy)
    reg_final: jnp.ndarray     # final LM regularization
    # exit reason per lane — `converged` is True for ANY terminal exit, and
    # the quality ladder (bench.py rescue pass) needs to distinguish a true
    # KKT certificate from the budget floors:
    #   0 = hit the iteration cap (still descending)
    #   1 = stationary (true KKT: decrement + projected gradient)
    #   2 = stalled (failed search at high reg, near-optimal gradient)
    #   3 = progress-window floor (no cost motion for a full window)
    #   4 = regularization blowout
    status: jnp.ndarray = 0


class _Problem(NamedTuple):
    """Per-scenario problem data (everything the cost depends on)."""

    z0: jnp.ndarray        # (17,) initial augmented state [x0; u_last]
    goal_pos: jnp.ndarray  # (3,)
    tra_pos: jnp.ndarray   # (3,)
    tra_quat: jnp.ndarray  # (4,)
    t_weights: jnp.ndarray # (H,) Gaussian stage weights


def _aug_dynamics(z, u, dt, params: QuadParams):
    x = z[:NX]
    return jnp.concatenate([euler_step(x, u, dt, params), u])


def _stage_cost(z, u, wk, prob: _Problem, weights: CostWeights, cfg: SolverConfig):
    x = z[:NX]
    u_prev = z[NX:]
    c = (
        wk * traversal_cost(x, prob.tra_pos, prob.tra_quat, weights)
        + goal_cost(x, prob.goal_pos, weights)
        + thrust_cost(u, weights)
        + weights.w_du * jnp.sum((u - u_prev) ** 2)
    )
    if cfg.w_bound_weight > 0.0:
        om = x[10:13]
        viol = jnp.maximum(jnp.abs(om) - cfg.w_bound, 0.0)
        c = c + cfg.w_bound_weight * jnp.sum(viol**2)
    return c


def _final_cost(z, prob: _Problem, weights: CostWeights):
    return final_cost(z[:NX], prob.goal_pos, weights)


def make_mpc_solver(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
    return_gains: bool = True,
):
    """Build a jittable single-problem solver.

    Returned callable:
        solve(x0, u_last, goal_pos, tra_pos, tra_ang, t, U_init=None) -> MPCSolution

    tra_ang is the Rodrigues 3-vector (Rd2Rp semantics, quad_policy.py:10-13);
    t the traversal time in seconds.
    """
    H = cfg.horizon
    dt = cfg.dt
    lb = cfg.u_lb
    ub = cfg.u_ub
    alphas = 0.5 ** jnp.arange(cfg.line_search_steps)

    def rollout_cost(z0, U, prob):
        """Nonlinear rollout + total cost (the exact IPOPT objective)."""

        def body(carry, inp):
            z, c = carry
            u, wk = inp
            c = c + _stage_cost(z, u, wk, prob, weights, cfg)
            zn = _aug_dynamics(z, u, dt, params)
            return (zn, c), zn

        (zH, c), Z = jax.lax.scan(
            body, (z0, z0[0] * 0.0), (U, prob.t_weights)
        )
        c = c + _final_cost(zH, prob, weights)
        Z = jnp.concatenate([z0[None], Z], axis=0)
        return Z, c

    cost_quadratics = make_cost_quadratics(weights, cfg)
    final_quadratics = make_final_quadratics(weights)

    def derivatives(Z, U, prob):
        """All linearizations/quadratics in closed form, batched over time —
        no per-step autodiff (solver/analytic.py)."""
        ZU = jnp.concatenate([Z[:-1], U], axis=1)  # (H, 21)
        A, B = explicit_jacobians(ZU, params, dt)
        lz, lu, lzz, luz, luu = cost_quadratics(
            Z[:-1], U, prob.t_weights, prob.goal_pos, prob.tra_pos, prob.tra_quat
        )
        phi_z, phi_zz = final_quadratics(Z[-1], prob.goal_pos)

        # TRUE projected gradient via the adjoint: g_u = lu + B^T lam_{k+1}.
        # This is the KKT residual the convergence test must use — the
        # backward sweep's expected decrease can vanish spuriously when the
        # value recursion stiffens (huge attitude curvature), which is not
        # optimality.
        def adj(lam, inp):
            a, lz_k = inp
            return lz_k + a.T @ lam, lam

        _, lam_next = jax.lax.scan(adj, phi_z, (A, lz), reverse=True)
        gu = lu + jnp.einsum("hia,hi->ha", B, lam_next)
        eps_b = 1e-7 * (ub - lb)
        free_u = ~(((U <= lb + eps_b) & (gu > 0)) | ((U >= ub - eps_b) & (gu < 0)))
        pg_true = jnp.max(jnp.abs(gu) * free_u)
        return A, B, lz, lu, lzz, luz, luu, phi_z, phi_zz, ZU, pg_true

    def backward(derivs, U, reg):
        """Regularized control-limited Riccati sweep (reverse lax.scan) —
        only light 17x17/4x17 matrix algebra per step; the boxQP and feedback
        solves use the unrolled 4x4 Cholesky (solver/chol4.py), which also
        provides the positive-definiteness failure flag.

        With cfg.use_ddp (default) the sweep includes the second-order
        dynamics terms Vz . f_zz — full DDP / the exact Hessian of the PDP
        Hamiltonian (the machinery sketched at reference quad_OC.py:240-252).
        Because the dynamics are an exact cubic, these are contracted from
        the constant Taylor tensors (two small matmuls per step) instead of a
        per-step jax.hessian."""
        A, B, lz, lu, lzz, luz, luu, phi_z, phi_zz, ZU, pg_true = derivs

        def step(carry, inp):
            Vz, Vzz, dV1, dV2, fail = carry
            a, b, lz_k, lu_k, lzz_k, luz_k, luu_k, u_k, zu_k = inp

            Qz = lz_k + a.T @ Vz
            Qu = lu_k + b.T @ Vz
            Qzz = lzz_k + a.T @ Vzz @ a
            Quz = luz_k + b.T @ Vzz @ a
            Quu = luu_k + b.T @ Vzz @ b

            if cfg.use_ddp:
                # H2 = hess_zu (Vz . f)(zu_k): exact sparse closed form
                # (solver/analytic.py explicit_h2) — ~30 scalar-vector ops
                H2 = explicit_h2(zu_k, Vz, params, dt)
                Qzz = Qzz + H2[:NZ, :NZ]
                Quz = Quz + H2[NZ:, :NZ]
                Quu = Quu + H2[NZ:, NZ:]

            # state-regularized variants (Tassa 2012): add reg through B^T B
            Quu_r = Quu + reg * (b.T @ b)
            Quz_r = Quz + reg * (b.T @ a)
            Quu_r = 0.5 * (Quu_r + Quu_r.T)

            lo = lb - u_k
            hi = ub - u_k
            k_ff, free = boxqp(Quu_r, Qu, lo, hi, iters=cfg.boxqp_iters)
            # feedback only on free dims: masked Cholesky solve, clamped rows 0
            Fm = free[:, None] * free[None, :]
            M = Quu_r * Fm + jnp.diag(1.0 - free)
            L, ok = chol4_factor(M)
            K = -chol4_solve_factored(L, Quz_r * free[:, None]) * free[:, None]
            fail = fail | ~ok

            Vz_n = Qz + K.T @ (Quu @ k_ff) + K.T @ Qu + Quz.T @ k_ff
            Vzz_n = Qzz + K.T @ Quu @ K + K.T @ Quz + Quz.T @ K
            Vzz_n = 0.5 * (Vzz_n + Vzz_n.T)
            dV1 = dV1 + k_ff @ Qu
            dV2 = dV2 + 0.5 * k_ff @ (Quu @ k_ff)
            return (Vz_n, Vzz_n, dV1, dV2, fail), (k_ff, K)

        # derive scalar inits from varying values so the scan carry keeps
        # consistent manual axes under shard_map
        zero = phi_z[0] * 0.0
        init = (phi_z, phi_zz, zero, zero, zero > 1.0)
        (Vz, Vzz, dV1, dV2, fail), (kk, KK) = jax.lax.scan(
            step, init, (A, B, lz, lu, lzz, luz, luu, U, ZU), reverse=True
        )
        return kk, KK, dV1, dV2, fail, pg_true

    if cfg.backward == "parallel":
        # O(log H)-depth associative-scan sweep (solver/parallel_riccati.py);
        # iLQR mode — wins at small batch (single-query replan latency)
        if cfg.use_ddp:
            raise ValueError(
                "cfg.backward='parallel' is a Gauss-Newton (iLQR) sweep and "
                "cannot honor use_ddp=True: the associative-scan composition "
                "has no slot for the second-order dynamics terms. Set "
                "use_ddp=False explicitly to opt into the iLQR downgrade."
            )
        from learningagileflight_se3.solver.parallel_riccati import (
            make_parallel_backward,
        )

        backward = make_parallel_backward(cfg, lb, ub)
    elif cfg.backward != "sequential":
        raise ValueError(f"unknown cfg.backward: {cfg.backward!r}")

    def forward(Z, U, kk, KK, prob, alpha):
        """Closed-loop rollout with clipped controls."""
        z0 = Z[0]

        def body(carry, inp):
            z, c = carry
            z_ref, u_ref, k_ff, K, wk = inp
            u = u_ref + alpha * k_ff + K @ (z - z_ref)
            u = jnp.clip(u, lb, ub)
            c = c + _stage_cost(z, u, wk, prob, weights, cfg)
            zn = _aug_dynamics(z, u, dt, params)
            return (zn, c), (zn, u)

        (zH, c), (Zn, Un) = jax.lax.scan(
            body, (z0, z0[0] * 0.0), (Z[:-1], U, kk, KK, prob.t_weights)
        )
        c = c + _final_cost(zH, prob, weights)
        Zn = jnp.concatenate([z0[None], Zn], axis=0)
        return Zn, Un, c

    def line_search(Z, U, J, kk, KK, prob, dV1, dV2, ls0, deep, skip):
        """Sequential first-acceptable-alpha backtracking (Armijo ratio>0.1).

        A while_loop trying one alpha at a time, starting at index `ls0`
        (0 = alpha 1; with cfg.ls_adaptive the caller warm-starts it at the
        last accepted index - 1).  Under vmap each lane tracks its own
        alpha index; accepted lanes no-op.  Returns the accepted index so
        the caller can thread the warm start.

        `deep`: escalation flag — the lane sweeps the FULL ladder range at
        coarse stride (indices 0, s, 2s, ... with s = ls_max_trips) instead
        of its warm window.  Same trip bill as the capped search, but the
        sweep spans every step-size decade, so a lane wedged against a step
        the warm window never reaches gets unstuck without the lock-step
        cost of walking all 14 rungs (r4: full-depth walks doubled the
        batch's forward-kernel bill for 1.35x less throughput).
        `skip`: finished lanes enter pre-accepted and execute ZERO trips —
        without this, done lanes keep walking the ladder (lock-step with the
        batch under vmap), billing trips to the whole batch every remaining
        iteration."""
        n_alpha = cfg.line_search_steps
        stride = cfg.ls_max_trips
        n_deep = -(-n_alpha // stride)  # ceil: trips to span the ladder
        tiny = jnp.asarray(1e-300 if J.dtype == jnp.float64 else 1e-30, J.dtype)

        def cond(st):
            accepted, i, _, _, _ = st
            max_trips = jnp.where(deep, n_deep, cfg.ls_max_trips)
            return (~accepted) & (jnp.where(deep, i * stride, ls0 + i) < n_alpha) \
                & (i < max_trips)

        def body(st):
            accepted, i, Zb, Ub, Jb = st
            idx = jnp.minimum(jnp.where(deep, i * stride, ls0 + i), n_alpha - 1)
            alpha = alphas.astype(J.dtype)[idx]
            Zn, Un, Jn = forward(Z, U, kk, KK, prob, alpha)
            expected = -(alpha * dV1 + alpha * alpha * dV2)
            ok = (
                (Jn < J)
                & (expected > 0)
                & ((J - Jn) / jnp.maximum(expected, tiny) > 0.1)
                & ~accepted
            )
            Zb = jnp.where(ok, Zn, Zb)
            Ub = jnp.where(ok, Un, Ub)
            Jb = jnp.where(ok, Jn, Jb)
            return (accepted | ok, i + 1, Zb, Ub, Jb)

        st0 = (skip | (J != J),
               jnp.zeros((), jnp.int32) + (J * 0).astype(jnp.int32), Z, U, J)
        accepted, i_f, Zb, Ub, Jb = jax.lax.while_loop(cond, body, st0)
        acc_idx = jnp.where(
            accepted,
            jnp.minimum(jnp.where(deep, (i_f - 1) * stride, ls0 + i_f - 1),
                        n_alpha - 1),
            ls0)
        # a skipped lane reports accepted with an unchanged iterate; the
        # caller's `active` mask already ignores it entirely
        return accepted, Zb, Ub, Jb, acc_idx

    def solve(*args, **kwargs):
        # Every contraction of the solve (17x17 and 4x4 products: nothing a
        # tensor core speeds up) at full f32 precision.  A GPU's default
        # runs f32 products in TF32 (~3 significant digits), which moves
        # converged costs; the policy MLPs keep the default precision.
        with jax.default_matmul_precision("highest"):
            return _solve(*args, **kwargs)

    def _solve(x0, u_last, goal_pos, tra_pos, tra_ang, t, U_init: Optional[jnp.ndarray] = None):
        dtype = jnp.result_type(x0.dtype, jnp.float32)
        x0 = x0.astype(dtype)
        u_last = jnp.asarray(u_last, dtype)
        if cfg.quantize_t:
            t = jnp.round(t * 10.0) / 10.0
        tra_quat = rodrigues_to_quat(jnp.asarray(tra_ang, dtype))
        ks = jnp.arange(H, dtype=dtype)
        t_weights = weights.tra_amp * jnp.exp(-weights.tra_decay * (dt * ks - t) ** 2)
        prob = _Problem(
            z0=jnp.concatenate([x0, u_last]),
            goal_pos=jnp.asarray(goal_pos, dtype),
            tra_pos=jnp.asarray(tra_pos, dtype),
            tra_quat=tra_quat,
            t_weights=t_weights,
        )

        U_mid = jnp.full((H, NU), 0.5 * (lb + ub), dtype)
        if U_init is None:
            # IPOPT's w0 control initialization: midpoint of bounds (quad_OC.py:142)
            U0 = U_mid
        else:
            # warm-start guard: a guess whose rollout explodes (the no-renorm
            # Euler model diverges geometrically once |omega| is large —
            # quad_OC.py:52-53 semantics) poisons every derivative; fall back
            # to the midpoint init when the warm rollout's cost is not sane.
            Uw = U_init.astype(dtype)
            _, Jw = rollout_cost(prob.z0, Uw, prob)
            warm_ok = jnp.isfinite(Jw) & (jnp.abs(Jw) < 1e12)
            U0 = jnp.where(warm_ok, Uw, U_mid)
        U0 = U0 + prob.z0[0] * 0.0  # shard_map-safe: match z0's manual axes

        Z, J0 = rollout_cost(prob.z0, U0, prob)
        KK0 = jnp.zeros((H, NU, NZ), dtype) + J0 * 0.0

        def cond(state):
            Z, U, J, KK, reg, done, it, pg, ls0, n_np, J_chk, w_it, st = state
            return (~done) & (it < cfg.max_iters)

        def body(state):
            Z, U, J, KK, reg, done, it, _, ls0, n_np, J_chk, w_it, st = state
            derivs = derivatives(Z, U, prob)
            kk, KK_new, dV1, dV2, fail, pg = backward(derivs, U, reg)

            # Newton-decrement termination: the model predicts at most
            # -(dV1 + dV2) decrease at a full step — when that is below
            # tolerance the iterate is (numerically) optimal.  Only valid at
            # LOW regularization: large reg shrinks the step (and decrement)
            # artificially, which must not read as optimality.
            decrement = -(dV1 + dV2)
            # optimal iff the TRUE projected gradient is small; the model
            # decrement alone can vanish spuriously (stiff value recursion).
            # `sane` guards the |J|-relative tolerances: at an exploded-
            # rollout cost (1e69) every tolerance is trivially satisfied and
            # the solver would declare a garbage iterate "converged".
            sane = jnp.isfinite(J) & (jnp.abs(J) < 1e12)
            grad_small = pg <= cfg.gtol * (jnp.abs(J) + 1.0)
            stationary = (
                (decrement <= cfg.tol * (jnp.abs(J) + 1.0))
                & (dV1 <= 0)
                & grad_small
                & ~fail
                & sane
            )

            # `active`: under vmap the while_loop runs until ALL lanes finish,
            # so finished lanes (done OR at the iteration cap) must be strict
            # no-ops for batched == single
            active = ~done & (it < cfg.max_iters)
            # ladder escalation: a lane on a failure streak (2+ consecutive
            # rejections) whose model still predicts a meaningful decrease
            # sweeps the FULL ladder range at coarse stride — the trip cap
            # alone can wedge exactly these lanes against a step size the
            # warm window never reaches (r4 audit: cutting them at the cap
            # cost ~1% of lanes ~10x the optimal cost).  Finished lanes are
            # skipped outright so only live streaks ever bill deep trips.
            # Only meaningful under a capped ladder: with the full ladder the
            # coarse sweep would SHRINK the search (stride = full depth).
            if cfg.ls_max_trips < cfg.line_search_steps:
                deep = ((n_np >= 2)
                        & (decrement > cfg.tol * (jnp.abs(J) + 1.0))
                        & active)
            else:
                deep = active & False
            accepted, Z_ls, U_ls, J_ls, acc_idx = line_search(
                Z, U, J, kk, KK_new, prob, dV1, dV2, ls0, deep, ~active
            )
            improved = accepted & ~fail & ~stationary & active

            Z_n = jnp.where(improved, Z_ls, Z)
            U_n = jnp.where(improved, U_ls, U)
            KK_n = jnp.where(improved | (stationary & active), KK_new, KK)
            J_n = jnp.where(improved, J_ls, J)

            reg_n = jnp.where(
                active,
                jnp.where(
                    improved,
                    jnp.maximum(reg * cfg.reg_shrink, cfg.reg_min),
                    jnp.minimum(reg * cfg.reg_grow, cfg.reg_max * 2.0),
                ),
                reg,
            )
            # stalled: no acceptable step and the model predicts none even at
            # elevated regularization — the iterate is at the solver's f32/f64
            # resolution limit (common on warm restarts at an optimum). Two
            # gates keep this from firing prematurely: reg >= 64 (stiff-saddle
            # escapes stay alive — their decrement grows as reg rises) and a
            # LOOSE KKT check (stall_gtol): a failed line search with a large
            # projected gradient is a temporary stall the reg schedule can
            # still rescue, not an fp-resolution limit.
            grad_smallish = pg <= cfg.stall_gtol * (jnp.abs(J) + 1.0)
            stalled = (
                ~improved
                & ~stationary
                & (decrement <= cfg.tol * (jnp.abs(J) + 1.0))
                & (reg >= 64.0)
                & grad_smallish
                & sane
            )
            # progress-window floor (cfg.no_progress_iters = window length
            # W): terminate a lane when an ENTIRE W-iteration window made
            # less than tol*(|J|+1) cumulative cost progress.  Rationale
            # (r4 audit): at f32 the TRUE gradient can stay O(1e-2) relative
            # at the rollout's resolution floor, so the KKT gates never fire
            # even though no step can improve the cost.  The window is the
            # only cut that proved quality-safe: consecutive-rejection
            # strikes and model-decrement gates both cut lanes mid-descent
            # (stiff reg-escalation phases legally make zero progress for
            # several iterations before a big accepted step) and cost 30%
            # of lanes >1% excess; a window only fires when NOTHING in W
            # iterations moved the cost, which mid-descent phases never
            # sustain.
            np_n = jnp.where(active, jnp.where(improved, 0, n_np + 1), n_np)
            w_n = w_it + active.astype(w_it.dtype)
            window_full = (cfg.no_progress_iters > 0) & (
                w_n >= cfg.no_progress_iters
            )
            window_progress = (J_chk - J_n) > cfg.tol * (jnp.abs(J_n) + 1.0)
            floor_exit = window_full & ~window_progress & sane
            # reset the window checkpoint whenever the window elapses
            J_chk_n = jnp.where(window_full & active, J_n, J_chk)
            w_n = jnp.where(window_full & active, 0, w_n)
            blowout = ~improved & ~stationary & (reg > cfg.reg_max)
            done_n = done | (
                active & (stationary | stalled | floor_exit | blowout)
            )
            # exit taxonomy (MPCSolution.status codes); each reason below
            # implies done_n, so writing under `active` is exact
            st_n = st
            st_n = jnp.where(active & stationary, 1, st_n)
            st_n = jnp.where(active & ~stationary & stalled, 2, st_n)
            st_n = jnp.where(
                active & ~stationary & ~stalled & floor_exit, 3, st_n)
            st_n = jnp.where(
                active & ~stationary & ~stalled & ~floor_exit & blowout,
                4, st_n)
            it_n = it + active.astype(it.dtype)
            if cfg.ls_adaptive:
                ls_n = jnp.where(improved & active,
                                 jnp.maximum(acc_idx - 1, 0), ls0)
            else:
                ls_n = ls0
            return (Z_n, U_n, J_n, KK_n, reg_n, done_n, it_n, pg, ls_n, np_n,
                    J_chk_n, w_n, st_n)

        # shard_map-safe inits: derive from the (possibly axis-varying) J0
        reg0 = J0 * 0.0 + cfg.reg_init
        pg0 = J0 * 0.0 + jnp.inf
        done0 = J0 != J0  # False unless the initial rollout is already NaN
        it0 = (J0 * 0.0).astype(jnp.int32)
        state0 = (Z, U0, J0, KK0, reg0, done0, it0, pg0, it0, it0, J0, it0,
                  it0)
        (Zf, Uf, Jf, KKf, regf, donef, itf, pgf, _, _, _, _, stf) = (
            jax.lax.while_loop(cond, body, state0)
        )

        sol = MPCSolution(
            state_traj=Zf[:, :NX],
            control_traj=Uf,
            cost=Jf,
            iterations=itf,
            converged=donef & jnp.isfinite(Jf) & (jnp.abs(Jf) < 1e12),
            gains_K=KKf if return_gains else jnp.zeros((0,), dtype),
            grad_norm=pgf,
            reg_final=regf,
            status=stf,
        )
        return sol

    return solve


def make_batched_mpc_solver(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
    return_gains: bool = False,
):
    """Batched solver over a leading scenario axis: the vmap of
    `make_mpc_solver`.

    solve_batch(x0[B,13], u_last[B,4], goal[B,3], tra_pos[B,3], tra_ang[B,3],
                t[B], U_init=None|[B,H,4]) -> MPCSolution with leading B axis.

    One XLA computation over the batch; the reference fans the same solves
    out to 10 IPOPT processes (deep_learning.py:66-72).  Any B, no padding:
    every lane is independent and finished lanes are strict no-ops.
    """
    solve = make_mpc_solver(params, weights, cfg, return_gains=return_gains)

    def solve_batch(x0, u_last, goal, tra_pos, tra_ang, t, U_init=None):
        if U_init is None:
            return jax.vmap(lambda a, b, c, d, e, f: solve(a, b, c, d, e, f))(
                x0, u_last, goal, tra_pos, tra_ang, t
            )
        return jax.vmap(solve)(x0, u_last, goal, tra_pos, tra_ang, t, U_init)

    return solve_batch
