"""Policy layer: the MPC objective (reward-through-solver) and its two
learning signals — the reference-semantics finite-difference gradient and the
analytic differentiable-MPC gradient.

This is the batched-accelerator `run_quad` (reference quad_policy.py:15-211).  Key
difference: where the reference rebuilds CasADi symbols and calls IPOPT 9
times per gradient inside forked worker processes (deep_learning.py:24-32,
quad_policy.py:94-112), here the 9 probe problems are one extra batch axis
of the vmapped solver — a single XLA computation per training batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import (
    CostWeights,
    LearnedGradConfig,
    QuadParams,
    RewardConfig,
    SolverConfig,
)
from learningagileflight_se3.dynamics.quadrotor import rollout
from learningagileflight_se3.geometry.collision import trajectory_reward
from learningagileflight_se3.solver.diff import make_differentiable_control_solver
from learningagileflight_se3.solver.ilqr import make_mpc_solver


class ObjectiveResult(NamedTuple):
    reward: jnp.ndarray
    collision: jnp.ndarray
    path: jnp.ndarray
    inside_gate: jnp.ndarray
    state_traj: jnp.ndarray
    control_traj: jnp.ndarray
    solver_iterations: jnp.ndarray
    solver_converged: jnp.ndarray


def make_objective(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
):
    """objective(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t) -> ObjectiveResult.

    Mirrors run_quad.objective (quad_policy.py:67-91): solve the MPC, map the
    trajectory to rotor tips, score collision + terminal path, combine."""
    solve = make_mpc_solver(params, weights, solver_cfg, return_gains=False)
    H = solver_cfg.horizon

    def objective(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t, U_init=None):
        sol = solve(x0, u_last, goal, tra_pos, tra_ang, t, U_init)
        reward, collision, path, inside = trajectory_reward(
            sol.state_traj, gate_pts, goal, reward_cfg, H
        )
        return ObjectiveResult(
            reward=reward,
            collision=collision,
            path=path,
            inside_gate=inside,
            state_traj=sol.state_traj,
            control_traj=sol.control_traj,
            solver_iterations=sol.iterations,
            solver_converged=sol.converged,
        )

    return objective


def make_fd_gradient(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
    grad_cfg: LearnedGradConfig = LearnedGradConfig(),
):
    """Reference-exact finite-difference learning signal
    (run_quad.sol_gradient, quad_policy.py:94-112).

    Returns fd_gradient(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t)
      -> (neg_grad (7,), reward scalar)
    matching the reference's `[-drdx..,-drdt, j]` convention: the 9 probe
    solves [base, +dx,+dy,+dz, +da,+db,+dc, t-0.1, t+0.1] run as ONE vmapped
    batch; differences are clipped to +-0.5, position grads scaled by 0.1,
    angle grads by 1/(500 a_i^2 + 5), and the time gradient quantized to
    {0, +-0.05} by the reward>2 test.

    (Reference quirk preserved-by-equivalence: sol_gradient forwards Ulast
    only to the six pose probes, but every training call passes Ulast=None ->
    zeros (deep_learning.py:32), so a uniform u_last reproduces the exercised
    behavior.)"""
    objective = make_objective(params, weights, solver_cfg, reward_cfg)
    d = grad_cfg.delta

    def fd_gradient(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        dtype = tra_pos.dtype
        eye = jnp.eye(3, dtype=dtype) * d
        tp = jnp.concatenate(
            [tra_pos[None], tra_pos[None] + eye, jnp.tile(tra_pos[None], (5, 1))]
        )  # (9,3)
        ta = jnp.concatenate(
            [
                jnp.tile(tra_ang[None], (4, 1)),
                tra_ang[None] + eye,
                jnp.tile(tra_ang[None], (2, 1)),
            ]
        )  # (9,3)
        ts = jnp.concatenate(
            [
                jnp.full((7,), t, dtype),
                jnp.asarray([t - grad_cfg.t_probe, t + grad_cfg.t_probe], dtype),
            ]
        )  # (9,)

        res = jax.vmap(
            lambda tpi, tai, ti: objective(x0, u_last, goal, gate_pts, tpi, tai, ti)
        )(tp, ta, ts)
        r = res.reward
        r0 = r[0]
        diffs = jnp.clip(r[1:7] - r0, -grad_cfg.clip, grad_cfg.clip)
        g_pos = diffs[0:3] * grad_cfg.pos_scale
        g_ang = diffs[3:6] / (grad_cfg.ang_scale_a * tra_ang**2 + grad_cfg.ang_scale_b)
        g_t = jnp.where(
            r[8] - r0 > grad_cfg.t_threshold,
            grad_cfg.t_step,
            jnp.where(r[7] - r0 > grad_cfg.t_threshold, -grad_cfg.t_step, 0.0),
        )
        neg_grad = -jnp.concatenate([g_pos, g_ang, g_t[None]])
        return neg_grad, r0

    return fd_gradient


def make_fd_gradient_batched(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
    grad_cfg: LearnedGradConfig = LearnedGradConfig(),
):
    """Natively-batched FD learning signal: semantics identical to
    `jax.vmap(make_fd_gradient(...))` but all 9*B probe solves are ONE
    `make_batched_mpc_solver` call (the training-throughput analogue of
    bench.py's batched path).

    fd(x0 (B,13), u_last (B,4), goal (B,3), gate_pts (B,4,3), tra_pos (B,3),
       tra_ang (B,3), t (B,)) -> (neg_grad (B,7), reward (B,))"""
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver

    bsolve = make_batched_mpc_solver(params, weights, solver_cfg,
                                     return_gains=False)
    H = solver_cfg.horizon
    d = grad_cfg.delta

    def fd(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        B = x0.shape[0]
        dtype = tra_pos.dtype
        eye = jnp.eye(3, dtype=dtype) * d
        # probe grids (B,9,*): [base, +dx,+dy,+dz, +da,+db,+dc, t-dt, t+dt]
        tp = jnp.concatenate(
            [tra_pos[:, None], tra_pos[:, None] + eye[None],
             jnp.tile(tra_pos[:, None], (1, 5, 1))], axis=1)
        ta = jnp.concatenate(
            [jnp.tile(tra_ang[:, None], (1, 4, 1)),
             tra_ang[:, None] + eye[None],
             jnp.tile(tra_ang[:, None], (1, 2, 1))], axis=1)
        ts = jnp.concatenate(
            [jnp.tile(t[:, None], (1, 7)),
             t[:, None] - grad_cfg.t_probe, t[:, None] + grad_cfg.t_probe],
            axis=1)
        rep = lambda a: jnp.repeat(a, 9, axis=0)        # scenario-major
        flat = lambda a: a.reshape((B * 9,) + a.shape[2:])
        sol = bsolve(rep(x0), rep(u_last), rep(goal),
                     flat(tp), flat(ta), flat(ts))
        X = sol.state_traj.reshape(B, 9, H + 1, 13)

        def reward_one(Xi, pts, gl):
            r, *_ = trajectory_reward(Xi, pts, gl, reward_cfg, H)
            return r

        r = jax.vmap(
            lambda Xb, pts, gl: jax.vmap(
                lambda Xi: reward_one(Xi, pts, gl))(Xb)
        )(X, gate_pts, goal)                             # (B,9)
        r0 = r[:, 0]
        diffs = jnp.clip(r[:, 1:7] - r0[:, None], -grad_cfg.clip, grad_cfg.clip)
        g_pos = diffs[:, 0:3] * grad_cfg.pos_scale
        g_ang = diffs[:, 3:6] / (
            grad_cfg.ang_scale_a * tra_ang**2 + grad_cfg.ang_scale_b)
        g_t = jnp.where(
            r[:, 8] - r0 > grad_cfg.t_threshold,
            grad_cfg.t_step,
            jnp.where(r[:, 7] - r0 > grad_cfg.t_threshold,
                      -grad_cfg.t_step, 0.0),
        )
        neg_grad = -jnp.concatenate([g_pos, g_ang, g_t[:, None]], axis=1)
        return neg_grad, r0

    return fd


def make_analytic_gradient(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
    grad_cfg: LearnedGradConfig = LearnedGradConfig(),
    shaped: bool = True,
):
    """Analytic differentiable-MPC learning signal (the PDP path the reference
    sketched but never ran, quad_OC.py:214-306): ONE solve per scenario, with
    d(reward)/d(tra_pos, tra_ang, t) by the implicit-function custom-VJP.

    shaped=True (default) passes the raw gradient through the SAME trust
    region the reference's FD scheme applies to its reward differences
    (quad_policy.py:100-110): per-coordinate clip of delta*grad at
    +-grad_cfg.clip, the 0.1 / 1/(500a^2+5) scales, and the +-0.05
    time-step quantization — i.e. the exact delta->0 limit of the FD
    signal, at 1 solve instead of 9.  Round-2 ablation showed the UNSHAPED
    gradient training to -512 mean reward vs fd's -0.76 at equal budget
    (runs/ablate_rl): the raw d(reward) of a 1000x-weighted, kink-rich
    collision term is unbounded per sample, so single near-collision
    scenarios dominate the surrogate batch gradient; the FD clip is an
    implicit per-sample trust region, restored here.

    Returns analytic_gradient(...) -> (grad (7,), reward scalar); the
    ASCENT direction (+d reward), sign-compatible with the reference's
    neg_grad after the surrogate-loss flip."""
    solve_u = make_differentiable_control_solver(params, weights, solver_cfg)
    H = solver_cfg.horizon

    def reward_of(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        U = solve_u(x0, u_last, goal, tra_pos, tra_ang, t)
        X = rollout(x0, U, solver_cfg.dt, params)
        reward, *_ = trajectory_reward(X, gate_pts, goal, reward_cfg, H)
        return reward

    def analytic_gradient(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        r, (g_tp, g_ta, g_t) = jax.value_and_grad(reward_of, argnums=(4, 5, 6))(
            x0, u_last, goal, gate_pts, tra_pos, tra_ang, t
        )
        if not shaped:
            return jnp.concatenate([g_tp, g_ta, g_t[None]]), r
        d, c = grad_cfg.delta, grad_cfg.clip
        g_pos = jnp.clip(d * g_tp, -c, c) * grad_cfg.pos_scale
        g_ang = jnp.clip(d * g_ta, -c, c) / (
            grad_cfg.ang_scale_a * tra_ang**2 + grad_cfg.ang_scale_b
        )
        # the FD time rule tests r(t +- t_probe) - r0 > t_threshold; its
        # directional-derivative limit is +-t_probe*g_t > t_threshold
        up = grad_cfg.t_probe * g_t > grad_cfg.t_threshold
        dn = -grad_cfg.t_probe * g_t > grad_cfg.t_threshold
        g_time = jnp.where(up, grad_cfg.t_step,
                           jnp.where(dn, -grad_cfg.t_step, 0.0))
        return jnp.concatenate([g_pos, g_ang, g_time[None]]), r

    return analytic_gradient


def make_analytic_gradient_batched(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
    grad_cfg: LearnedGradConfig = LearnedGradConfig(),
    shaped: bool = True,
):
    """Batched analytic (PDP) learning signal: semantics identical to
    `jax.vmap(make_analytic_gradient(...))` but the forward solves are ONE
    `make_batched_mpc_solver` call through
    `make_differentiable_control_solver_batched`, and the implicit-function
    VJP is the vmapped per-problem kernel.

    ana(x0 (B,13), u_last (B,4), goal (B,3), gate_pts (B,4,3), tra_pos (B,3),
        tra_ang (B,3), t (B,)) -> (ascent grad (B,7), reward (B,))"""
    from learningagileflight_se3.solver.diff import (
        make_differentiable_control_solver_batched,
    )

    solve_u = make_differentiable_control_solver_batched(
        params, weights, solver_cfg)
    H = solver_cfg.horizon

    def rewards_sum(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        U = solve_u(x0, u_last, goal, tra_pos, tra_ang, t)     # (B,H,4)
        X = jax.vmap(lambda x, u: rollout(x, u, solver_cfg.dt, params))(x0, U)

        def one(Xi, pts, gl):
            r, *_ = trajectory_reward(Xi, pts, gl, reward_cfg, H)
            return r

        r = jax.vmap(one)(X, gate_pts, goal)                   # (B,)
        # each lane's reward depends only on its own theta, so the gradient
        # of the SUM is the per-lane gradient stack
        return jnp.sum(r), r

    def analytic_gradient(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        (_, r), (g_tp, g_ta, g_t) = jax.value_and_grad(
            rewards_sum, argnums=(4, 5, 6), has_aux=True
        )(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t)
        if not shaped:
            return jnp.concatenate([g_tp, g_ta, g_t[:, None]], axis=1), r
        d, c = grad_cfg.delta, grad_cfg.clip
        g_pos = jnp.clip(d * g_tp, -c, c) * grad_cfg.pos_scale
        g_ang = jnp.clip(d * g_ta, -c, c) / (
            grad_cfg.ang_scale_a * tra_ang**2 + grad_cfg.ang_scale_b
        )
        up = grad_cfg.t_probe * g_t > grad_cfg.t_threshold
        dn = -grad_cfg.t_probe * g_t > grad_cfg.t_threshold
        g_time = jnp.where(up, grad_cfg.t_step,
                           jnp.where(dn, -grad_cfg.t_step, 0.0))
        return jnp.concatenate([g_pos, g_ang, g_time[:, None]], axis=1), r

    return analytic_gradient


class PolicySearchResult(NamedTuple):
    """Mirror of run_quad.optimize's return list (quad_policy.py:144-147)."""

    t: jnp.ndarray          # final traversal time
    tra_pos: jnp.ndarray    # (3,)
    tra_ang: jnp.ndarray    # (3,) Rodrigues
    reward: jnp.ndarray     # last evaluated reward j
    collision: jnp.ndarray
    path: jnp.ndarray
    reward_hist: jnp.ndarray  # (iters,) per-iteration base reward


def make_policy_search(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
    grad_cfg: LearnedGradConfig = LearnedGradConfig(),
    iters: int = 200,
    warm_start: bool = True,
):
    """Standalone (NN-free) policy search — run_quad.optimize
    (quad_policy.py:115-147): FD gradient ascent over the 7 decision
    variables, starting from the gate centroid with zero rotation.

    Per-iteration semantics match the reference exactly:
      * 9 probes [base, pos+d e_i, ang+d e_i, t-0.1, t+0.1], differences
        clipped to +-0.5;
      * update steps 0.1 (position) and 1/(500 a_i^2 + 5) (angles);
      * t moves -0.1 if that probe improves by >2, ELSE +0.1 if that probe
        does (the reference's two sequential `if`s collapse to this: after
        t -= 0.1 the second probe re-evaluates the base point, quad_policy.py
        140-143), then rounds to 0.1 s.

    Where the reference runs 9 fresh IPOPT processes per iteration, here the
    9 probes are one vmapped batch and the loop is a `lax.scan`; with
    `warm_start` every probe starts from the previous base solution's control
    trajectory (same basin for all probes => consistent differences).

    Returns search(x0, u_last, goal, gate_pts, tra_pos0, t0) ->
    PolicySearchResult.  tra_pos0 defaults to the gate centroid in callers
    (obstacle1.centroid, quad_policy.py:116).
    """
    objective = make_objective(params, weights, solver_cfg, reward_cfg)
    d = grad_cfg.delta
    H = solver_cfg.horizon

    def probes(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t, U_init):
        dtype = tra_pos.dtype
        eye = jnp.eye(3, dtype=dtype) * d
        tp = jnp.concatenate(
            [tra_pos[None], tra_pos[None] + eye, jnp.tile(tra_pos[None], (5, 1))]
        )
        ta = jnp.concatenate(
            [jnp.tile(tra_ang[None], (4, 1)), tra_ang[None] + eye,
             jnp.tile(tra_ang[None], (2, 1))]
        )
        ts = jnp.concatenate(
            [jnp.full((7,), t, dtype),
             jnp.asarray([t - grad_cfg.t_probe, t + grad_cfg.t_probe], dtype)]
        )
        return jax.vmap(
            lambda tpi, tai, ti: objective(
                x0, u_last, goal, gate_pts, tpi, tai, ti, U_init
            )
        )(tp, ta, ts)

    def search(x0, u_last, goal, gate_pts, tra_pos0, t0):
        dtype = tra_pos0.dtype
        tra_ang0 = jnp.zeros(3, dtype)

        def body(carry, _):
            tra_pos, tra_ang, t, U_warm = carry
            res = probes(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t, U_warm)
            r = res.reward
            j = r[0]
            diffs = jnp.clip(r[1:7] - j, -grad_cfg.clip, grad_cfg.clip)
            tra_pos_n = tra_pos + 0.1 * diffs[0:3]
            tra_ang_n = tra_ang + diffs[3:6] / (
                grad_cfg.ang_scale_a * tra_ang**2 + grad_cfg.ang_scale_b
            )
            t_n = jnp.where(
                r[7] - j > grad_cfg.t_threshold,
                t - grad_cfg.t_probe,
                jnp.where(r[8] - j > grad_cfg.t_threshold, t + grad_cfg.t_probe, t),
            )
            t_n = jnp.round(t_n * 10.0) / 10.0
            U_next = res.control_traj[0] if warm_start else U_warm
            return (tra_pos_n, tra_ang_n, t_n, U_next), (j, res.collision[0], res.path[0])

        U0 = jnp.full((H, 4), 0.5 * (solver_cfg.u_lb + solver_cfg.u_ub), dtype)
        (tra_pos, tra_ang, t, _), (js, cols, paths) = jax.lax.scan(
            body, (tra_pos0, tra_ang0, jnp.asarray(t0, dtype), U0), None,
            length=iters,
        )
        return PolicySearchResult(
            t=t, tra_pos=tra_pos, tra_ang=tra_ang,
            reward=js[-1], collision=cols[-1], path=paths[-1], reward_hist=js,
        )

    return search


def make_lsfd_search(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
    iters: int = 50,
    n_samples: int = 24,
    deviation: float = 1e-3,
    warm_start: bool = True,
):
    """Least-squares finite-difference policy search — run_quad.LSFD
    (quad_policy.py:150-186): per iteration, probe the reward at `n_samples`
    Gaussian perturbations (sigma=1e-3, quad_policy.py:214-216) of the 6 pose
    parameters, recover the gradient by least squares
    (pinv(C^T C) C^T f), and ascend with lr [2e-4 x3, 5e-5 x3]; the traversal
    time then moves +0.1 if that improves reward by >20, else -0.1 if that
    does (quad_policy.py:178-182), rounded to 0.1 s.

    All `n_samples + 3` probes (base, samples, t+-0.1) are one vmapped batch
    per iteration.  Returns search(key, x0, u_last, goal, gate_pts, tra_pos0,
    t0) -> PolicySearchResult.
    """
    objective = make_objective(params, weights, solver_cfg, reward_cfg)
    H = solver_cfg.horizon
    lr = jnp.asarray([2e-4, 2e-4, 2e-4, 5e-5, 5e-5, 5e-5])

    def search(key, x0, u_last, goal, gate_pts, tra_pos0, t0):
        dtype = tra_pos0.dtype

        def body(carry, k):
            para, t, U_warm = carry
            dx = deviation * jax.random.normal(k, (n_samples, 6), dtype)
            tp = jnp.concatenate([para[None, 0:3], para[None, 0:3] + dx[:, 0:3]])
            ta = jnp.concatenate([para[None, 3:6], para[None, 3:6] + dx[:, 3:6]])
            ts = jnp.full((n_samples + 1,), t, dtype)
            res = jax.vmap(
                lambda tpi, tai, ti: objective(
                    x0, u_last, goal, gate_pts, tpi, tai, ti, U_warm
                )
            )(tp, ta, ts)
            f = res.reward[1:] - res.reward[0]
            # least-squares gradient: (C^T C)^{-1} C^T f (quad_policy.py:171-173)
            g = jnp.linalg.solve(dx.T @ dx, dx.T @ f)
            para_n = para + lr.astype(dtype) * g
            # the reference re-evaluates the base reward at the UPDATED
            # parameters before the time probes (quad_policy.py:177-182)
            ts2 = jnp.asarray([t, t + 0.1, t - 0.1], dtype)
            res2 = jax.vmap(
                lambda ti: objective(
                    x0, u_last, goal, gate_pts, para_n[0:3], para_n[3:6], ti, U_warm
                )
            )(ts2)
            j = res2.reward[0]
            t_n = jnp.where(
                res2.reward[1] - j > 20.0,
                t + 0.1,
                jnp.where(res2.reward[2] - j > 20.0, t - 0.1, t),
            )
            t_n = jnp.round(t_n * 10.0) / 10.0
            U_next = res2.control_traj[0] if warm_start else U_warm
            return (para_n, t_n, U_next), (j, res2.collision[0], res2.path[0])

        U0 = jnp.full((H, 4), 0.5 * (solver_cfg.u_lb + solver_cfg.u_ub), dtype)
        para0 = jnp.concatenate([tra_pos0, jnp.zeros(3, dtype)])
        (para, t, _), (js, cols, paths) = jax.lax.scan(
            body, (para0, jnp.asarray(t0, dtype), U0),
            jax.random.split(key, iters),
        )
        return PolicySearchResult(
            t=t, tra_pos=para[0:3], tra_ang=para[3:6],
            reward=js[-1], collision=cols[-1], path=paths[-1], reward_hist=js,
        )

    return search


def make_get_input(
    params: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
):
    """run_quad.get_input (quad_policy.py:202-211): full MPC solve, return the
    first control (receding-horizon convention). Supports warm starting —
    pass the previous solution's control trajectory as U_init for the
    closed-loop 10 Hz replanning loop."""
    solve = make_mpc_solver(params, weights, solver_cfg, return_gains=False)

    def get_input(x0, u_last, tra_pos, tra_ang, t, goal, U_init: Optional[jnp.ndarray] = None):
        sol = solve(x0, u_last, goal, tra_pos, tra_ang, t, U_init)
        return sol.control_traj[0], sol

    return get_input
