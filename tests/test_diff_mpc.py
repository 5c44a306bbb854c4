"""Differentiable-MPC gradient tests (SURVEY.md section 4 anchor 4): the
analytic implicit-function VJP must match central finite differences of the
re-solved problem, and the FD learning signal must reproduce the reference's
clip/scale/quantize semantics (quad_policy.py:94-112)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from learningagileflight_se3.config import (
    CostWeights,
    LearnedGradConfig,
    QuadParams,
    RewardConfig,
    SolverConfig,
)
from learningagileflight_se3.core.rotations import axis_angle_to_quat
from learningagileflight_se3.geometry.gate import gate_from_width, rotate_y
from learningagileflight_se3.policy import (
    make_fd_gradient,
    make_objective,
)
from learningagileflight_se3.solver.diff import make_differentiable_control_solver

PARAMS = QuadParams()
WEIGHTS = CostWeights()


def scenario():
    x0 = np.zeros(13)
    x0[0:3] = [0.3, -6.0, 0.4]
    x0[6:10] = np.asarray(axis_angle_to_quat(jnp.asarray(0.05), jnp.asarray([0.0, 0.0, 1.0])))
    u_last = np.zeros(4)
    goal = np.array([0.2, 6.0, -0.1])
    tra_pos = np.array([0.0, 0.0, 0.1])
    tra_ang = np.array([0.05, 0.4, -0.03])
    t = 1.0
    return x0, u_last, goal, tra_pos, tra_ang, t


class TestAnalyticVJP:
    def test_vjp_matches_fd_resolve(self):
        """d(smooth outer fn of U*)/d theta: custom VJP vs central differences
        with full re-solves.  Scenario chosen so the solver reaches a tight
        fixed point and the active set is locally constant (the implicit
        function theorem's hypotheses — under active-set changes the FD
        baseline itself is invalid)."""
        H = 6
        cfg = SolverConfig(horizon=H, max_iters=200, tol=1e-13, quantize_t=False)
        solve_u = make_differentiable_control_solver(PARAMS, WEIGHTS, cfg)
        x0 = np.zeros(13)
        x0[0:3] = [0.3, -2.0, 0.4]
        x0[6:10] = np.asarray(
            axis_angle_to_quat(jnp.asarray(0.05), jnp.asarray([0.0, 0.0, 1.0]))
        )
        u_last = np.zeros(4)
        goal = np.array([0.2, 2.0, -0.1])
        tra_pos = np.array([0.0, 0.0, 0.1])
        tra_ang = np.array([0.05, 0.4, -0.03])
        t = 0.3
        args = [jnp.asarray(a, jnp.float64) for a in (x0, u_last, goal, tra_pos, tra_ang)]
        t = jnp.asarray(t, jnp.float64)

        W = jnp.asarray(np.random.default_rng(1).normal(size=(H, 4)))

        def outer(tra_pos_, tra_ang_, t_):
            U = solve_u(args[0], args[1], args[2], tra_pos_, tra_ang_, t_)
            return jnp.sum(W * U) + 0.1 * jnp.sum(U**2)

        g_tp, g_ta, g_t = jax.grad(outer, argnums=(0, 1, 2))(args[3], args[4], t)

        eps = 1e-5
        outer_j = jax.jit(outer)

        def fd(i):
            # i in 0..6 over (tra_pos, tra_ang, t)
            def shift(s):
                tp, ta, tt = np.array(args[3]), np.array(args[4]), float(t)
                if i < 3:
                    tp = tp.copy(); tp[i] += s
                elif i < 6:
                    ta = ta.copy(); ta[i - 3] += s
                else:
                    tt += s
                return float(outer_j(jnp.asarray(tp), jnp.asarray(ta), jnp.asarray(tt)))

            return (shift(eps) - shift(-eps)) / (2 * eps)

        analytic = np.concatenate([np.asarray(g_tp), np.asarray(g_ta), [float(g_t)]])
        numeric = np.array([fd(i) for i in range(7)])
        np.testing.assert_allclose(analytic, numeric, rtol=1e-3, atol=1e-4)


class TestFDGradient:
    @pytest.mark.slow
    def test_semantics(self):
        """Shape/sign/quantization of the reference learning signal."""
        cfg = SolverConfig(horizon=12, max_iters=100)
        rcfg = RewardConfig()
        fd = jax.jit(make_fd_gradient(PARAMS, WEIGHTS, cfg, rcfg))
        x0, u_last, goal, tra_pos, tra_ang, t = scenario()
        gate_pts = rotate_y(gate_from_width(jnp.asarray(0.9)), jnp.asarray(0.4))
        neg_grad, r0 = fd(
            jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal), gate_pts,
            jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(t),
        )
        neg_grad = np.asarray(neg_grad)
        assert neg_grad.shape == (7,)
        assert np.isfinite(float(r0))
        # position components bounded by clip*scale = 0.5*0.1
        assert np.all(np.abs(neg_grad[0:3]) <= 0.05 + 1e-12)
        # angle components bounded by 0.5/(500 a^2 + 5)
        bound = 0.5 / (500 * np.asarray(tra_ang) ** 2 + 5)
        assert np.all(np.abs(neg_grad[3:6]) <= bound + 1e-12)
        # time gradient quantized
        assert float(neg_grad[6]) in (-0.05, 0.0, 0.05)

    def test_matches_manual_probes(self):
        """FD gradient equals hand-computed probe differences through the
        plain objective.  max_iters generous so every probe converges —
        unconverged solves may differ in fp noise between the vmapped probe
        batch and single solves."""
        cfg = SolverConfig(horizon=10, max_iters=150)
        rcfg = RewardConfig()
        gcfg = LearnedGradConfig()
        objective = jax.jit(
            lambda *a: make_objective(PARAMS, WEIGHTS, cfg, rcfg)(*a).reward
        )
        fd = jax.jit(make_fd_gradient(PARAMS, WEIGHTS, cfg, rcfg, gcfg))
        x0, u_last, goal, tra_pos, tra_ang, _ = scenario()
        t = 2.5  # mild traversal time: all probe solves converge
        gate_pts = rotate_y(gate_from_width(jnp.asarray(0.9)), jnp.asarray(0.4))
        a = [jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal), gate_pts]

        neg_grad, r0 = fd(*a, jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(t))
        r_base = float(objective(*a, jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(t)))
        np.testing.assert_allclose(float(r0), r_base, rtol=1e-9)

        d = gcfg.delta
        drdx = np.clip(
            float(objective(*a, jnp.asarray(tra_pos + [d, 0, 0]), jnp.asarray(tra_ang), jnp.asarray(t)))
            - r_base, -0.5, 0.5,
        ) * 0.1
        np.testing.assert_allclose(float(neg_grad[0]), -drdx, atol=1e-9)
        drdb = np.clip(
            float(objective(*a, jnp.asarray(tra_pos), jnp.asarray(tra_ang + [0, d, 0]), jnp.asarray(t)))
            - r_base, -0.5, 0.5,
        ) * (1.0 / (500 * tra_ang[1] ** 2 + 5))
        np.testing.assert_allclose(float(neg_grad[4]), -drdb, atol=1e-9)
