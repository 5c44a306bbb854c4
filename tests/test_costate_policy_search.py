"""Tests for costate extraction (reference quad_OC.py:185-201, component #8)
and the standalone NN-free policy search (quad_policy.py:115-186, #13)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import (
    CostWeights,
    LearnedGradConfig,
    QuadParams,
    RewardConfig,
    SolverConfig,
)
from learningagileflight_se3.core.rotations import rodrigues_to_quat
from learningagileflight_se3.costs.gate_costs import (
    final_cost,
    goal_cost,
    traversal_cost,
)
from learningagileflight_se3.dynamics.quadrotor import euler_step
from learningagileflight_se3.geometry.gate import gate_from_width
from learningagileflight_se3.policy import (
    make_lsfd_search,
    make_policy_search,
)
from learningagileflight_se3.solver.costate import make_costate_extractor
from learningagileflight_se3.solver.ilqr import make_mpc_solver

PARAMS = QuadParams()
WEIGHTS = CostWeights()


def scenario():
    x0 = np.zeros(13)
    x0[0:3] = [0.5, -6.0, 0.2]
    x0[6] = 1.0
    return (
        jnp.asarray(x0),
        jnp.zeros(4),
        jnp.asarray([0.0, 6.0, 0.0]),
        jnp.asarray([0.0, 0.1, 0.0]),
        jnp.asarray([0.0, 0.4, 0.0]),
        jnp.asarray(2.0),
    )


class TestCostates:
    def test_adjoint_matches_tail_cost_gradient(self):
        """lam[k-1] must equal d(tail cost from step k)/d x_k along the
        optimal trajectory — the defining property of the lam_g multipliers
        of the lifted NLP (quad_OC.py:162-164,187-188)."""
        cfg = SolverConfig(horizon=12, max_iters=60)
        x0, u_last, goal, tra_pos, tra_ang, t = scenario()
        solve = jax.jit(make_mpc_solver(PARAMS, WEIGHTS, cfg))
        sol = solve(x0, u_last, goal, tra_pos, tra_ang, t)
        X, U = sol.state_traj, sol.control_traj

        costates = jax.jit(make_costate_extractor(PARAMS, WEIGHTS, cfg, 0))
        lam = costates(X, U, goal, tra_pos, tra_ang, t)
        assert lam.shape == (cfg.horizon, 13)

        tq = rodrigues_to_quat(tra_ang)
        ks = jnp.arange(cfg.horizon, dtype=X.dtype)
        t_w = WEIGHTS.tra_amp * jnp.exp(
            -WEIGHTS.tra_decay * (cfg.dt * ks - jnp.round(t * 10) / 10) ** 2
        )

        def tail_cost(xk, k0):
            # sum_{j>=k0} stage_x(x_j) + phi(x_H), states re-rolled from xk
            c = 0.0
            x = xk
            for j in range(k0, cfg.horizon):
                c = c + t_w[j] * traversal_cost(x, tra_pos, tq, WEIGHTS)
                c = c + goal_cost(x, goal, WEIGHTS)
                x = euler_step(x, U[j], cfg.dt, PARAMS)
            return c + final_cost(x, goal, WEIGHTS)

        for k in [1, 5, cfg.horizon - 1]:
            g = jax.grad(lambda xx: tail_cost(xx, k))(X[k])
            np.testing.assert_allclose(
                np.asarray(lam[k - 1]), np.asarray(g), rtol=1e-8, atol=1e-10
            )

    @pytest.mark.slow
    def test_pmp_variant_differs_and_terminal_row(self):
        """Option 1 reproduces the reference's path-cost-only recursion; the
        terminal row is dphi/dx for both options (quad_OC.py:195)."""
        cfg = SolverConfig(horizon=10, max_iters=40)
        x0, u_last, goal, tra_pos, tra_ang, t = scenario()
        solve = jax.jit(make_mpc_solver(PARAMS, WEIGHTS, cfg))
        sol = solve(x0, u_last, goal, tra_pos, tra_ang, t)
        X, U = sol.state_traj, sol.control_traj
        lam0 = make_costate_extractor(PARAMS, WEIGHTS, cfg, 0)(
            X, U, goal, tra_pos, tra_ang, t
        )
        lam1 = make_costate_extractor(PARAMS, WEIGHTS, cfg, 1)(
            X, U, goal, tra_pos, tra_ang, t
        )
        gH = jax.grad(lambda xx: final_cost(xx, goal, WEIGHTS))(X[-1])
        np.testing.assert_allclose(np.asarray(lam0[-1]), np.asarray(gH), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(lam1[-1]), np.asarray(gH), rtol=1e-12)
        # the traversal term is missing from option 1 -> different interior rows
        assert float(jnp.max(jnp.abs(lam0[:-1] - lam1[:-1]))) > 1e-3


class TestPolicySearch:
    def test_optimize_improves_reward(self):
        """200-iter reference run shrunk to 12: the FD ascent must improve
        the reward from the centroid/zero-rotation start (quad_policy.py:115)."""
        cfg = SolverConfig(horizon=12, max_iters=40)
        x0, u_last, goal, _, _, _ = scenario()
        gate_pts = gate_from_width(jnp.asarray(0.9), jnp.asarray(0.45))
        search = jax.jit(
            make_policy_search(
                PARAMS, WEIGHTS, cfg, RewardConfig(), LearnedGradConfig(), iters=12
            )
        )
        res = search(x0, u_last, goal, gate_pts, jnp.zeros(3), 1.5)
        hist = np.asarray(res.reward_hist)
        assert hist.shape == (12,)
        assert hist[-1] >= hist[0] - 1e-6, f"reward fell: {hist[0]} -> {hist[-1]}"
        assert np.isfinite(float(res.reward))
        # t stays on the 0.1 grid (round(t,1), quad_policy.py:139)
        assert abs(float(res.t) * 10 - round(float(res.t) * 10)) < 1e-9

    def test_lsfd_runs_and_stays_on_grid(self):
        cfg = SolverConfig(horizon=10, max_iters=30)
        x0, u_last, goal, _, _, _ = scenario()
        gate_pts = gate_from_width(jnp.asarray(1.0), jnp.asarray(0.3))
        search = jax.jit(
            make_lsfd_search(PARAMS, WEIGHTS, cfg, RewardConfig(), iters=4)
        )
        res = search(jax.random.PRNGKey(0), x0, u_last, goal, gate_pts,
                     jnp.zeros(3), 1.5)
        assert np.isfinite(float(res.reward))
        assert res.reward_hist.shape == (4,)
        assert abs(float(res.t) * 10 - round(float(res.t) * 10)) < 1e-9
        assert np.all(np.isfinite(np.asarray(res.tra_pos)))
