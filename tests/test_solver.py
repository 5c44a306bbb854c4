"""Oracle tests for the batched iLQR/DDP MPC solver (SURVEY.md section 4
anchor 1): control sequences must agree with an independent CPU f64 solver on
the same shooting problem (the CasADi/IPOPT stand-in, BASELINE.md)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.core.rotations import axis_angle_to_quat, rodrigues_to_quat
from learningagileflight_se3.costs.gate_costs import total_trajectory_cost
from learningagileflight_se3.dynamics.quadrotor import rollout
from learningagileflight_se3.solver.boxqp import boxqp
from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver, make_mpc_solver

PARAMS = QuadParams()
WEIGHTS = CostWeights()


def canonical_scenario():
    """run_quad defaults (quad_policy.py:16-17): start (0,-8,0), goal (0,8,0),
    gate at origin pitched ~0.6 rad, traversal time 3 s."""
    x0 = np.zeros(13)
    x0[0:3] = [0.0, -8.0, 0.0]
    x0[6:10] = np.asarray(axis_angle_to_quat(jnp.asarray(0.0), jnp.asarray([3.0, 3.0, 5.0])))
    return (
        x0,
        np.zeros(4),
        np.array([0.0, 8.0, 0.0]),
        np.array([0.0, 0.0, 0.0]),
        np.array([0.0, 0.6, 0.0]),
        3.0,
    )


class TestBoxQP:
    def test_unconstrained_matches_solve(self, rng):
        A = rng.normal(size=(4, 4))
        H = A @ A.T + 4 * np.eye(4)
        g = rng.normal(size=4)
        d, free = boxqp(jnp.asarray(H), jnp.asarray(g), -1e3 * jnp.ones(4), 1e3 * jnp.ones(4))
        np.testing.assert_allclose(np.asarray(d), -np.linalg.solve(H, g), atol=1e-8)
        assert np.all(np.asarray(free) == 1.0)

    def test_active_bounds(self):
        H = jnp.eye(4)
        g = jnp.asarray([-10.0, 10.0, 0.5, -0.5])
        lo, hi = -jnp.ones(4), jnp.ones(4)
        d, free = boxqp(H, g, lo, hi)
        np.testing.assert_allclose(np.asarray(d), [1.0, -1.0, -0.5, 0.5], atol=1e-8)
        np.testing.assert_allclose(np.asarray(free), [0.0, 0.0, 1.0, 1.0])

    @pytest.mark.slow
    def test_kkt_random(self, rng):
        for _ in range(10):
            A = rng.normal(size=(4, 4))
            H = A @ A.T + 0.5 * np.eye(4)
            g = rng.normal(size=4) * 3
            lo, hi = -0.3 * np.ones(4), 0.8 * np.ones(4)
            d, _ = boxqp(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi))
            d = np.asarray(d)
            grad = g + H @ d
            # projected-gradient KKT residual
            pg = np.where((d <= lo + 1e-9) & (grad > 0), 0.0, grad)
            pg = np.where((d >= hi - 1e-9) & (pg < 0), 0.0, pg)
            assert np.abs(pg).max() < 1e-6


class TestSolverVsOracle:
    # NOTE: the historical warm-started L-BFS-B stationarity checks
    # (oracle seeded with U_init=sol.control_traj) were superseded in round
    # 3 by genuinely COLD-start independent verification against the lifted
    # multiple-shooting NLP oracle — see tests/test_oracle_lifted.py
    # (both solvers start from the reference's midpoint init,
    # quad_OC.py:142; measured control MAE ~1e-8).

    @pytest.mark.slow
    def test_controls_within_bounds(self):
        cfg = SolverConfig(horizon=20, max_iters=100)
        x0, u_last, goal, tra_pos, tra_ang, t = canonical_scenario()
        solve = jax.jit(make_mpc_solver(PARAMS, WEIGHTS, cfg))
        sol = solve(
            jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
            jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(1.5),
        )
        U = np.asarray(sol.control_traj)
        assert U.min() >= cfg.u_lb - 1e-12
        assert U.max() <= cfg.u_ub + 1e-12

    @pytest.mark.slow
    def test_solution_cost_consistent_with_rollout(self):
        """Reported cost equals the independently-evaluated objective."""
        cfg = SolverConfig(horizon=20, max_iters=100)
        x0, u_last, goal, tra_pos, tra_ang, t = canonical_scenario()
        solve = jax.jit(make_mpc_solver(PARAMS, WEIGHTS, cfg))
        sol = solve(
            jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
            jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(1.5),
        )
        X = rollout(jnp.asarray(x0), sol.control_traj, cfg.dt, PARAMS)
        np.testing.assert_allclose(np.asarray(X), np.asarray(sol.state_traj), atol=1e-9)
        tq = rodrigues_to_quat(jnp.asarray(tra_ang))
        c = total_trajectory_cost(
            X, sol.control_traj, jnp.asarray(u_last), cfg.dt, 1.5,
            jnp.asarray(goal), jnp.asarray(tra_pos), tq, WEIGHTS,
        )
        np.testing.assert_allclose(float(sol.cost), float(c), rtol=1e-9)

    @pytest.mark.slow
    def test_quantize_t(self):
        """t rounding to 0.1 (quad_policy.py:70): 1.4700001 and 1.5 solve the
        same problem when quantize_t=True."""
        cfg = SolverConfig(horizon=10, max_iters=60)
        x0, u_last, goal, tra_pos, tra_ang, _ = canonical_scenario()
        solve = jax.jit(make_mpc_solver(PARAMS, WEIGHTS, cfg))
        a = solve(jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
                  jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(1.4700001))
        b = solve(jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
                  jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(1.5))
        np.testing.assert_allclose(
            np.asarray(a.control_traj), np.asarray(b.control_traj), atol=1e-12
        )


class TestBatchedSolver:
    def test_tile_pad_row0_equals_batch1(self, rng):
        """Lanes are independent: row 0 of an 8-wide batch of copies of one
        query is the batch-1 answer (VERDICT r1 weak #7 regression guard).  Equality
        is asserted in the converged regime: different batch shapes change
        XLA's fp reassociation, which chaotic unconverged iterates amplify."""
        cfg = SolverConfig(horizon=10, max_iters=80)
        x0 = np.zeros(13)
        x0[0:3] = [0.3, -8.0, 0.2]
        x0[6] = 1.0
        args1 = (
            jnp.asarray(x0)[None], jnp.zeros((1, 4)),
            jnp.asarray([[0.1, 6.0, -0.2]]), jnp.zeros((1, 3)),
            jnp.asarray([[0.0, 0.2, 0.0]]), jnp.asarray([2.0]),
        )
        args8 = tuple(jnp.tile(a, (8,) + (1,) * (a.ndim - 1)) for a in args1)
        bsolve = jax.jit(make_batched_mpc_solver(PARAMS, WEIGHTS, cfg))
        s1 = bsolve(*args1)
        s8 = bsolve(*args8)
        assert bool(s1.converged[0]) and bool(s8.converged[0])
        np.testing.assert_allclose(
            np.asarray(s8.control_traj[0]), np.asarray(s1.control_traj[0]),
            atol=1e-7,
        )
        # replicated rows are independent vmap lanes on identical data:
        # bitwise identical to each other
        np.testing.assert_array_equal(
            np.asarray(s8.control_traj).min(axis=0),
            np.asarray(s8.control_traj).max(axis=0),
        )

    @pytest.mark.slow
    def test_batched_matches_single(self, rng):
        # scenarios chosen so every lane converges: on unconverged stiff
        # problems, vmapped vs single fp reassociation may amplify over
        # many iterations, which is not a control-flow discrepancy
        cfg = SolverConfig(horizon=10, max_iters=100)
        B = 3
        x0 = np.zeros((B, 13))
        x0[:, 0:3] = rng.uniform(-1, 1, size=(B, 3)) + [0, -8, 0]
        x0[:, 6] = 1.0
        u_last = np.zeros((B, 4))
        goal = rng.uniform(-1, 1, size=(B, 3)) + [0, 6, 0]
        tra_pos = rng.uniform(-0.3, 0.3, size=(B, 3))
        tra_ang = rng.normal(size=(B, 3)) * 0.2
        t = np.array([2.0, 2.3, 1.8])

        bsolve = jax.jit(make_batched_mpc_solver(PARAMS, WEIGHTS, cfg))
        bsol = bsolve(
            jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
            jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(t),
        )
        ssolve = jax.jit(make_mpc_solver(PARAMS, WEIGHTS, cfg, return_gains=False))
        for i in range(B):
            si = ssolve(
                jnp.asarray(x0[i]), jnp.asarray(u_last[i]), jnp.asarray(goal[i]),
                jnp.asarray(tra_pos[i]), jnp.asarray(tra_ang[i]), jnp.asarray(t[i]),
            )
            assert bool(si.converged), f"lane {i} did not converge"
            # batched while_loop runs the union of iterations; finished lanes
            # are strict no-ops, so converged results agree to fp noise
            np.testing.assert_allclose(
                np.asarray(bsol.control_traj[i]),
                np.asarray(si.control_traj),
                atol=1e-9,
            )


class TestProgressWindowTermination:
    """r4 no-progress floor (SolverConfig.no_progress_iters): a lane whose
    last W iterations made < tol cumulative cost progress terminates.  The
    floor exists for f32 deployment (warm 10 Hz replans at the f32
    resolution floor never pass the KKT gates); these tests pin its two
    contracts in a controlled f32-on-CPU setting."""

    def _cfg(self, **kw):
        base = dict(horizon=8, max_iters=60, tol=1e-4,
                    # KKT gates disabled so the WINDOW is the only
                    # convergence mechanism under test
                    gtol=1e-12, stall_gtol=1e-13)
        base.update(kw)
        return SolverConfig(**base)

    def _args32(self):
        x0, u_last, goal, tra_pos, tra_ang, t = canonical_scenario()
        f = jnp.float32
        return (jnp.asarray(x0, f), jnp.asarray(u_last, f),
                jnp.asarray(goal, f), jnp.asarray(tra_pos, f),
                jnp.asarray(tra_ang, f), jnp.asarray(t, f))

    def test_warm_restart_at_optimum_exits_fast(self):
        """A warm restart from an already-solved iterate makes no further
        progress at f32 — the window must terminate it in ~W iterations
        with the solution unchanged (this is exactly the deployed warm
        10 Hz tick; without the floor it burns the full cap)."""
        args = self._args32()
        W = 4
        solve = jax.jit(make_mpc_solver(
            PARAMS, WEIGHTS, self._cfg(no_progress_iters=W)))
        cold = solve(*args)
        warm = solve(*args, U_init=cold.control_traj)
        assert bool(warm.converged)
        assert int(warm.iterations) <= W + 3
        assert float(warm.cost) <= float(cold.cost) * (1 + 1e-5)

    def test_window_does_not_cut_descent(self):
        """With the window enabled, a COLD solve must reach (numerically)
        the same cost as the run-to-cap solve — the window may only cut
        iterations whose whole span was flat."""
        args = self._args32()
        s_cap = jax.jit(make_mpc_solver(
            PARAMS, WEIGHTS, self._cfg(no_progress_iters=0)))(*args)
        s_win = jax.jit(make_mpc_solver(
            PARAMS, WEIGHTS, self._cfg(no_progress_iters=10)))(*args)
        rel = abs(float(s_win.cost) - float(s_cap.cost)) / (
            abs(float(s_cap.cost)) + 1.0)
        assert rel < 1e-3, f"window changed the solution: rel {rel}"
        assert int(s_win.iterations) <= int(s_cap.iterations)

    def test_disabled_by_default(self):
        """no_progress_iters defaults to 0 (OFF): the f64 oracle-accuracy
        path keeps run-to-tolerance semantics."""
        assert SolverConfig().no_progress_iters == 0


class TestExitStatus:
    """MPCSolution.status: the per-lane exit taxonomy driving the bench's
    certified-tier rescue pass — status 1 must be a TRUE KKT certificate
    (stationary: decrement + projected gradient), and status/converged must
    be mutually consistent."""

    def test_status_consistent_with_converged(self, rng):
        x0, u_last, goal, tra_pos, tra_ang, t = canonical_scenario()
        B = 8
        cfg = SolverConfig(horizon=20, max_iters=60, tol=1e-9, gtol=1e-7)
        solve = jax.jit(make_batched_mpc_solver(PARAMS, WEIGHTS, cfg))
        jit = np.tile
        sol = solve(
            jit(x0, (B, 1)) + 0.01 * rng.normal(size=(B, 13)),
            jit(u_last, (B, 1)), jit(goal, (B, 1)), jit(tra_pos, (B, 1)),
            jit(tra_ang, (B, 1)), np.full(B, t),
        )
        status = np.asarray(sol.status)
        conv = np.asarray(sol.converged)
        # every terminal exit (status != 0) must set converged and vice versa
        np.testing.assert_array_equal(status != 0, conv)
        # a KKT certificate means a genuinely small projected gradient
        kkt = status == 1
        assert kkt.any(), "no lane reached stationarity at f64 tolerances"
        rel_pg = np.asarray(sol.grad_norm) / (np.abs(np.asarray(sol.cost)) + 1.0)
        assert np.all(rel_pg[kkt] <= cfg.gtol * 1.01)

    def test_cap_exit_is_status_zero(self):
        x0, u_last, goal, tra_pos, tra_ang, t = canonical_scenario()
        cfg = SolverConfig(horizon=20, max_iters=2, tol=1e-12, gtol=1e-12)
        solve = jax.jit(make_mpc_solver(PARAMS, WEIGHTS, cfg))
        sol = solve(jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
                    jnp.asarray(tra_pos), jnp.asarray(tra_ang),
                    jnp.asarray(t))
        assert int(sol.status) == 0 and not bool(sol.converged)
