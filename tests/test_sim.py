"""Closed-loop sim tests (SURVEY.md section 4 anchor 6): the main.py-equivalent
jitted simulation runs end-to-end, logs have the reference shapes, the
traversal-time fixed point converges, and the plant discretization matches the
NumPy oracle step-for-step."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import (
    CostWeights,
    GateMotionConfig,
    QuadParams,
    SolverConfig,
)
from learningagileflight_se3.geometry.gate import gate_from_width, rotate_y
from learningagileflight_se3.models.mlp import make_dnn2
from learningagileflight_se3.oracle.numpy_reference import np_euler_step
from learningagileflight_se3.sim.closed_loop import make_closed_loop_sim
from learningagileflight_se3.sim.tsolver import make_traversal_time_solver


def _dnn2_with_params(key):
    model2 = make_dnn2()
    params2 = model2.init(key, jnp.zeros((1, 18)))
    return model2, params2


class TestTraversalTimeSolver:
    @pytest.mark.slow
    def test_fixed_point_converges(self):
        model2, params2 = _dnn2_with_params(jax.random.PRNGKey(0))
        tsolve = jax.jit(make_traversal_time_solver(model2, tol=1e-3))
        state = jnp.zeros(13).at[6].set(1.0).at[1].set(-6.0)
        gate_pts = rotate_y(gate_from_width(jnp.asarray(1.0)), jnp.asarray(0.3))
        t = tsolve(params2, state, jnp.asarray([0.0, 6.0, 0.0]), gate_pts,
                   jnp.asarray([1.0, 0.3, 0.4]), jnp.asarray(np.pi / 2))
        assert np.isfinite(float(t))

    def test_fixed_point_property(self):
        """At the returned t, the DNN2 prediction at the predicted gate pose
        is within tol of t (quad_moving.py:45)."""
        from learningagileflight_se3.geometry.gate import (
            rotate_y as ry, translate, window_inputs,
        )

        model2, params2 = _dnn2_with_params(jax.random.PRNGKey(1))
        tol = 1e-3
        tsolve = jax.jit(make_traversal_time_solver(model2, tol=tol))
        state = jnp.zeros(13).at[6].set(1.0).at[1].set(-5.0)
        final = jnp.asarray([0.0, 6.0, 0.0])
        gate_pts = gate_from_width(jnp.asarray(1.0))
        velo = jnp.asarray([0.5, 0.2, 0.1])
        w = jnp.asarray(1.0)
        t1 = tsolve(params2, state, final, gate_pts, velo, w)
        pts = ry(translate(gate_pts, velo * t1), w * t1)
        t2 = model2.apply(params2, window_inputs(pts, state, final))[6]
        assert abs(float(t2) - float(t1)) <= tol + 1e-9

    def test_secant_matches_reference_fixed_point(self):
        """accel='secant' (the deployed 10 Hz tick path) must satisfy the
        SAME fixed-point property |DNN2_t(t) - t| <= tol as the reference's
        averaging iteration, and land at (numerically) the same point."""
        from learningagileflight_se3.geometry.gate import (
            rotate_y as ry, translate, window_inputs,
        )

        model2, params2 = _dnn2_with_params(jax.random.PRNGKey(1))
        tol = 1e-3
        t_ref = jax.jit(make_traversal_time_solver(model2, tol=tol))
        t_sec = jax.jit(make_traversal_time_solver(model2, tol=tol,
                                                   accel="secant"))
        state = jnp.zeros(13).at[6].set(1.0).at[1].set(-5.0)
        final = jnp.asarray([0.0, 6.0, 0.0])
        gate_pts = gate_from_width(jnp.asarray(1.0))
        velo = jnp.asarray([0.5, 0.2, 0.1])
        w = jnp.asarray(1.0)
        ta = t_ref(params2, state, final, gate_pts, velo, w)
        tb = t_sec(params2, state, final, gate_pts, velo, w)
        pts = ry(translate(gate_pts, velo * tb), w * tb)
        t2 = model2.apply(params2, window_inputs(pts, state, final))[6]
        assert abs(float(t2) - float(tb)) <= tol + 1e-9
        # both iterations approximate the same contraction fixed point
        assert abs(float(ta) - float(tb)) <= 10 * tol


class TestClosedLoop:
    @pytest.mark.slow
    def test_short_sim_runs(self):
        model2, params2 = _dnn2_with_params(jax.random.PRNGKey(2))
        cfg = SolverConfig(horizon=10, max_iters=15)
        sim = jax.jit(
            make_closed_loop_sim(
                model2,
                solver_cfg=cfg,
                steps=40,
                control_every=10,
            )
        )
        scen = jnp.asarray([0.0, -8.0, 0.0, 0.0, 6.0, 0.0, 0.05, 1.0, 0.4])
        log = sim(params2, scen, jax.random.PRNGKey(3))
        assert log.states.shape == (41, 13)
        assert log.controls.shape == (41, 4)
        assert log.hl_variables.shape == (41, 7)
        assert log.gate_moves.shape == (41, 4, 3)
        assert np.all(np.isfinite(np.asarray(log.states)))
        # MPC ran only on replanning steps
        iters = np.asarray(log.solver_iters)
        assert (iters[0] > 0) and np.all(iters[1:10] == 0) and (iters[10] > 0)
        # controls within bounds
        U = np.asarray(log.controls)
        assert U.min() >= cfg.u_lb - 1e-9 and U.max() <= cfg.u_ub + 1e-9

    def test_plant_matches_numpy_oracle(self):
        """With renorm_plant=False the 100 Hz plant is the reference dyn_fn
        Euler step exactly (main.py:108); the default (renorm_plant=True)
        plant is the same step followed by quaternion renormalization."""
        model2, params2 = _dnn2_with_params(jax.random.PRNGKey(4))
        cfg = SolverConfig(horizon=8, max_iters=10)
        scen = jnp.asarray([0.5, -7.0, 0.2, 0.0, 6.0, 0.0, 0.0, 1.1, 0.3])
        p = QuadParams()

        sim = jax.jit(
            make_closed_loop_sim(model2, solver_cfg=cfg, steps=15,
                                 control_every=10, renorm_plant=False)
        )
        log = sim(params2, scen, jax.random.PRNGKey(5))
        states = np.asarray(log.states)
        controls = np.asarray(log.controls)
        for i in range(15):
            expected = np_euler_step(states[i], controls[i + 1], 0.01, p)
            np.testing.assert_allclose(states[i + 1], expected, atol=1e-8)

        sim_rn = jax.jit(
            make_closed_loop_sim(model2, solver_cfg=cfg, steps=15,
                                 control_every=10, renorm_plant=True)
        )
        log_rn = sim_rn(params2, scen, jax.random.PRNGKey(5))
        states_rn = np.asarray(log_rn.states)
        controls_rn = np.asarray(log_rn.controls)
        for i in range(15):
            expected = np_euler_step(states_rn[i], controls_rn[i + 1], 0.01, p)
            q = expected[6:10] / np.linalg.norm(expected[6:10])
            expected = np.concatenate([expected[0:6], q, expected[10:13]])
            np.testing.assert_allclose(states_rn[i + 1], expected, atol=1e-8)
        np.testing.assert_allclose(
            np.linalg.norm(states_rn[1:, 6:10], axis=1), 1.0, atol=1e-12
        )


class TestExternalController:
    @pytest.mark.slow
    def test_compute_control_loop(self):
        """ExternalSimController drives the native f64 plant for a few
        control periods (the PyBullet-harness role) and produces in-range
        thrust/torque commands."""
        from scipy.spatial.transform import Rotation as R

        from learningagileflight_se3.geometry.gate import gate_from_width, rotate_y as ry
        from learningagileflight_se3.sim.external_controller import ExternalSimController

        model2, params2 = _dnn2_with_params(jax.random.PRNGKey(7))
        gate0 = np.asarray(ry(gate_from_width(jnp.asarray(1.0)), jnp.asarray(0.3)))
        velo = np.array([0.5, 0.2, 0.1])

        def gate_motion(step):
            pts = np.asarray(ry(jnp.asarray(gate0) + 0.01 * step * velo, jnp.asarray(0.0)))
            return pts, velo

        cfg = SolverConfig(horizon=8, max_iters=10)
        ctrl = ExternalSimController(
            model2, params2, final_point=[0.0, 6.0, 0.0],
            gate_motion=gate_motion, w_rot=np.pi / 2, solver_cfg=cfg,
        )
        # drive a plain world-frame state forward with the JAX plant
        from learningagileflight_se3.dynamics.quadrotor import euler_step

        state = np.zeros(13)
        state[0:3] = [0.0, -6.0, 0.0]
        state[6] = 1.0
        p = QuadParams()
        for step in range(3):
            quat_wxyz = state[6:10] / np.linalg.norm(state[6:10])
            quat_xyzw = quat_wxyz[[1, 2, 3, 0]]
            rpy = R.from_quat(quat_xyzw).as_euler("xyz")
            cmd, t = ctrl.compute_control(
                step, state[0:3], quat_xyzw, state[3:6],
                cur_euler_rates=np.zeros(3), cur_rpy=rpy,
            )
            assert cmd.shape == (4,)
            assert np.isfinite(cmd).all() and np.isfinite(t)
            # total thrust within 4x rotor bound
            assert 0.0 <= cmd[0] <= 4 * ctrl.solver_cfg.u_ub + 1e-9
            u = ctrl.u
            state = np.asarray(euler_step(jnp.asarray(state), jnp.asarray(u), 0.1, p))

    def test_euler_rates_identity_at_zero(self):
        from learningagileflight_se3.sim.external_controller import euler_rates_to_body

        out = euler_rates_to_body([0.1, -0.2, 0.3], [0.0, 0.0, 0.0])
        np.testing.assert_allclose(out, [0.1, -0.2, 0.3], atol=1e-12)


class TestPlotting:
    def test_plots_and_positions(self, tmp_path):
        from learningagileflight_se3.sim import plotting

        T = 20
        states = np.zeros((T, 13))
        states[:, 6] = 1.0
        states[:, 1] = np.linspace(-3, 3, T)
        controls = np.random.default_rng(0).uniform(0, 2, (T, 4))
        pos = plotting.quadrotor_positions(states, 1.5)
        assert pos.shape == (T, 15)
        a = 1.5 * 0.5 / np.sqrt(2)
        np.testing.assert_allclose(pos[0, 3:6], states[0, 0:3] + [a, a, 0], atol=1e-12)
        assert plotting.plot_position(states, path=str(tmp_path / "p.png"))
        assert plotting.plot_input(controls, path=str(tmp_path / "u.png"))


class TestGateEstimator:
    def test_kf_tracks_moving_gate(self):
        """The Kalman filter converges to the true gate velocity and pitch
        rate from pose observations alone, across atan pitch wraps — the
        capability the reference's dead `kalman` (quad_moving.py:8-27) was
        meant to provide."""
        from learningagileflight_se3.geometry.gate import gate_move
        from learningagileflight_se3.sim.estimator import (
            estimated_velocity,
            gate_observation,
            kalman_init,
            make_kalman_step,
        )

        w = float(np.pi / 2)
        velo = jnp.asarray([1.0, 0.3, 0.4])
        pts0 = rotate_y(gate_from_width(jnp.asarray(1.0)), jnp.asarray(0.4))
        moves, V = gate_move(
            pts0, jax.random.PRNGKey(0), velo, w, T=5.0, dt=0.01,
            noise_std=0.05, noise_clip=0.05,
        )
        kstep = make_kalman_step(dt=0.01)
        obs = jax.vmap(gate_observation)(moves)
        ks = kalman_init(obs[0], dtype=jnp.float64)

        def body(ks, o):
            ks = kstep(ks, o)
            v, wr = estimated_velocity(ks)
            return ks, (v, wr)

        _, (v_est, w_est) = jax.lax.scan(body, ks, obs.astype(jnp.float64))
        # after burn-in the velocity estimate tracks the (noisy) truth
        v_err = np.linalg.norm(
            np.asarray(v_est[100:]) - np.asarray(V[100 : v_est.shape[0]]), axis=1
        )
        assert np.median(v_err) < 0.15, np.median(v_err)
        w_err = np.abs(np.asarray(w_est[100:]) - w)
        assert np.median(w_err) < 0.1, np.median(w_err)
        # rotation passes a pitch wrap within 5 s at pi/2 rad/s from 0.4
        assert float(0.4 + w * 5.0) > np.pi / 2

    @pytest.mark.slow
    def test_closed_loop_with_estimator(self):
        """estimate_gate_motion=True runs end-to-end and the velocity fed to
        the planner converges toward the true gate velocity."""
        model2, params2 = _dnn2_with_params(jax.random.PRNGKey(2))
        cfg = SolverConfig(horizon=8, max_iters=8)
        sim = jax.jit(
            make_closed_loop_sim(
                model2, solver_cfg=cfg, steps=120, control_every=10,
                estimate_gate_motion=True, gate_obs_noise=0.002,
            )
        )
        scen = jnp.asarray([0.0, -8.0, 0.0, 0.0, 6.0, 0.0, 0.05, 1.0, 0.4])
        log = sim(params2, scen, jax.random.PRNGKey(3))
        assert np.all(np.isfinite(np.asarray(log.states)))
        used = np.asarray(log.gate_vel_used)
        assert used.shape == (120, 4)
        truth = np.asarray(GateMotionConfig().velocity)
        err = np.linalg.norm(used[80:, 0:3] - truth, axis=1)
        assert np.median(err) < 0.5, np.median(err)
        w_err = np.abs(used[80:, 3] - GateMotionConfig().omega_y)
        assert np.median(w_err) < 0.4, np.median(w_err)
