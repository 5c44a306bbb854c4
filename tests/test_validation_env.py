"""Validation-environment tests (the PyBullet-harness role, reference
gym_pybullet_drone/{GateAviary,Pybullet_simulation}.py): independent-plant
physics sanity, state-vector conventions round-tripping through the external
controller, logger output formats, and an end-to-end driver smoke run."""

import os

import numpy as np
import jax
import jax.numpy as jnp
from learningagileflight_se3.config import QuadParams
from learningagileflight_se3.models.mlp import make_dnn2
from learningagileflight_se3.sim.external_controller import euler_rates_to_body
from learningagileflight_se3.sim.validation_env import (
    ValidationEnv,
    ValidationEnvConfig,
    body_rates_to_euler_rates,
    quat_to_rpy,
    rpy_to_quat,
)
from learningagileflight_se3.sim.validation_sim import (
    SimLogger,
    ValidationSimConfig,
    run_validation_sim,
    sample_validation_scenario,
)


class TestPhysics:
    def test_hover_equilibrium(self):
        """Thrust = m*g, zero torque: the plant holds position and attitude."""
        cfg = ValidationEnvConfig()
        env = ValidationEnv(QuadParams(), cfg)
        env.reset([0.0, 0.0, 2.0])
        hover = np.array([QuadParams().mass * cfg.g, 0.0, 0.0, 0.0])
        for _ in range(100):
            env.step(hover)
        assert np.allclose(env.x[0:3], [0.0, 0.0, 2.0], atol=1e-9)
        assert np.allclose(env.x[3:6], 0.0, atol=1e-9)
        assert np.allclose(env.x[6:10], [1, 0, 0, 0], atol=1e-12)

    def test_free_fall(self):
        """Zero thrust: ballistic drop z = z0 - g t^2 / 2 to RK4 accuracy."""
        cfg = ValidationEnvConfig()
        env = ValidationEnv(QuadParams(), cfg)
        env.reset([0.0, 0.0, 10.0])
        for _ in range(50):  # 0.5 s
            env.step(np.zeros(4))
        assert abs(env.x[2] - (10.0 - 0.5 * cfg.g * 0.25)) < 1e-9

    def test_quaternion_stays_normalized(self):
        env = ValidationEnv(QuadParams(), ValidationEnvConfig())
        env.reset([0, 0, 0], (0.1, -0.2, 0.3))
        a = np.array([5.0, 0.02, -0.015, 0.004])
        for _ in range(200):
            env.step(a)
        assert abs(np.linalg.norm(env.x[6:10]) - 1.0) < 1e-12

    def test_torque_spins_body(self):
        """+z body torque from rest yields omega_z = tau_z t / Jz."""
        p = QuadParams()
        env = ValidationEnv(p, ValidationEnvConfig(clip_actions=False))
        env.reset([0, 0, 0])
        tau_z = 0.002
        for _ in range(100):  # 1 s
            env.step([p.mass * 9.8, 0.0, 0.0, tau_z])
        assert abs(env.x[12] - tau_z * 1.0 / p.Jz) < 1e-6

    def test_action_clipping(self):
        cfg = ValidationEnvConfig()
        env = ValidationEnv(QuadParams(), cfg)
        env.reset([0, 0, 0])
        obs = env.step([1e9, 1e9, -1e9, 1e9])
        # vertical acceleration bounded by (t2w - 1) g
        assert env.x[5] <= (cfg.thrust2weight - 1.0) * cfg.g * cfg.dt * 1.01
        assert obs.shape == (20,)


class TestConventions:
    def test_rpy_quat_roundtrip(self):
        rpy = np.array([0.3, -0.4, 1.1])
        assert np.allclose(quat_to_rpy(rpy_to_quat(rpy)), rpy, atol=1e-12)

    def test_euler_rate_roundtrip_through_controller(self):
        """Env d_rpy -> controller euler_rates_to_body recovers omega_B
        exactly (the Yixiao_ctrl_wrapper.py:176-184 contract)."""
        rpy = np.array([0.2, -0.5, 0.9])
        omega = np.array([0.7, -1.3, 0.4])
        d_rpy = body_rates_to_euler_rates(omega, rpy)
        assert np.allclose(euler_rates_to_body(d_rpy, rpy), omega, atol=1e-12)

    def test_state20_layout(self):
        env = ValidationEnv(QuadParams(), ValidationEnvConfig())
        obs = env.reset([1.0, 2.0, 3.0], (0.0, 0.0, 0.5))
        assert np.allclose(obs[0:3], [1, 2, 3])
        # xyzw quaternion order (PyBullet), yaw 0.5
        q_wxyz = obs[[6, 3, 4, 5]]
        assert np.allclose(quat_to_rpy(q_wxyz), [0, 0, 0.5], atol=1e-12)
        assert np.allclose(obs[7:10], [0, 0, 0.5], atol=1e-12)


class TestLogger:
    def test_save_npy_and_csv(self, tmp_path):
        log = SimLogger()
        for i in range(5):
            log.log(i * 0.01, np.arange(20.0), np.ones(4) * i, extra=2.5)
        log.save(str(tmp_path))
        log.save_as_csv(str(tmp_path))
        ts = np.load(tmp_path / "validation_timestamps.npy")
        st = np.load(tmp_path / "validation_states.npy")
        assert ts.shape == (5,) and st.shape == (5, 16)
        csv = np.loadtxt(tmp_path / "validation.csv", delimiter=",", skiprows=1)
        assert csv.shape == (5, 21)


class TestScenarioSampler:
    def test_ranges(self, rng):
        cfg = ValidationSimConfig()
        for _ in range(50):
            s = sample_validation_scenario(rng, cfg)
            assert cfg.gate_wid_lim[0] <= s["gate_width"] <= cfg.gate_wid_lim[1]
            assert abs(s["yaw"]) <= np.pi / 6
            assert abs(s["gate_pitch"]) <= np.pi / 2
            assert np.all(np.abs(s["start_point"] - [3, cfg.start_p, -0.2])
                          <= cfg.st_p_range + 1e-12)

    def test_replay_reproduces(self, tmp_path, rng):
        cfg = ValidationSimConfig()
        s = sample_validation_scenario(rng, cfg)
        np.savez(tmp_path / "last_inputs.npz", **s)
        z = np.load(tmp_path / "last_inputs.npz")
        assert np.allclose(z["start_point"], s["start_point"])
        assert float(z["gate_width"]) == s["gate_width"]


class TestEndToEnd:
    def test_driver_smoke(self, tmp_path):
        """Full run_simulation-equivalent wiring on a short clip: runs, logs,
        writes artifacts, reports metrics, and the replay path reproduces
        the sampled scenario."""
        model2 = make_dnn2()
        params2 = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
        cfg = ValidationSimConfig(duration_sec=0.3)
        out = run_validation_sim(
            model2,
            params2,
            cfg=cfg,
            seed=3,
            output_folder=str(tmp_path),
            save_settings=True,
        )
        assert out["states"].shape == (30, 13)
        assert np.all(np.isfinite(out["states"]))
        assert os.path.exists(tmp_path / "validation.csv")
        assert os.path.exists(tmp_path / "last_inputs.npz")
        assert isinstance(out["through_gate"], bool)
        # replay path
        out2 = run_validation_sim(
            model2,
            params2,
            cfg=cfg,
            seed=99,
            replay_file=str(tmp_path / "last_inputs.npz"),
        )
        assert np.allclose(
            out2["scenario"]["start_point"], out["scenario"]["start_point"]
        )
