"""Native host-runtime (libfastquad) cross-checks against the NumPy/JAX
implementations — three independent derivations of the same spec."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from learningagileflight_se3 import native
from learningagileflight_se3.config import QuadParams, RewardConfig
from learningagileflight_se3.geometry.collision import (
    collision_score as jx_collision,
    trajectory_reward as jx_reward,
)
from learningagileflight_se3.geometry.gate import gate_from_width, rotate_y
from learningagileflight_se3.oracle.numpy_reference import np_rollout

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain / libfastquad build failed"
)

PQ = QuadParams()


class TestNativePlant:
    def test_rollout_matches_numpy(self, rng):
        x0 = np.zeros(13)
        x0[0:3] = [0.3, -5.0, 0.1]
        x0[6] = 1.0
        U = rng.uniform(0.5, 2.0, size=(30, 4))
        Xn = native.rollout(x0, U, 0.1, PQ)
        Xr = np_rollout(x0, U, 0.1, PQ)
        np.testing.assert_allclose(Xn, Xr, atol=1e-12)

    def test_euler_step(self, rng):
        x = rng.normal(size=13)
        x[6:10] /= np.linalg.norm(x[6:10])
        u = rng.uniform(0, 2.44, size=4)
        from learningagileflight_se3.oracle.numpy_reference import np_euler_step

        np.testing.assert_allclose(
            native.euler_step(x, u, 0.01, PQ), np_euler_step(x, u, 0.01, PQ), atol=1e-13
        )


class TestNativeSampler:
    def test_distribution(self):
        scen = native.sample_scenarios(seed=7, n=5000)
        assert scen.shape == (5000, 9)
        assert scen[:, 0].min() >= -5 and scen[:, 0].max() <= 5
        assert abs(scen[:, 1].mean() + 9.0) < 0.2
        assert scen[:, 7].min() >= 0.5 and scen[:, 7].max() <= 1.25
        min_angle = np.clip(1.3 * (1.2 - scen[:, 7]), 0, np.pi / 3)
        assert np.all(np.abs(scen[:, 8]) >= min_angle - 1e-9)
        assert (scen[:, 8] > 0).mean() > 0.3 and (scen[:, 8] < 0).mean() > 0.3

    def test_deterministic(self):
        a = native.sample_scenarios(seed=3, n=16)
        b = native.sample_scenarios(seed=3, n=16)
        np.testing.assert_array_equal(a, b)


class TestNativeCollision:
    GATE = np.array([[-0.6, 0, 1.0], [0.6, 0, 1.0], [0.6, 0, -1.0], [-0.6, 0, -1.0]])

    def test_matches_jax_random(self, rng):
        for _ in range(30):
            p0 = rng.uniform(-2, 2, 3) + [0, -4, 0]
            p1 = rng.uniform(-2, 2, 3) + [0, 4, 0]
            traj = np.linspace(p0, p1, 25)
            horizon = len(traj) - 1
            got = native.collision_score(self.GATE, traj, horizon)
            want, _ = jx_collision(
                jnp.asarray(self.GATE), jnp.asarray(traj), horizon, 0.2
            )
            np.testing.assert_allclose(got, float(want), atol=1e-10)

    def test_reward_matches_jax(self, rng):
        cfg = RewardConfig()
        H = 12
        x0 = np.zeros(13)
        x0[0:3] = [0.1, -4.0, 0.0]
        x0[6] = 1.0
        U = rng.uniform(1.0, 1.4, size=(H, 4))
        states = np_rollout(x0, U, 0.1, PQ)
        gate = np.asarray(rotate_y(gate_from_width(jnp.asarray(1.0)), jnp.asarray(0.3)))
        goal = np.array([0.0, 4.0, 0.0])
        r_native, col_n, path_n = native.trajectory_reward(states, gate, goal, H)
        r_jax, col_j, path_j, _ = jx_reward(
            jnp.asarray(states), jnp.asarray(gate), jnp.asarray(goal), cfg, H
        )
        np.testing.assert_allclose(r_native, float(r_jax), atol=1e-9)
        np.testing.assert_allclose(col_n, float(col_j), atol=1e-11)
        np.testing.assert_allclose(path_n, float(path_j), atol=1e-10)
