"""Unit tests for core rotations + dynamics (SURVEY.md section 4, anchor 2):
cross-checks the JAX implementation against the independent NumPy oracle and
scipy's Rotation, plus analytic-derivative checks vs finite differences."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation as R

from learningagileflight_se3.config import QuadParams
from learningagileflight_se3.core.rotations import (
    axis_angle_to_quat,
    dcm_to_quat,
    omega_matrix,
    quat_mul,
    quat_to_dcm_w2b,
    rodrigues_to_axis_angle,
    rodrigues_to_quat,
    skew,
)
from learningagileflight_se3.dynamics.quadrotor import (
    euler_step,
    mixer_matrix,
    quad_ode,
    rollout,
    rotor_positions,
    thrust_torque,
)
from learningagileflight_se3.oracle.numpy_reference import (
    np_euler_step,
    np_quad_ode,
    np_rollout,
)


def random_quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


class TestRotations:
    def test_dcm_vs_scipy(self, rng):
        """dir_cosine (quad_model.py:637-643) is the w2b DCM: its transpose
        must equal scipy's body->world matrix."""
        for _ in range(20):
            q = random_quat(rng)
            C_B_I = np.asarray(quat_to_dcm_w2b(jnp.asarray(q)))
            # scipy xyzw order, gives body->world
            R_sp = R.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()
            np.testing.assert_allclose(C_B_I.T, R_sp, atol=1e-12)

    def test_quat_mul_vs_scipy(self, rng):
        for _ in range(10):
            p, q = random_quat(rng), random_quat(rng)
            pq = np.asarray(quat_mul(jnp.asarray(p), jnp.asarray(q)))
            sp = (
                R.from_quat([p[1], p[2], p[3], p[0]])
                * R.from_quat([q[1], q[2], q[3], q[0]])
            )
            x, y, z, w = sp.as_quat()
            expected = np.array([w, x, y, z])
            if np.dot(pq, expected) < 0:
                expected = -expected
            np.testing.assert_allclose(pq, expected, atol=1e-12)

    def test_omega_matrix_quaternion_derivative(self, rng):
        """0.5*Omega(w)q == 0.5 * q * [0, w] (Hamilton product)."""
        q = random_quat(rng)
        w = rng.normal(size=3)
        lhs = 0.5 * np.asarray(omega_matrix(jnp.asarray(w)) @ jnp.asarray(q))
        rhs = 0.5 * np.asarray(
            quat_mul(jnp.asarray(q), jnp.concatenate([jnp.zeros(1), jnp.asarray(w)]))
        )
        np.testing.assert_allclose(lhs, rhs, atol=1e-12)

    def test_skew(self, rng):
        a, b = rng.normal(size=3), rng.normal(size=3)
        np.testing.assert_allclose(
            np.asarray(skew(jnp.asarray(a)) @ b), np.cross(a, b), atol=1e-12
        )

    def test_axis_angle_to_quat(self):
        q = np.asarray(axis_angle_to_quat(jnp.asarray(np.pi / 2), jnp.asarray([0.0, 0.0, 1.0])))
        np.testing.assert_allclose(q, [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)], atol=1e-12)

    def test_rodrigues_to_axis_angle_matches_reference_formula(self, rng):
        """Rd2Rp: theta=2*atan(|w|), axis=norm(w+[1e-8,0,0]) (quad_policy.py:10-13)."""
        w = rng.normal(size=3)
        theta, axis = rodrigues_to_axis_angle(jnp.asarray(w))
        assert float(theta) == pytest.approx(2 * np.arctan(np.linalg.norm(w)))
        reg = w + np.array([1e-8, 0, 0])
        np.testing.assert_allclose(np.asarray(axis), reg / np.linalg.norm(reg), atol=1e-12)

    def test_rodrigues_zero_is_identity(self):
        q = np.asarray(rodrigues_to_quat(jnp.zeros(3)))
        np.testing.assert_allclose(q, [1, 0, 0, 0], atol=1e-7)

    def test_dcm_to_quat_roundtrip(self, rng):
        for _ in range(50):
            q = random_quat(rng)
            if q[0] < 0:
                q = -q
            Rm = np.asarray(quat_to_dcm_w2b(jnp.asarray(q))).T  # body->world
            q2 = np.asarray(dcm_to_quat(jnp.asarray(Rm)))
            np.testing.assert_allclose(q2, q, atol=1e-8)


class TestDynamics:
    def test_ode_vs_numpy_oracle(self, rng):
        p = QuadParams()
        for _ in range(20):
            x = rng.normal(size=13)
            x[6:10] /= np.linalg.norm(x[6:10])
            u = rng.uniform(0, 2.44, size=4)
            np.testing.assert_allclose(
                np.asarray(quad_ode(jnp.asarray(x), jnp.asarray(u), p)),
                np_quad_ode(x, u, p),
                atol=1e-12,
            )

    def test_euler_rollout_vs_numpy(self, rng):
        p = QuadParams()
        x0 = np.zeros(13)
        x0[6] = 1.0
        U = rng.uniform(0.8, 1.6, size=(25, 4))
        X = np.asarray(rollout(jnp.asarray(x0), jnp.asarray(U), 0.1, p))
        Xnp = np_rollout(x0, U, 0.1, p)
        np.testing.assert_allclose(X, Xnp, atol=1e-10)

    def test_hover_equilibrium(self):
        """At hover thrust mg/4 per rotor, identity attitude: x_dot == 0."""
        p = QuadParams()
        x = np.zeros(13)
        x[6] = 1.0
        u = np.full(4, p.mass * p.g / 4)
        dx = np.asarray(quad_ode(jnp.asarray(x), jnp.asarray(u), p))
        np.testing.assert_allclose(dx, np.zeros(13), atol=1e-12)

    def test_jacobian_vs_finite_difference(self, rng):
        p = QuadParams()
        x = rng.normal(size=13)
        x[6:10] /= np.linalg.norm(x[6:10])
        u = rng.uniform(0, 2.44, size=4)
        f = lambda xu: quad_ode(xu[:13], xu[13:], p)
        J = np.asarray(jax.jacfwd(f)(jnp.concatenate([jnp.asarray(x), jnp.asarray(u)])))
        eps = 1e-6
        xu = np.concatenate([x, u])
        J_fd = np.zeros_like(J)
        for i in range(17):
            d = np.zeros(17)
            d[i] = eps
            J_fd[:, i] = (
                np.asarray(f(jnp.asarray(xu + d))) - np.asarray(f(jnp.asarray(xu - d)))
            ) / (2 * eps)
        np.testing.assert_allclose(J, J_fd, atol=1e-6)

    def test_mixer(self):
        """u_m rows (quad_model.py:93-98): total thrust, Mx, My, Mz."""
        p = QuadParams()
        u = jnp.asarray([1.0, 2.0, 3.0, 4.0])
        tm = np.asarray(thrust_torque(u, p))
        assert tm[0] == pytest.approx(10.0)
        assert tm[1] == pytest.approx((-2.0 + 4.0) * p.l / 2)
        assert tm[2] == pytest.approx((-1.0 + 3.0) * p.l / 2)
        assert tm[3] == pytest.approx((1.0 - 2.0 + 3.0 - 4.0) * p.c)
        M = np.asarray(mixer_matrix(p))
        np.testing.assert_allclose(M @ np.asarray(u), tm, atol=1e-12)

    def test_rotor_positions_identity_attitude(self):
        x = np.zeros(13)
        x[0:3] = [1.0, 2.0, 3.0]
        x[6] = 1.0
        tips = np.asarray(rotor_positions(jnp.asarray(x), wing_len=1.5))
        a = 1.5 * 0.5 / np.sqrt(2)
        np.testing.assert_allclose(tips[0], [1 + a, 2 + a, 3], atol=1e-12)
        np.testing.assert_allclose(tips[2], [1 - a, 2 - a, 3], atol=1e-12)
