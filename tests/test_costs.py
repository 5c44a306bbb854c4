"""Cost-function cross-check: JAX costs vs the independent NumPy oracle
(two separate derivations of quad_OC.py:136-167)."""

import numpy as np
import jax.numpy as jnp

from learningagileflight_se3.config import CostWeights, QuadParams, Variant, preset
from learningagileflight_se3.core.rotations import rodrigues_to_quat
from learningagileflight_se3.costs.gate_costs import (
    total_trajectory_cost,
    traversal_weight,
)
from learningagileflight_se3.dynamics.quadrotor import rollout
from learningagileflight_se3.oracle.numpy_reference import np_total_cost


def _random_problem(rng, H=12):
    p = QuadParams()
    x0 = np.zeros(13)
    x0[0:3] = [0.5, -8.0, 0.2]
    x0[6] = 1.0
    U = rng.uniform(0.5, 2.0, size=(H, 4))
    X = np.asarray(rollout(jnp.asarray(x0), jnp.asarray(U), 0.1, p))
    return p, X, U


def test_total_cost_vs_numpy_oracle(rng):
    for squared in (True, False):
        w = CostWeights(squared_attitude=squared)
        p, X, U = _random_problem(rng)
        u_last = rng.uniform(0, 2, size=4)
        tra_ang = rng.normal(size=3) * 0.3
        tq = rodrigues_to_quat(jnp.asarray(tra_ang))
        goal = np.array([0.0, 6.0, 0.5])
        tra_pos = np.array([0.0, 0.0, 0.3])
        t = 1.2
        c_jax = float(
            total_trajectory_cost(
                jnp.asarray(X), jnp.asarray(U), jnp.asarray(u_last),
                0.1, t, jnp.asarray(goal), jnp.asarray(tra_pos), tq, w,
            )
        )
        c_np = np_total_cost(X, U, u_last, 0.1, t, goal, tra_pos, np.asarray(tq), w)
        np.testing.assert_allclose(c_jax, c_np, rtol=1e-12)


def test_traversal_weight_formula():
    w = CostWeights()
    # 60*exp(-10*(dt*k - t)^2) at k=30, dt=0.1, t=3 -> peak value 60
    np.testing.assert_allclose(float(traversal_weight(30.0, 0.1, 3.0, w)), 60.0, rtol=1e-12)
    v = float(traversal_weight(0.0, 0.1, 1.0, w))
    np.testing.assert_allclose(v, 60 * np.exp(-10.0), rtol=1e-9)


def test_wqf_zero_ignores_goal_attitude(rng):
    """wqf=0 in training (quad_policy.py:38): goal attitude must not matter."""
    w = CostWeights()
    assert w.wqf == 0.0
    p, X, U = _random_problem(rng)
    goal = jnp.asarray([0.0, 6.0, 0.5])
    tq = rodrigues_to_quat(jnp.zeros(3))
    c = total_trajectory_cost(
        jnp.asarray(X), jnp.asarray(U), jnp.zeros(4), 0.1, 1.0,
        goal, jnp.zeros(3), tq, w,
    )
    assert np.isfinite(float(c))


def test_variant_presets():
    _, w_main, s_main, *_ = preset(Variant.MAIN)
    _, w_pb, s_pb, *_ = preset(Variant.PYBULLET)
    assert w_main.squared_attitude and not w_pb.squared_attitude
    assert s_main.u_ub == 2.44 and s_pb.u_ub == 2.4
