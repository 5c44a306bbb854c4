"""Gate-traversal optimal-control costs (pure JAX, differentiable in all args).

Reproduces the cost structure assembled by the reference across
quad_model.py:121-213 (initCost / init_TraCost) and quad_OC.py:145-151
(stage assembly inside ocSolver):

  stage_k = 60*exp(-10*(dt*k - t)^2) * tra_cost(x_k)      # Gaussian time window
          + goal_cost(x_k)                                # path cost each step
          + wthrust*|u_k|^2                               # thrust cost
          + |u_k - u_{k-1}|^2                             # control-rate smoothing
  total   = sum_k stage_k + goal_cost(x_H)                # final cost

where
  goal_cost(x) = wrf|r-rg|^2 + wvf|v-vg|^2 + wwf|w|^2 + wqf tr(I - Rg^T R)
  tra_cost(x)  = wrt|r-rt|^2 + wqt (tr(I - Rt^T R))^p,  p=2 main / 1 pybullet

Unlike the reference (which rebuilds CasADi symbolic expressions per tick,
main.py:105), everything here is a plain jitted function of
(x, u, traversal-parameters), so a new traversal pose/time is just new data.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import CostWeights
from learningagileflight_se3.core.rotations import quat_to_dcm_w2b


def attitude_error(q, q_goal):
    """tr(I - R(q_goal)^T R(q)) — the SO(3) geodesic-like error used by the
    reference (quad_model.py:178,210). Both R are world->body DCMs."""
    Rg = quat_to_dcm_w2b(q_goal)
    Rq = quat_to_dcm_w2b(q)
    return 3.0 - jnp.sum(Rg * Rq)  # tr(Rg^T Rq) == <Rg, Rq>_F


def goal_cost(x, goal_pos, w: CostWeights, goal_q=None, goal_vel=None):
    """Path/final goal cost (quad_model.py:190-198). wqf defaults to 0 in the
    reference so goal_q only matters when enabled."""
    r, v, q, om = x[0:3], x[3:6], x[6:10], x[10:13]
    gv = jnp.zeros(3, dtype=x.dtype) if goal_vel is None else goal_vel
    c = (
        w.wrf * jnp.sum((r - goal_pos) ** 2)
        + w.wvf * jnp.sum((v - gv) ** 2)
        + w.wwf * jnp.sum(om**2)
    )
    if w.wqf != 0.0:
        gq = jnp.array([1.0, 0.0, 0.0, 0.0], dtype=x.dtype) if goal_q is None else goal_q
        c = c + w.wqf * attitude_error(q, gq)
    return c


def traversal_cost(x, tra_pos, tra_quat, w: CostWeights):
    """Traversal cost (quad_model.py:200-213). Attitude term squared in the
    main variant (quad_model.py:210), linear in the PyBullet fork."""
    r, q = x[0:3], x[6:10]
    att = attitude_error(q, tra_quat)
    att_term = att**2 if w.squared_attitude else att
    return w.wrt * jnp.sum((r - tra_pos) ** 2) + w.wqt * att_term


def thrust_cost(u, w: CostWeights):
    """wthrust * |u|^2 (quad_model.py:186-188)."""
    return w.wthrust * jnp.sum(u**2)


def traversal_weight(k, dt, t, w: CostWeights):
    """Gaussian time window 60*exp(-10*(dt*k - t)^2) (quad_OC.py:145)."""
    return w.tra_amp * jnp.exp(-w.tra_decay * (dt * k - t) ** 2)


def stage_cost(x, u, u_prev, k, dt, t, goal_pos, tra_pos, tra_quat, w: CostWeights):
    """Full stage cost C_k (quad_OC.py:149-150)."""
    return (
        traversal_weight(k, dt, t, w) * traversal_cost(x, tra_pos, tra_quat, w)
        + goal_cost(x, goal_pos, w)
        + thrust_cost(u, w)
        + w.w_du * jnp.sum((u - u_prev) ** 2)
    )


def final_cost(x, goal_pos, w: CostWeights):
    """Terminal cost == goal cost (quad_OC.py:167; quad_model.py:195-198)."""
    return goal_cost(x, goal_pos, w)


def total_trajectory_cost(X, U, u_last, dt, t, goal_pos, tra_pos, tra_quat, w: CostWeights):
    """Total cost of a trajectory X (H+1,13), U (H,4) with U_{-1}=u_last.

    This is the exact objective IPOPT minimizes in the reference's lifted NLP
    (quad_OC.py:136-167), expressed over the shooting variables.
    """
    H = U.shape[0]
    Uprev = jnp.concatenate([u_last[None], U[:-1]], axis=0)
    ks = jnp.arange(H, dtype=X.dtype)

    def one(k, x, u, up):
        return stage_cost(x, u, up, k, dt, t, goal_pos, tra_pos, tra_quat, w)

    stages = jax.vmap(one)(ks, X[:-1], U, Uprev)
    return jnp.sum(stages) + final_cost(X[H], goal_pos, w)
