"""CPU float64 oracle solver for the gate-traversal MPC (test-only).

Solves the same shooting problem as solver/ilqr.py with an *algorithmically
independent* method: scipy L-BFGS-B (quasi-Newton, box constraints on the
controls) over the flattened control sequence, with objective/gradient from
jax on CPU in float64.  This plays the role of the CasADi/IPOPT oracle of
BASELINE.md (CasADi is not installed in this image): two different optimizers
converging to the same stationary point of the same objective validate the
device solver's control sequences (target MAE < 1e-3, BASELINE.json).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from scipy.optimize import minimize

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.core.rotations import rodrigues_to_quat
from learningagileflight_se3.costs.gate_costs import total_trajectory_cost
from learningagileflight_se3.dynamics.quadrotor import rollout


def solve_shooting_oracle(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
    x0,
    u_last,
    goal_pos,
    tra_pos,
    tra_ang,
    t,
    U_init=None,
    maxiter: int = 2000,
):
    """Returns (X, U, cost, scipy_result). Requires jax x64 enabled (tests do)."""
    H, dt = cfg.horizon, cfg.dt
    if cfg.quantize_t:
        t = round(float(t) * 10.0) / 10.0
    tra_quat = rodrigues_to_quat(jnp.asarray(tra_ang, jnp.float64))
    x0 = jnp.asarray(x0, jnp.float64)
    u_last = jnp.asarray(u_last, jnp.float64)
    goal_pos = jnp.asarray(goal_pos, jnp.float64)
    tra_pos = jnp.asarray(tra_pos, jnp.float64)

    def objective(U_flat):
        U = U_flat.reshape(H, 4)
        X = rollout(x0, U, dt, params)
        c = total_trajectory_cost(
            X, U, u_last, dt, t, goal_pos, tra_pos, tra_quat, weights
        )
        if cfg.w_bound_weight > 0.0:
            # mirror the solver's soft omega-box penalty (_stage_cost:
            # stages x_0..x_{H-1}, quadratic hinge) so both optimize the
            # same objective when the bound is enabled
            viol = jnp.maximum(jnp.abs(X[:-1, 10:13]) - cfg.w_bound, 0.0)
            c = c + cfg.w_bound_weight * jnp.sum(viol**2)
        return c

    # test-only module: callers run under the CPU platform (tests/conftest.py)
    vg = jax.jit(jax.value_and_grad(objective))

    def fun(U_flat):
        v, g = vg(jnp.asarray(U_flat, jnp.float64))
        return float(v), np.asarray(g, dtype=np.float64)

    if U_init is None:
        U0 = np.full((H, 4), 0.5 * (cfg.u_lb + cfg.u_ub))
    else:
        U0 = np.asarray(U_init, dtype=np.float64)

    res = minimize(
        fun,
        U0.ravel(),
        jac=True,
        method="L-BFGS-B",
        bounds=[(cfg.u_lb, cfg.u_ub)] * (H * 4),
        options={"maxiter": maxiter, "ftol": 1e-16, "gtol": 1e-12, "maxcor": 30},
    )
    U = res.x.reshape(H, 4)
    X = np.asarray(rollout(jnp.asarray(x0), jnp.asarray(U), dt, params))
    return X, U, float(res.fun), res
