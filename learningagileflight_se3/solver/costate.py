"""Costate (adjoint) trajectory extraction — component #8 of the reference
inventory: `OCSys.ocSolver`'s two costate options (quad_OC.py:185-201).

The reference returns, alongside the optimal trajectory, the multipliers of
the lifted NLP's dynamics constraints:

  * ``costate_option=0`` (default): IPOPT's ``lam_g`` reshaped to (H, 13)
    (quad_OC.py:187-188).  At a KKT point those multipliers satisfy the exact
    discrete adjoint recursion of the FULL stage cost
        lam_{k-1} = dC_k/dx(x_k, u_k) + A_k^T lam_k,   lam_{H-1} = dphi/dx(x_H)
    with A_k = d/dx [x + dt f(x,u)], so we compute them directly by a reverse
    `lax.scan` instead of asking an interior-point solver.

  * ``costate_option=1``: the reference's hand-rolled "PMP" recursion
    (quad_OC.py:189-201), which uses ONLY the goal path-cost gradient
    (``dcx_fun`` is built from ``self.path_cost``) — it omits the
    Gaussian-weighted traversal term.  We reproduce that behaviour exactly
    (quirk preserved) so downstream consumers see identical values.

Both options are one `jax.jacfwd`/`jax.grad` + `lax.scan` — this is a cold
diagnostic path, so plain autodiff (not the closed-form engine) keeps it
simple and obviously correct.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.core.rotations import rodrigues_to_quat
from learningagileflight_se3.costs.gate_costs import (
    final_cost,
    goal_cost,
    traversal_cost,
)
from learningagileflight_se3.dynamics.quadrotor import euler_step


def make_costate_extractor(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
    costate_option: int = 0,
):
    """Build costates(X, U, goal, tra_pos, tra_ang, t) -> (H, 13).

    X is the optimal state trajectory (H+1, 13), U the optimal controls
    (H, 4); `lam[k]` is the multiplier of the constraint
    x_{k+1} = x_k + dt f(x_k, u_k), matching the reference's
    ``costate_traj_opt`` row indexing (quad_OC.py:187-201).
    """
    H = cfg.horizon
    dt = cfg.dt

    def stage_cost_x(x, k_w, goal, tra_pos, tra_quat):
        c = k_w * traversal_cost(x, tra_pos, tra_quat, weights) + goal_cost(
            x, goal, weights
        )
        if cfg.w_bound_weight > 0.0:
            viol = jnp.maximum(jnp.abs(x[10:13]) - cfg.w_bound, 0.0)
            c = c + cfg.w_bound_weight * jnp.sum(viol**2)
        return c

    def path_cost_only_x(x, goal):
        return goal_cost(x, goal, weights)

    def costates(X, U, goal, tra_pos, tra_ang, t):
        dtype = X.dtype
        if cfg.quantize_t:
            t = jnp.round(t * 10.0) / 10.0
        tra_quat = rodrigues_to_quat(jnp.asarray(tra_ang, dtype))
        ks = jnp.arange(H, dtype=dtype)
        t_w = weights.tra_amp * jnp.exp(-weights.tra_decay * (dt * ks - t) ** 2)

        # discrete dynamics Jacobian A_k = I + dt df/dx at (x_k, u_k)
        def A_of(x, u):
            return jax.jacfwd(lambda xx: euler_step(xx, u, dt, params))(x)

        lam_H = jax.grad(lambda xx: final_cost(xx, goal, weights))(X[H])

        if costate_option == 0:
            # exact lam_g: full stage-cost x-gradient in the recursion,
            # evaluated at (x_k, u_k) for k = H-1 .. 1
            def body(lam, inp):
                x_k, u_k, w_k = inp
                lx = jax.grad(stage_cost_x)(x_k, w_k, goal, tra_pos, tra_quat)
                lam_prev = lx + A_of(x_k, u_k).T @ lam
                return lam_prev, lam_prev

            _, lams = jax.lax.scan(
                body, lam_H, (X[1:H], U[1:H], t_w[1:H]), reverse=True
            )
        else:
            # reference PMP variant: ONLY the goal path-cost gradient
            # (quad_OC.py:191-201 builds dcx_fun from self.path_cost)
            def body(lam, inp):
                x_k, u_k = inp
                lx = jax.grad(path_cost_only_x)(x_k, goal)
                lam_prev = lx + A_of(x_k, u_k).T @ lam
                return lam_prev, lam_prev

            _, lams = jax.lax.scan(body, lam_H, (X[1:H], U[1:H]), reverse=True)

        # rows 0..H-2 from the recursion, row H-1 = dphi/dx (quad_OC.py:195)
        return jnp.concatenate([lams, lam_H[None]], axis=0)

    return costates
