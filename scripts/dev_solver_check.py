"""Dev script: iLQR vs scipy oracle on the canonical static-gate scenario."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from learningagileflight_se3.config import QuadParams, CostWeights, SolverConfig
from learningagileflight_se3.core.rotations import axis_angle_to_quat
from learningagileflight_se3.solver.ilqr import make_mpc_solver
from learningagileflight_se3.oracle.shooting import solve_shooting_oracle

params, weights = QuadParams(), CostWeights()
cfg = SolverConfig(horizon=50, max_iters=300)

# canonical scenario: run_quad defaults (quad_policy.py:16-17)
x0 = np.zeros(13); x0[0:3] = [0, -8, 0]
q0 = np.asarray(axis_angle_to_quat(jnp.asarray(0.0), jnp.asarray([3.0,3.0,5.0])))
x0[6:10] = q0
u_last = np.zeros(4)
goal = np.array([0.0, 8.0, 0.0])
tra_pos = np.array([0.0, 0.0, 0.0])
tra_ang = np.array([0.0, 0.6, 0.0])   # pitched gate attitude
t = 3.0

t0 = time.time()
solve = jax.jit(make_mpc_solver(params, weights, cfg))
sol = solve(jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
            jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(t))
sol.control_traj.block_until_ready()
print(f"iLQR: compile+solve {time.time()-t0:.1f}s  iters={int(sol.iterations)} "
      f"cost={float(sol.cost):.6f} converged={bool(sol.converged)} pg={float(sol.grad_norm):.3e} reg={float(sol.reg_final):.1e}")
t0 = time.time()
sol2 = solve(jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal),
             jnp.asarray(tra_pos), jnp.asarray(tra_ang), jnp.asarray(t))
sol2.control_traj.block_until_ready()
print(f"iLQR warm second call: {time.time()-t0:.2f}s")

t0 = time.time()
X, U, cost, res = solve_shooting_oracle(params, weights, cfg, x0, u_last, goal, tra_pos, tra_ang, t)
print(f"oracle: {time.time()-t0:.1f}s cost={cost:.6f} nit={res.nit} status={res.status}")

mae = np.mean(np.abs(np.asarray(sol.control_traj) - U))
print(f"control MAE = {mae:.2e}   cost diff = {float(sol.cost)-cost:+.3e}")
print("u[0] ilqr ", np.asarray(sol.control_traj)[0])
print("u[0] oracle", U[0])

# --- projected-gradient (KKT) residual check ---
from learningagileflight_se3.costs.gate_costs import total_trajectory_cost
from learningagileflight_se3.dynamics.quadrotor import rollout
from learningagileflight_se3.core.rotations import rodrigues_to_quat

tq = rodrigues_to_quat(jnp.asarray(tra_ang, jnp.float64))
def obj(Uf):
    Xs = rollout(jnp.asarray(x0), Uf.reshape(cfg.horizon,4), cfg.dt, params)
    return total_trajectory_cost(Xs, Uf.reshape(cfg.horizon,4), jnp.asarray(u_last),
                                 cfg.dt, t, jnp.asarray(goal), jnp.asarray(tra_pos), tq, weights)
g_fn = jax.jit(jax.grad(obj))
def pg_norm(U):
    U = np.asarray(U, float).ravel()
    g = np.asarray(g_fn(jnp.asarray(U)))
    pg = np.where((U <= cfg.u_lb + 1e-9) & (g > 0), 0.0, g)
    pg = np.where((U >= cfg.u_ub - 1e-9) & (pg < 0), 0.0, pg)
    return np.abs(pg).max()
print("pg_norm ilqr  ", pg_norm(sol.control_traj))
print("pg_norm oracle", pg_norm(U))

# warm-start oracle from iLQR solution
X2, U2, cost2, res2 = solve_shooting_oracle(params, weights, cfg, x0, u_last, goal,
                                            tra_pos, tra_ang, t,
                                            U_init=np.asarray(sol.control_traj), maxiter=20000)
print(f"warm oracle: cost={cost2:.6f} nit={res2.nit} status={res2.status}")
print("MAE ilqr vs warm oracle:", np.mean(np.abs(np.asarray(sol.control_traj)-U2)))
