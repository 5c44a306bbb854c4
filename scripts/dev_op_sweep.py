"""DEV: final r4 operating-point sweep — (ls_max_trips, cap, window) against
the TRUE uncapped golden, timed."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.models.sampler import (
    sample_scenarios, scenario_to_problem,
)
from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver


def main():
    print(f"device {jax.devices()[0]}", flush=True)
    params_q, weights = QuadParams(), CostWeights()
    B = 2048
    golden_cfg = SolverConfig(horizon=50, max_iters=150, tol=1e-4, gtol=3e-4,
                              ls_adaptive=False, ls_max_trips=14)

    key = jax.random.PRNGKey(100)
    scen = sample_scenarios(key, B).astype(jnp.float32)
    probs = jax.vmap(scenario_to_problem)(scen)
    x0, goal = probs["x0"], probs["goal_pos"]
    u_last = jnp.zeros((B, 4), jnp.float32)
    tra_pos = jnp.zeros((B, 3), jnp.float32)
    tra_ang = jnp.concatenate(
        [jnp.zeros((B, 1)), scen[:, 8:9] * 0.5, jnp.zeros((B, 1))], axis=1
    ).astype(jnp.float32)
    t = jnp.clip(jnp.linalg.norm(x0[:, 0:3], axis=1) / 4.0, 2.0, 4.0
                 ).astype(jnp.float32)
    args = (x0, u_last, goal, tra_pos, tra_ang, t)

    solve_g = jax.jit(make_batched_mpc_solver(params_q, weights, golden_cfg))
    sg = solve_g(*args)
    Jg = np.asarray(sg.cost)
    print(f"golden done {float(np.asarray(sg.converged).mean()):.4f}")

    for trips, cap, W in ((4, 50, 0), (4, 50, 8), (4, 50, 10), (4, 50, 12),
                          (6, 45, 10), (8, 40, 10), (6, 50, 10)):
        cfg = SolverConfig(horizon=50, max_iters=cap, tol=1e-4, gtol=3e-4,
                           ls_adaptive=True, ls_max_trips=trips,
                           no_progress_iters=W)
        solve = jax.jit(make_batched_mpc_solver(params_q, weights, cfg))
        sol = solve(*args)
        np.asarray(sol.cost)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sol = solve(*args)
            np.asarray(sol.cost)
            times.append(time.perf_counter() - t0)
        J = np.asarray(sol.cost)
        ex = (J - Jg) / np.maximum(np.abs(Jg), 1e-6)
        el = float(np.median(times))
        print(f"trips{trips} cap{cap} W{W:2d}: {el:.3f}s ({B/el:6.0f} sps) "
              f"conv {float(np.asarray(sol.converged).mean()):.3f} "
              f"iters {float(np.asarray(sol.iterations).mean()):4.1f} "
              f"ex med {np.median(ex):.1e} q90 {np.percentile(ex,90):.1e} "
              f"q99 {np.percentile(ex,99):.1e} "
              f"f<1e-3 {(ex<1e-3).mean():.3f} f<1% {(ex<0.01).mean():.3f}",
              flush=True)


if __name__ == "__main__":
    main()
