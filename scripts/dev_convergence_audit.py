"""DEV: audit the bench.py convergence classification (VERDICT r4 task 2).

Round-3 BENCH: converged_frac 0.3955 at mean 45.1/50 iters, yet median cost
excess vs golden 1.1e-7 and 95.4% of lanes within 1% — i.e. most lanes look
optimal but never trip the `done` flag.  This script answers, on the device:

  1. For lanes NOT done at the cap: how far are they actually from the
     (uncapped-golden) optimum, and what are their pg/(|J|+1) and
     decrement/(|J|+1) values?  -> is gtol=3e-4 miscalibrated for f32?
  2. Does DNN1-informed traversal initialization (the committed nn_deep
     checkpoint predicting (tra_pos, tra_ang, t), exactly what the
     reference's RL workers feed the solver, deep_learning.py:51-56) make
     the problems converge faster/better than the hand heuristic?

Usage: python scripts/dev_convergence_audit.py [--batch 2048]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, SolverConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn1
    from learningagileflight_se3.models.sampler import (
        sample_scenarios, scenario_to_problem,
    )
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver
    from learningagileflight_se3.utils.checkpoint import load_params

    print(f"device {jax.devices()[0]}", flush=True)
    params_q, weights = QuadParams(), CostWeights()
    B = args.batch
    bench_cfg = SolverConfig(horizon=50, max_iters=args.iters, tol=1e-4,
                             gtol=3e-4, ls_adaptive=True, ls_max_trips=4,
                             no_progress_iters=10)
    golden_cfg = SolverConfig(horizon=50, max_iters=150, tol=1e-4, gtol=3e-4,
                              ls_adaptive=False, ls_max_trips=14)

    key = jax.random.PRNGKey(100)  # = bench.py rep 0
    scen = sample_scenarios(key, B).astype(jnp.float32)
    probs = jax.vmap(scenario_to_problem)(scen)
    x0 = probs["x0"]
    goal = probs["goal_pos"]
    u_last = jnp.zeros((B, 4), jnp.float32)

    # ---- heuristic traversal params (bench.py r3) ----
    tra_pos_h = jnp.zeros((B, 3), jnp.float32)
    tra_ang_h = jnp.concatenate(
        [jnp.zeros((B, 1)), scen[:, 8:9] * 0.5, jnp.zeros((B, 1))], axis=1
    ).astype(jnp.float32)
    t_h = jnp.clip(jnp.linalg.norm(x0[:, 0:3], axis=1) / 4.0, 2.0, 4.0
                   ).astype(jnp.float32)

    # ---- DNN1-informed traversal params (reference deep_learning.py:51) ----
    model1 = make_dnn1()
    like = model1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
    p1 = load_params("artifacts/nn_deep", like=like)
    out = model1.apply(p1, scen)
    tra_pos_n = out[:, 0:3].astype(jnp.float32)
    tra_ang_n = out[:, 3:6].astype(jnp.float32)
    t_n = out[:, 6].astype(jnp.float32)

    solve_b = jax.jit(make_batched_mpc_solver(params_q, weights, bench_cfg))
    solve_g = jax.jit(make_batched_mpc_solver(params_q, weights, golden_cfg))

    def report(name, tra_pos, tra_ang, t):
        t0 = time.time()
        sb = solve_b(x0, u_last, goal, tra_pos, tra_ang, t)
        np.asarray(sb.cost)
        tb = time.time() - t0
        t0 = time.time()
        sg = solve_g(x0, u_last, goal, tra_pos, tra_ang, t)
        np.asarray(sg.cost)
        tg = time.time() - t0
        Jb, Jg = np.asarray(sb.cost), np.asarray(sg.cost)
        done_b = np.asarray(sb.converged)
        done_g = np.asarray(sg.converged)
        pg = np.asarray(sb.grad_norm)
        itb = np.asarray(sb.iterations)
        excess = (Jb - Jg) / np.maximum(np.abs(Jg), 1e-6)
        pg_rel = pg / (np.abs(Jb) + 1.0)
        nd = ~done_b
        print(f"\n=== {name} ===")
        print(f"bench solve {tb:.2f}s golden {tg:.2f}s")
        print(f"done: bench {done_b.mean():.4f} golden {done_g.mean():.4f} "
              f"iters mean {itb.mean():.1f}")
        print(f"excess: med {np.median(excess):.2e} q90 "
              f"{np.percentile(excess,90):.2e} q99 {np.percentile(excess,99):.2e} "
              f"frac<1e-3 {(excess<1e-3).mean():.4f} frac<1% {(excess<0.01).mean():.4f}")
        if nd.any():
            print(f"NOT-done lanes ({nd.sum()}):")
            print(f"  their excess: med {np.median(excess[nd]):.2e} "
                  f"q90 {np.percentile(excess[nd],90):.2e} "
                  f"frac<1e-3 {(excess[nd]<1e-3).mean():.4f}")
            print(f"  pg_rel: med {np.median(pg_rel[nd]):.2e} "
                  f"q10 {np.percentile(pg_rel[nd],10):.2e} "
                  f"q90 {np.percentile(pg_rel[nd],90):.2e}")
            # what gtol would classify the near-optimal (<1e-3 excess)
            # not-done lanes as converged?
            near = nd & (excess < 1e-3)
            if near.any():
                print(f"  near-optimal not-done ({near.sum()}): pg_rel med "
                      f"{np.median(pg_rel[near]):.2e} q90 "
                      f"{np.percentile(pg_rel[near],90):.2e} "
                      f"max {pg_rel[near].max():.2e}")
            far = nd & (excess >= 1e-3)
            if far.any():
                print(f"  far not-done ({far.sum()}): pg_rel med "
                      f"{np.median(pg_rel[far]):.2e} excess med "
                      f"{np.median(excess[far]):.2e}")
        # golden not-done:
        gd = ~done_g
        if gd.any():
            pgg = np.asarray(sg.grad_norm)
            print(f"golden NOT-done ({gd.sum()}): pg_rel med "
                  f"{np.median((pgg/(np.abs(Jg)+1.0))[gd]):.2e}")
        return sb, sg

    report("heuristic init (bench r3)", tra_pos_h, tra_ang_h, t_h)
    report("DNN1-informed traversal", tra_pos_n, tra_ang_n, t_n)


if __name__ == "__main__":
    main()
