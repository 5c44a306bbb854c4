"""Stage-3 ablation: which imitation frame makes the deployed pipeline fly?

Trains DNN2 from one fixed RL'd DNN1 checkpoint under three label/input
frames and evaluates each in the full closed-loop sim (VERDICT round-1 item
10; reference quirk nn_train_2.py:77 vs main.py:93):

  world              - reference-exercised behavior: world-frame inputs,
                       world-frame labels
  window             - window-frame inputs, world-frame labels (the naive
                       "intended" reading)
  window_consistent  - window-frame inputs AND window-frame labels
                       (traversal pose mapped through gate_frame)

Usage: python scripts/ablate_imitation.py --dnn1 runs/full_window/nn_deep \
           [--epochs 300] [--eval-scenarios 32] [--out runs/ablate_imitation]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dnn1", required=True, help="checkpoint (.npz) of the RL'd DNN1")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch-scenarios", type=int, default=64)
    ap.add_argument("--sgd-passes", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-scenarios", type=int, default=32)
    ap.add_argument("--sim-steps", type=int, default=500)
    ap.add_argument("--max-iters", type=int, default=45)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/ablate_imitation")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--variants", default="world,window,window_consistent")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, SamplerConfig, SolverConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn1
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.sim.closed_loop import (
        evaluate_closed_loop, make_closed_loop_sim,
    )
    from learningagileflight_se3.train.imitation import run_imitation_training
    from learningagileflight_se3.utils.checkpoint import load_params, save_params

    os.makedirs(args.out, exist_ok=True)
    on_cpu = jax.default_backend() == "cpu"
    solver_cfg = SolverConfig(
        horizon=50, max_iters=args.max_iters,
        tol=1e-9 if on_cpu else 1e-4, gtol=1e-7 if on_cpu else 3e-4,
    )
    pq, cw, sc = QuadParams(), CostWeights(), SamplerConfig()

    model1 = make_dnn1()
    like = model1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
    p1 = load_params(args.dnn1, like=like)

    key = jax.random.PRNGKey(args.seed)
    key, ks, kg = jax.random.split(key, 3)
    scens = sample_scenarios(ks, args.eval_scenarios, sc)
    gate_keys = jax.random.split(kg, args.eval_scenarios)

    frames = {
        "world": dict(window_frame=False, consistent_labels=False),
        "window": dict(window_frame=True, consistent_labels=False),
        "window_consistent": dict(window_frame=True, consistent_labels=True),
    }
    results = {}
    for name in args.variants.split(","):
        fr = frames[name]
        t0 = time.time()
        # crc32, not hash(): Python's str hash is salted per process
        # (PYTHONHASHSEED), which would break --seed reproducibility
        key_t = jax.random.fold_in(
            jax.random.PRNGKey(args.seed), zlib.crc32(name.encode()) % 2**30
        )
        model2, p2, losses = run_imitation_training(
            key_t, p1, epochs=args.epochs,
            batch_scenarios=args.batch_scenarios, sgd_passes=args.sgd_passes,
            lr=args.lr, lr_schedule=True,
            params_q=pq, weights=cw, solver_cfg=solver_cfg, sampler_cfg=sc,
            **fr,
        )
        train_s = time.time() - t0

        sim = make_closed_loop_sim(model2, pq, cw, solver_cfg, steps=args.sim_steps)

        def eval_one(s, k):
            trace = sim(p2, s, k)
            return evaluate_closed_loop(trace, s[3:6])

        t0 = time.time()
        travs, margins, fds = jax.jit(jax.vmap(eval_one))(scens, gate_keys)
        travs = np.asarray(travs); margins = np.asarray(margins); fds = np.asarray(fds)
        res = {
            "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]),
            "success_rate": float(travs.astype(bool).mean()),
            "mean_margin": float(margins.mean()),
            "median_final_dist": float(np.median(fds)),
            "mean_final_dist": float(fds.mean()),
            "train_s": train_s,
            "eval_s": time.time() - t0,
        }
        results[name] = res
        save_params(os.path.join(args.out, f"nn3_{name}"), p2)
        print(f"[{name}] {json.dumps(res)}", flush=True)

    meta = {
        "dnn1": args.dnn1, "epochs": args.epochs, "lr": args.lr,
        "batch_scenarios": args.batch_scenarios, "sgd_passes": args.sgd_passes,
        "eval_scenarios": args.eval_scenarios, "platform": jax.default_backend(),
    }
    with open(os.path.join(args.out, "ablation.json"), "w") as f:
        json.dump({"meta": meta, "results": results}, f, indent=2)
    print(json.dumps({"meta": meta, "results": results}))


if __name__ == "__main__":
    main()
