"""DEV: retrain ONLY stage 3 (DNN2 imitation) from an existing RL-trained
DNN1, with a bigger budget / different seed — probing whether the analytic
pipeline's held-out-success gap vs fd lives in the imitation stage.

Usage: python scripts/dev_imi_retrain.py --teacher runs/r4full_s1/nn_deep \
         --epochs 600 --seed 3 --tag r4imi600
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--teacher", default="runs/r4full_s1/nn_deep")
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64,
                    help="teacher scenarios per epoch (batch_scenarios)")
    ap.add_argument("--tag", default="r4imi600")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, SamplerConfig, SolverConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn1
    from learningagileflight_se3.train.imitation import run_imitation_training
    from learningagileflight_se3.utils.checkpoint import load_params, save_params

    on_cpu = jax.default_backend() == "cpu"
    solver_cfg = SolverConfig(
        horizon=50, max_iters=45,
        tol=1e-9 if on_cpu else 1e-4, gtol=1e-7 if on_cpu else 3e-4,
        no_progress_iters=0 if on_cpu else 10,
    )
    model1 = make_dnn1()
    like = model1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
    p1_rl = load_params(args.teacher, like=like)

    outdir = os.path.join("runs", args.tag)
    os.makedirs(outdir, exist_ok=True)
    t0 = time.time()
    model2, p2, losses = run_imitation_training(
        jax.random.PRNGKey(args.seed), p1_rl, epochs=args.epochs,
        batch_scenarios=args.batch, sgd_passes=10, lr=1e-3, lr_schedule=True,
        params_q=QuadParams(), weights=CostWeights(), solver_cfg=solver_cfg,
        sampler_cfg=SamplerConfig(), window_frame=True,
    )
    print(f"imitation {args.epochs} epochs in {time.time()-t0:.1f}s: "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    save_params(os.path.join(outdir, "nn3_1"), p2)
    np.save(os.path.join(outdir, "imitation_loss.npy"), np.asarray(losses))
    print(f"saved {outdir}/nn3_1")


if __name__ == "__main__":
    main()
