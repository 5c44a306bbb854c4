"""Stage-2 ablation: RL budget / learning-signal study for DNN1.

From one fixed pretrained checkpoint, trains DNN1 under several (grad_mode,
epochs, lr schedule) settings and scores each by OPEN-LOOP policy quality on
a held-out scenario set: mean/median reward, inside-gate fraction, mean
collision penalty (reference reward semantics, quad_policy.py:85-90).

Usage: python scripts/ablate_rl.py --pretrain runs/full_window/nn_pre
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrain", required=True)
    ap.add_argument("--eval-scenarios", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/ablate_rl")
    ap.add_argument("--platform", default=None)
    ap.add_argument(
        "--variants",
        default="fd100,fd400sched,analytic400sched",
        help="comma list of {fd|analytic}{epochs}[sched]",
    )
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, RewardConfig, SamplerConfig, SolverConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn1
    from learningagileflight_se3.models.sampler import (
        sample_scenarios, scenario_to_problem,
    )
    from learningagileflight_se3.policy import make_objective
    from learningagileflight_se3.train.rl import run_rl_training
    from learningagileflight_se3.utils.checkpoint import load_params, save_params

    os.makedirs(args.out, exist_ok=True)
    on_cpu = jax.default_backend() == "cpu"
    solver_cfg = SolverConfig(
        horizon=50, max_iters=45,
        tol=1e-9 if on_cpu else 1e-4, gtol=1e-7 if on_cpu else 3e-4,
    )
    pq, cw, rc, sc = QuadParams(), CostWeights(), RewardConfig(), SamplerConfig()

    model1 = make_dnn1()
    like = model1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
    p0 = load_params(args.pretrain, like=like)

    # held-out open-loop evaluation: reward of the MPC plan under DNN1's
    # decision variables, on scenarios never seen in training
    obj = make_objective(pq, cw, solver_cfg, rc)
    scens = sample_scenarios(jax.random.PRNGKey(args.seed + 991), args.eval_scenarios, sc)
    probs = jax.vmap(scenario_to_problem)(scens)

    @jax.jit
    def score(params):
        outs = model1.apply(params, scens)

        def one(s, x0, goal, gp, out):
            return obj(x0, jnp.zeros(4, s.dtype), goal, gp,
                       out[0:3], out[3:6], out[6])

        return jax.vmap(one)(scens, probs["x0"], probs["goal_pos"],
                             probs["gate_pts"], outs)

    def summarize(params):
        res = score(params)
        r = np.asarray(res.reward)
        return {
            "reward_mean": float(r.mean()),
            "reward_median": float(np.median(r)),
            "reward_min": float(r.min()),
            "inside_gate_frac": float(np.asarray(res.inside_gate).mean()),
            "collision_mean": float(np.asarray(res.collision).mean()),
            "path_mean": float(np.asarray(res.path).mean()),
        }

    results = {"pretrain": summarize(p0)}
    print(f"[pretrain] {json.dumps(results['pretrain'])}", flush=True)

    for name in args.variants.split(","):
        sched = name.endswith("sched")
        base = name[:-5] if sched else name
        mode = "analytic" if base.startswith("analytic") else "fd"
        epochs = int(base.replace(mode, ""))
        t0 = time.time()
        _, p_rl, mrs = run_rl_training(
            jax.random.PRNGKey(args.seed), p0, epochs=epochs,
            batch_size=args.batch, params_q=pq, weights=cw,
            solver_cfg=solver_cfg, reward_cfg=rc, sampler_cfg=sc,
            grad_mode=mode, lr_schedule=sched,
            # resumable: a worker crash mid-run costs <=20 epochs
            checkpoint_dir=os.path.join(args.out, f"state_{name}"),
            checkpoint_every=20, resume=True,
        )
        res = summarize(p_rl)
        res.update(train_s=time.time() - t0,
                   train_reward_last=float(mrs[-1]))
        results[name] = res
        save_params(os.path.join(args.out, f"nn_deep_{name}"), p_rl)
        np.save(os.path.join(args.out, f"curve_{name}.npy"), np.asarray(mrs))
        print(f"[{name}] {json.dumps(res)}", flush=True)

    meta = {"pretrain": args.pretrain, "batch": args.batch,
            "eval_scenarios": args.eval_scenarios,
            "platform": jax.default_backend()}
    with open(os.path.join(args.out, "ablation.json"), "w") as f:
        json.dump({"meta": meta, "results": results}, f, indent=2)
    print(json.dumps({"meta": meta, "results": results}))


if __name__ == "__main__":
    main()
