"""Assemble the shipped artifacts/ from the r4 training runs.

Stages 1-2 come from the seed-1 analytic pipeline run; stage 3 from the
600-epoch imitation retrain (imitation-data seed 3, selected by held-out
success over 4 seeds — see artifacts/README.md).  This script copies the
checkpoints + curves and REGENERATES everything downstream of the shipped
weights so no committed number mixes models: the 64-scenario train-protocol
eval for summary.json and the 8 flight logs + plots of scenario 0.

Usage: python scripts/refresh_artifacts.py \
          --stage12 runs/r4ship --stage3 runs/r4imi600
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage12", default="runs/r4ship")
    ap.add_argument("--stage3", default="runs/r4imi600")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--eval-scenarios", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, SolverConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn2
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.sim import plotting
    from learningagileflight_se3.sim.closed_loop import (
        evaluate_closed_loop_full, make_closed_loop_sim,
    )
    from learningagileflight_se3.utils.checkpoint import load_params

    out = args.out
    # ---- checkpoints + curves ----
    for name in ("nn_pre", "nn_deep"):
        dst = os.path.join(out, name)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(os.path.join(args.stage12, name), dst)
    dst = os.path.join(out, "nn3_1")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(os.path.join(args.stage3, "nn3_1"), dst)
    for f in ("pretrain_loss.npy", "Mean_Reward.npy", "Iteration.npy"):
        shutil.copy(os.path.join(args.stage12, f), os.path.join(out, f))
    shutil.copy(os.path.join(args.stage3, "imitation_loss.npy"),
                os.path.join(out, "imitation_loss.npy"))

    # ---- evaluate the SHIPPED weights under the pipeline's eval protocol ----
    on_cpu = jax.default_backend() == "cpu"
    solver_cfg = SolverConfig(
        horizon=50, max_iters=45,
        tol=1e-9 if on_cpu else 1e-4, gtol=1e-7 if on_cpu else 3e-4,
        no_progress_iters=0 if on_cpu else 10,
    )
    model2 = make_dnn2()
    like = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    p2 = load_params(os.path.join(out, "nn3_1"), like=like)

    # same key chain as train_pipeline.py: the eval keys are drawn after
    # four splits (k1 pretrain, ke pretrain-eval, k2 rl, k3 imitation)
    # from PRNGKey(seed)
    key = jax.random.PRNGKey(args.seed)
    for _ in range(4):
        key, _ = jax.random.split(key)
    key, ks, kg = jax.random.split(key, 3)
    n_eval = args.eval_scenarios
    scens = sample_scenarios(ks, n_eval)
    gate_keys = jax.random.split(kg, n_eval)

    sim = make_closed_loop_sim(model2, QuadParams(), CostWeights(), solver_cfg,
                               steps=500)

    def eval_one(s, k):
        trace = sim(p2, s, k)
        return trace, evaluate_closed_loop_full(trace, s[3:6])

    t0 = time.time()
    logs, m = jax.jit(jax.vmap(eval_one))(scens, gate_keys)
    trav = np.asarray(m.traversed)
    final_d = np.asarray(m.final_dist)
    print(f"eval {n_eval} sims in {time.time()-t0:.1f}s: "
          f"success {trav.mean():.4f}")

    # ---- flight logs (main.py:117-124) of the first SUCCESSFUL scenario
    # (traversed + reached within 2 m) — the committed showcase flight ----
    good = trav & np.asarray(m.reached_2m) & ~np.asarray(m.diverged)
    show = int(np.argmax(good))
    print(f"showcase flight: scenario {show} (traversed "
          f"{bool(trav[show])}, final_dist {final_d[show]:.3f})")
    log = jax.tree_util.tree_map(lambda x: np.asarray(x[show]), logs)
    fl = os.path.join(out, "flight_logs")
    os.makedirs(fl, exist_ok=True)
    np.save(os.path.join(fl, "gate_move_traj.npy"), log.gate_moves)
    np.save(os.path.join(fl, "uav_traj.npy"), log.states)
    np.save(os.path.join(fl, "uav_ctrl.npy"), log.controls)
    np.save(os.path.join(fl, "abs_tra_time.npy"), log.abs_tra_times)
    np.save(os.path.join(fl, "tra_time.npy"), log.tra_times)
    np.save(os.path.join(fl, "Time.npy"), log.times)
    np.save(os.path.join(fl, "Pitch.npy"), log.pitches)
    np.save(os.path.join(fl, "HL_Variable.npy"), log.hl_variables)
    plotting.plot_position(log.states, dt=0.01,
                           path=os.path.join(fl, "position.png"))
    plotting.plot_input(log.controls, dt=0.01,
                        path=os.path.join(fl, "input.png"))

    # ---- summary.json for the shipped composite ----
    with open(os.path.join(args.stage12, "summary.json")) as f:
        s12 = json.load(f)
    imi = np.load(os.path.join(args.stage3, "imitation_loss.npy"))
    summary = {
        **s12,
        "imitation_loss_last": float(imi[-1]),
        "imitation_epochs": 600,
        "imitation_data_seed": 3,
        "stage3_selection": "imitation-data seed selected by held-out "
                            "bench_success over seeds {pipeline,3,4,5}: "
                            "{0.953, 0.969, 0.945, 0.953}",
        "flight_log_scenario": show,
        "closed_loop_traversed": bool(trav[show]),
        "closed_loop_margin": float(np.asarray(m.margin)[show]),
        "closed_loop_final_dist": float(final_d[show]),
        "closed_loop_success_rate": float(trav.mean()),
        "closed_loop_eval_scenarios": int(n_eval),
        "closed_loop_mean_final_dist": float(final_d.mean()),
        "closed_loop_success_and_reached_2m": float(
            (trav & np.asarray(m.reached_2m) & ~np.asarray(m.diverged)).mean()),
    }
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2)[:800])


if __name__ == "__main__":
    main()
