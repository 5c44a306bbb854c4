"""End-to-end three-stage training pipeline + closed-loop evaluation.

The accelerator equivalent of the reference's run order (README.md:28-35):
  nn_train.py -> deep_learning.py -> nn_train_2.py -> main.py

Usage:
  python scripts/train_pipeline.py                  # mini demo scale
  python scripts/train_pipeline.py --full           # paper-scale budgets
  python scripts/train_pipeline.py --platform cpu   # force CPU
  python scripts/train_pipeline.py --grad analytic  # 1-solve analytic RL signal

Artifacts land in runs/<tag>/: .npz checkpoints for DNN1 (pretrained, RL)
and DNN2, learning curves (.npy, mirroring deep_learning.py:91-93), the 8
closed-loop logs of main.py:117-124, and plots.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# runnable from a plain checkout: scripts/ is not the package root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, help="cpu | gpu (default: JAX's)")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--full", action="store_true", help="paper-scale budgets")
    ap.add_argument("--grad", default="analytic", choices=["fd", "analytic"],
                    help="stage-2 learning signal; default analytic (PDP "
                         "implicit-function gradient) — wins both r3 "
                         "ablations over the reference's FD scheme "
                         "(artifacts/ablate_rl_batched_analytic.json: +11.7 "
                         "vs +8.6 at equal budget)")
    ap.add_argument("--pretrain-steps", type=int, default=None)
    ap.add_argument("--rl-epochs", type=int, default=None)
    ap.add_argument("--rl-batch", type=int, default=None)
    ap.add_argument("--imitation-epochs", type=int, default=None)
    ap.add_argument("--imitation-restarts", type=int, default=None,
                    help="stage-3 restarts; the DNN2 with the best "
                         "closed-loop success on an independent selection "
                         "set ships (default 2 with --full, else 1)")
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--max-iters", type=int, default=45)
    ap.add_argument("--sim-steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-dir", default=None,
                    help="write a TensorBoard/XProf device trace here")
    ap.add_argument("--resume", action="store_true",
                    help="resume stage 2 from runs/<tag>/rl_state if present")
    ap.add_argument("--window-frame", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train DNN2 on window-frame states (the arguably-"
                         "intended variant and the ablation winner, "
                         "runs/ablate_imitation/ablation.json: 90.6%% success; "
                         "--no-window-frame replicates the reference's "
                         "world-frame-training quirk, nn_train_2.py:77)")
    ap.add_argument("--consistent-labels", action="store_true",
                    help="with --window-frame: also map the teacher's "
                         "traversal pose into the window frame (the frame the "
                         "deployed MPC interprets DNN2's output in)")
    ap.add_argument("--imitation-lr", type=float, default=1e-3,
                    help="stage-3 lr (cosine-decayed; the reference's 1e-6 "
                         "needs ~80k sequential steps, see ablate_imitation)")
    ap.add_argument("--rl-sched", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="cosine-decay the stage-2 lr over the run (the "
                         "fd400sched ablation winner, runs/ablate_rl)")
    ap.add_argument("--eval-scenarios", type=int, default=64,
                    help="closed-loop eval scenario count (success rate)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from learningagileflight_se3.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from learningagileflight_se3.config import (
        CostWeights,
        QuadParams,
        RewardConfig,
        SamplerConfig,
        SolverConfig,
    )
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.parallel.mesh import make_mesh
    from learningagileflight_se3.sim.closed_loop import (
        evaluate_closed_loop,
        make_closed_loop_sim,
    )
    from learningagileflight_se3.sim import plotting
    from learningagileflight_se3.train.imitation import run_imitation_training
    from learningagileflight_se3.train.pretrain import (
        evaluate_pretrain,
        run_pretraining,
    )
    from learningagileflight_se3.train.rl import run_rl_training
    from learningagileflight_se3.utils.checkpoint import save_params
    from learningagileflight_se3.utils.profiling import StageTimer, device_trace

    tag = args.tag or time.strftime("%Y%m%d-%H%M%S")
    outdir = os.path.join("runs", tag)
    os.makedirs(outdir, exist_ok=True)
    print(f"[pipeline] devices={jax.devices()} outdir={outdir}")

    # f32-appropriate solver tolerances on accelerators; f64 CPU can go tight
    on_cpu = jax.default_backend() == "cpu"
    solver_cfg = SolverConfig(
        horizon=args.horizon,
        max_iters=args.max_iters,
        tol=1e-9 if on_cpu else 1e-4,
        gtol=1e-7 if on_cpu else 3e-4,
        # f32 accelerators: lanes at the f32 resolution floor terminate
        # instead of burning the iteration cap (SolverConfig.no_progress_iters)
        no_progress_iters=0 if on_cpu else 10,
    )
    pq, cw, rc, sc = QuadParams(), CostWeights(), RewardConfig(), SamplerConfig()

    if args.full:
        pretrain_steps = args.pretrain_steps or 3000
        rl_epochs = args.rl_epochs or 400
        rl_batch = args.rl_batch or 256
        # 600 (was 300): the r4 seed study showed the analytic-RL teacher
        # needs the deeper imitation budget to transfer its policy to DNN2
        # (held-out success 0.953 -> 0.969 at +40 s of device time)
        imi_epochs = args.imitation_epochs or 600
    else:
        pretrain_steps = args.pretrain_steps or 300
        rl_epochs = args.rl_epochs or 5
        rl_batch = args.rl_batch or 32
        imi_epochs = args.imitation_epochs or 5

    key = jax.random.PRNGKey(args.seed)
    timer = StageTimer()
    trace_ctx = device_trace(args.profile_dir)
    trace_ctx.__enter__()

    # ---------------- stage 1: supervised pretrain (nn_train.py) ----------
    t0 = time.time()
    key, k1 = jax.random.split(key)
    with timer("stage1:pretrain"):
        model1, p1, pre_losses = run_pretraining(
            k1, steps=pretrain_steps, batch_size=256, sampler_cfg=sc,
            log_every=max(1, pretrain_steps // 10),
        )
    key, ke = jax.random.split(key)
    pre_mse = evaluate_pretrain(model1, p1, ke)
    print(f"[stage1] {time.time()-t0:.1f}s  eval MSE {pre_mse:.5f}")
    save_params(os.path.join(outdir, "nn_pre"), p1)
    np.save(os.path.join(outdir, "pretrain_loss.npy"), np.asarray(pre_losses))

    # ---------------- stage 2: differentiable-MPC RL (deep_learning.py) ---
    t0 = time.time()
    mesh = make_mesh() if len(jax.devices()) > 1 else None
    key, k2 = jax.random.split(key)
    with timer("stage2:rl"):
        model1, p1_rl, mean_rewards = run_rl_training(
            k2, p1, epochs=rl_epochs, batch_size=rl_batch,
            params_q=pq, weights=cw, solver_cfg=solver_cfg, reward_cfg=rc,
            sampler_cfg=sc, mesh=mesh, grad_mode=args.grad,
            lr_schedule=args.rl_sched,
            checkpoint_dir=os.path.join(outdir, "rl_state"),
            resume=args.resume,
        )
    print(f"[stage2] {time.time()-t0:.1f}s  mean reward "
          f"{mean_rewards[0]:.2f} -> {mean_rewards[-1]:.2f}")
    save_params(os.path.join(outdir, "nn_deep"), p1_rl)
    np.save(os.path.join(outdir, "Mean_Reward.npy"), np.asarray(mean_rewards))
    np.save(os.path.join(outdir, "Iteration.npy"), np.arange(1, len(mean_rewards) + 1))

    # ---------------- stage 3: DNN2 imitation (nn_train_2.py) -------------
    # Restart selection (the reference's analogue: deep_learning.py runs 5
    # RL restarts and saves each candidate): train `--imitation-restarts`
    # DNN2s from independent imitation-data keys and keep the one with the
    # best closed-loop success on a SELECTION scenario set drawn from a key
    # independent of the final eval (r4 seed study: stage-3 key variance is
    # worth ~2 flights of 128 held-out; 0.945-0.969 over 4 keys).
    t0 = time.time()
    restarts = args.imitation_restarts or (2 if args.full else 1)
    key, ksel_s, ksel_g = jax.random.split(key, 3)
    n_sel = 32
    sel_scens = sample_scenarios(ksel_s, n_sel, sc)
    sel_keys = jax.random.split(ksel_g, n_sel)
    best = None
    sel_rates = []
    with timer("stage3:imitation"):
        for r in range(restarts):
            key, k3 = jax.random.split(key)
            model2, p2_r, losses_r = run_imitation_training(
                k3, p1_rl, epochs=imi_epochs,
                batch_scenarios=64 if args.full else 16,
                sgd_passes=10 if args.full else 4,
                lr=args.imitation_lr, lr_schedule=True,
                params_q=pq, weights=cw, solver_cfg=solver_cfg, sampler_cfg=sc,
                window_frame=args.window_frame,
                consistent_labels=args.consistent_labels,
            )
            if restarts > 1:
                sim_sel = make_closed_loop_sim(
                    model2, pq, cw, solver_cfg, steps=args.sim_steps)

                def sel_one(s, k, _p2=p2_r):
                    return evaluate_closed_loop(sim_sel(_p2, s, k), s[3:6])[0]

                sel = np.asarray(jax.jit(jax.vmap(sel_one))(sel_scens, sel_keys))
                rate = float(sel.astype(bool).mean())
            else:
                rate = float("nan")
            sel_rates.append(rate)
            print(f"[stage3] restart {r}: loss {losses_r[-1]:.5f} "
                  f"selection success {rate:.3f}")
            if best is None or (restarts > 1 and rate > best[0]):
                best = (rate, p2_r, losses_r)
    _, p2, imi_losses = best
    print(f"[stage3] {time.time()-t0:.1f}s  loss {imi_losses[0]:.4f} -> "
          f"{imi_losses[-1]:.4f}  (kept best of {restarts}: {sel_rates})")
    save_params(os.path.join(outdir, "nn3_1"), p2)
    np.save(os.path.join(outdir, "imitation_loss.npy"), np.asarray(imi_losses))

    # ---------------- closed-loop evaluation (main.py) --------------------
    t0 = time.time()
    sim = make_closed_loop_sim(model2, pq, cw, solver_cfg, steps=args.sim_steps)
    key, ks, kg = jax.random.split(key, 3)
    n_eval = max(1, args.eval_scenarios)
    scens = sample_scenarios(ks, n_eval, sc)
    gate_keys = jax.random.split(kg, n_eval)

    def eval_one(s, k):
        trace = sim(p2, s, k)
        return trace, evaluate_closed_loop(trace, s[3:6])

    run_eval = jax.jit(jax.vmap(eval_one))
    with timer("eval:closed_loop"):
        logs, (travs, margins, final_ds) = timer.block(run_eval(scens, gate_keys))
    travs = np.asarray(travs)
    margins = np.asarray(margins)
    final_ds = np.asarray(final_ds)
    success_rate = float(travs.astype(bool).mean())
    # headline log trace = the first scenario (the reference's main.py logs one)
    log = jax.tree_util.tree_map(lambda x: x[0], logs)
    scen = scens[0]
    trav, margin, final_d = travs[0], margins[0], final_ds[0]
    dt_sim = time.time() - t0
    print(f"[eval] {dt_sim:.1f}s  success {success_rate:.2f} over {n_eval} "
          f"scenarios; scenario0 traversed={bool(trav)} "
          f"margin={float(margin):.3f} final_dist={float(final_d):.3f}")

    # the reference's 8 .npy logs (main.py:117-124)
    np.save(os.path.join(outdir, "gate_move_traj.npy"), np.asarray(log.gate_moves))
    np.save(os.path.join(outdir, "uav_traj.npy"), np.asarray(log.states))
    np.save(os.path.join(outdir, "uav_ctrl.npy"), np.asarray(log.controls))
    np.save(os.path.join(outdir, "abs_tra_time.npy"), np.asarray(log.abs_tra_times))
    np.save(os.path.join(outdir, "tra_time.npy"), np.asarray(log.tra_times))
    np.save(os.path.join(outdir, "Time.npy"), np.asarray(log.times))
    np.save(os.path.join(outdir, "Pitch.npy"), np.asarray(log.pitches))
    np.save(os.path.join(outdir, "HL_Variable.npy"), np.asarray(log.hl_variables))

    plotting.plot_position(np.asarray(log.states), dt=0.01,
                           path=os.path.join(outdir, "position.png"))
    plotting.plot_input(np.asarray(log.controls), dt=0.01,
                        path=os.path.join(outdir, "input.png"))

    summary = {
        "pretrain_eval_mse": pre_mse,
        "rl_mean_reward_first": mean_rewards[0],
        "rl_mean_reward_last": mean_rewards[-1],
        "imitation_loss_last": imi_losses[-1],
        "closed_loop_traversed": bool(trav),
        "closed_loop_margin": float(margin),
        "closed_loop_final_dist": float(final_d),
        "closed_loop_success_rate": success_rate,
        "closed_loop_eval_scenarios": n_eval,
        "closed_loop_mean_final_dist": float(final_ds.mean()),
        "window_frame": bool(args.window_frame),
        "consistent_labels": bool(args.consistent_labels),
        "rl_grad_mode": args.grad,
        "rl_epochs": rl_epochs,
        "imitation_epochs": imi_epochs,
        "imitation_restarts": restarts,
        "imitation_selection_success": sel_rates,
        "platform": jax.default_backend(),
        "n_devices": len(jax.devices()),
    }
    trace_ctx.__exit__(None, None, None)
    timer.report()
    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[pipeline] done: {json.dumps(summary)}")


if __name__ == "__main__":
    main()
