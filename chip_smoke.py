"""Smoke test of the whole system on one NVIDIA GPU, through the entry points
a user calls, at the widths the repo supports (H = 50, 2048 cold solves,
DNN1 9-64-64-7 and DNN2 18-128-128-7, training batches of 256 scenarios).

    python chip_smoke.py             # one card: phases 1-6 below
    python chip_smoke.py --chips 4   # four cards: the sharded RL step only

Phases (one card), each printing one line; any failure ends the run with a
non-zero exit and no result line:
  1. device: a GPU is required (never the CPU); card name and power limit,
     jax/jaxlib versions, the compile-cache directory;
  2. reference: the repo has no hand-written kernel on this path (XLA
     compiles all of it), so the check is the 150-iteration golden solve of
     the bench batch on the card against the same solver on the host CPU;
  3. batched cold solves at the bench.py operating point through
     make_batched_mpc_solver, with the cost excess against that golden run;
  4. training: pretrain steps, RL steps in both learning signals, one
     imitation collect + steps, through the train/ drivers;
  5. closed loop with the shipped DNN2 (artifacts/nn3_1.npz): 16 scenarios
     x 500 steps, then 20 warm 10 Hz ticks of ExternalSimController;
  6. the last line: {"ok": true, "device": {...}}.
Informational timings stand beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def say(*a):
    print(*a, flush=True)


def _timed(f, *args, reps=3, **kw):
    """(first-call seconds incl. compile, best steady seconds, result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args, **kw))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


# ------------------------------------------------------------------ phases
def phase_device(n_chips):
    import jax
    import jaxlib

    from learningagileflight_se3.utils.compile_cache import enable_compile_cache
    from learningagileflight_se3.utils.device import gpu_name_and_power_limit

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {devs[0].platform}); "
                         "refusing to run on the CPU")
    if len(devs) < n_chips:
        raise SystemExit(f"chip_smoke: need {n_chips} GPUs, JAX found {len(devs)}")
    cache = enable_compile_cache()
    card = gpu_name_and_power_limit()
    for line in card:
        say(line)
    say(f"[1 device] {card[0]} x{len(card)} | jax {jax.__version__} jaxlib "
        f"{jaxlib.__version__} | {len(devs)} x {devs[0].device_kind} | "
        f"compile cache {cache}")
    return card[0]


def phase_reference(cfg, problems, card, n_ref=64):
    """The solver on the card against the same solver on the host CPU, at
    the 150-iteration golden configuration.  Returns the card's golden
    solution of the whole batch (phase 3 measures the cost excess with it)."""
    import dataclasses

    import jax

    from learningagileflight_se3.config import CostWeights, QuadParams
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver

    golden_cfg = dataclasses.replace(cfg, max_iters=150, ls_adaptive=False,
                                     ls_max_trips=14, no_progress_iters=0)
    gold = jax.jit(make_batched_mpc_solver(QuadParams(), CostWeights(), golden_cfg))
    t0 = time.perf_counter()
    sg = jax.block_until_ready(gold(*problems))
    t_gold = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    host = jax.block_until_ready(
        gold(*jax.device_put([a[:n_ref] for a in problems], cpu)))
    Jd, Jh = np.asarray(sg.cost)[:n_ref], np.asarray(host.cost)
    both = np.asarray(sg.converged)[:n_ref] & np.asarray(host.converged)
    cost_rel = np.abs(Jd - Jh) / np.maximum(np.abs(Jh), 1.0)
    both_frac = float(both.mean())
    med_rel = float(np.median(cost_rel[both])) if both.any() else float("nan")
    same_basin = float((cost_rel[both] < 1e-4).mean()) if both.any() else 0.0
    line = (f"[2 reference] golden solve (150 iterations) of {n_ref} problems "
            f"on the card vs the host CPU, both float32: both converged "
            f"{both_frac:.3f} median cost rel diff {med_rel:.2e} same basin "
            f"{same_basin:.3f} max {cost_rel.max():.2e}")
    # agreement at convergence, lane-wise: a nonconvex solve amplifies f32
    # reassociation noise and a few lanes legitimately land in other local
    # minima, so the gates are the median and a same-basin majority
    if not (np.isfinite(Jd).all() and both_frac >= 0.5 and med_rel < 1e-5
            and same_basin >= 0.85):
        raise AssertionError("card and host solver disagree: " + line)
    say(line + f" | golden B={problems[0].shape[0]} "
        f"{t_gold:.1f} s incl. compile on {card}")
    return sg


def phase_solves(cfg, problems, golden, card):
    import jax

    from learningagileflight_se3.config import CostWeights, QuadParams
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver

    B = problems[0].shape[0]
    solve = jax.jit(make_batched_mpc_solver(QuadParams(), CostWeights(), cfg))
    c_a, t_a, sa = _timed(solve, *problems)
    Ja, Jg = np.asarray(sa.cost), np.asarray(golden.cost)
    if not np.isfinite(Ja).all():
        raise AssertionError(f"{int((~np.isfinite(Ja)).sum())} non-finite costs")
    excess = (Ja - Jg) / np.maximum(np.abs(Jg), 1e-6)
    say(f"[3 solves] B={B} H={cfg.horizon} bench operating point: "
        f"{B / t_a:.1f} solves/s (compile {c_a - t_a:.1f} s) converged "
        f"{float(np.mean(sa.converged)):.3f} iters "
        f"{float(np.mean(sa.iterations)):.1f} | excess vs golden med "
        f"{np.median(excess):.2e} q90 {np.percentile(excess, 90):.2e} "
        f"frac<1% {float(np.mean(excess < 0.01)):.3f} on {card}")


def phase_training(cfg, card, batch=256):
    import jax
    import jax.numpy as jnp
    import optax

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, RewardConfig, SamplerConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn1
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.train.imitation import run_imitation_training
    from learningagileflight_se3.train.pretrain import run_pretraining
    from learningagileflight_se3.train.rl import make_rl_train_step

    key = jax.random.PRNGKey(11)
    t0 = time.perf_counter()
    _, p1, pre_losses = run_pretraining(key, steps=20, batch_size=batch,
                                        log_every=10, log_fn=lambda *_: None)
    t_pre = time.perf_counter() - t0
    if not np.isfinite(pre_losses).all():
        raise AssertionError(f"pretrain losses {pre_losses}")
    parts = [f"pretrain 20x{batch} loss {pre_losses[-1]:.4f} ({t_pre:.1f} s)"]
    model = make_dnn1()
    opt = optax.adam(1e-4)
    for mode in ("fd", "analytic"):
        step = make_rl_train_step(model, opt, QuadParams(), CostWeights(), cfg,
                                  RewardConfig(), grad_mode=mode)
        p, s = p1, opt.init(p1)
        rewards = []
        t0 = time.perf_counter()
        for e in range(3):
            scen = sample_scenarios(jax.random.fold_in(key, e), batch, SamplerConfig())
            p, s, mean_r, _ = step(p, s, scen)
            rewards.append(float(mean_r))
            if e == 0:
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
        t_steps = (time.perf_counter() - t0) / 2
        if not (np.isfinite(rewards).all()
                and all(np.isfinite(np.asarray(x)).all()
                        for x in jax.tree_util.tree_leaves(p))):
            raise AssertionError(f"RL {mode}: rewards {rewards}")
        parts.append(f"rl[{mode}] 3x{batch} reward {rewards[0]:.2f}->"
                     f"{rewards[-1]:.2f} ({t_steps:.2f} s/step, first "
                     f"{t_first:.1f} s)")
    t0 = time.perf_counter()
    _, _, imi_losses = run_imitation_training(
        jax.random.PRNGKey(12), p1, epochs=1, batch_scenarios=batch,
        sgd_passes=3, lr=1e-3, solver_cfg=cfg, window_frame=True,
        log_fn=lambda *_: None)
    t_imi = time.perf_counter() - t0
    if not np.isfinite(imi_losses).all():
        raise AssertionError(f"imitation losses {imi_losses}")
    parts.append(f"imitation {batch} teacher solves + 3 steps loss "
                 f"{imi_losses[-1]:.4f} ({t_imi:.1f} s)")
    say("[4 training] " + " | ".join(parts) + f" on {card}")


def phase_closed_loop(card, n=16, steps=500):
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_realtime import rpy_and_rates_from_state
    from learningagileflight_se3.config import (
        GateMotionConfig, QuadParams, SolverConfig, Variant,
    )
    from learningagileflight_se3.core.rotations import axis_angle_to_quat
    from learningagileflight_se3.dynamics.quadrotor import euler_step_renorm
    from learningagileflight_se3.geometry.gate import gate_from_width, gate_move, rotate_y
    from learningagileflight_se3.models.mlp import make_dnn2
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.sim.closed_loop import (
        evaluate_closed_loop,
        make_closed_loop_sim,
    )
    from learningagileflight_se3.sim.external_controller import ExternalSimController
    from learningagileflight_se3.utils.checkpoint import load_params

    m2 = make_dnn2()
    like = m2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    p2 = load_params(os.path.join(REPO, "artifacts", "nn3_1"), like=like)
    cfg = SolverConfig(horizon=50, max_iters=45, tol=1e-4, gtol=3e-4,
                       no_progress_iters=10)
    sim = make_closed_loop_sim(m2, solver_cfg=cfg, steps=steps)
    scens = sample_scenarios(jax.random.PRNGKey(2024), n)
    keys = jax.random.split(jax.random.PRNGKey(2025), n)
    run = jax.jit(jax.vmap(
        lambda s, k: evaluate_closed_loop(sim(p2, s, k), s[3:6])))
    c_s, t_s, (trav, margin, final_d) = _timed(run, scens, keys, reps=1)
    if not (np.isfinite(np.asarray(margin)).all()
            and np.isfinite(np.asarray(final_d)).all()):
        raise AssertionError("closed loop produced non-finite metrics")
    success = float(np.asarray(trav).astype(bool).mean())

    # the served path: the controller adapter replans at 10 Hz against a
    # 100 Hz host plant loop, warm-started tick to tick (bench_realtime.py)
    motion = GateMotionConfig()
    scen = np.asarray(scens[0])
    pts0 = rotate_y(gate_from_width(jnp.asarray(scen[7])), scen[8])
    n_ticks = 22  # 2 warm-up ticks (compile), then 20 timed
    moves, V = gate_move(pts0, keys[0], jnp.asarray(motion.velocity),
                         motion.omega_y, T=n_ticks * 10 * 0.01, dt=0.01,
                         noise_std=motion.noise_std, noise_clip=motion.noise_clip)
    moves, V = np.asarray(moves), np.asarray(V)
    ctrl = ExternalSimController(
        m2, p2, scen[3:6], gate_motion=lambda i: (moves[i], V[i]),
        w_rot=motion.omega_y, variant=Variant.MAIN, solver_cfg=cfg,
        fixed_point_tol=1e-3, fixed_point_accel="secant")
    step_plant = jax.jit(lambda x, u: euler_step_renorm(x, u, 0.01, QuadParams()))
    q0 = axis_angle_to_quat(jnp.asarray(scen[6]), jnp.array([0.0, 0.0, 1.0]))
    state = np.concatenate([scen[0:3], np.zeros(3), np.asarray(q0), np.zeros(3)])
    ticks = []
    for i in range(n_ticks * 10):
        if i % 10 == 0:
            rpy, d_rpy = rpy_and_rates_from_state(state[6:10], state[10:13])
            t0 = time.perf_counter()
            wrench, _ = ctrl.compute_control(
                i, state[0:3], state[[7, 8, 9, 6]], state[3:6], d_rpy, rpy)
            ticks.append(time.perf_counter() - t0)
            if not np.isfinite(wrench).all():
                raise AssertionError(f"tick {len(ticks)}: non-finite wrench {wrench}")
        state = np.asarray(step_plant(jnp.asarray(state), jnp.asarray(ctrl.u)),
                           np.float64)
    t = np.asarray(ticks[2:]) * 1e3
    say(f"[5 closed loop] shipped nn3_1: {n} scenarios x {steps} steps success "
        f"{success:.3f} ({t_s:.1f} s, compile {c_s - t_s:.1f} s) | 20 warm "
        f"ticks p50 {np.percentile(t, 50):.1f} ms p90 {np.percentile(t, 90):.1f} "
        f"ms (first tick {ticks[0]:.1f} s) on {card}")


def phase_multichip(card, n, batch=1024, horizon=50):
    import jax
    import jax.numpy as jnp
    import optax

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, RewardConfig, SamplerConfig, SolverConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn1
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.parallel.mesh import make_mesh, replicate, shard_batch
    from learningagileflight_se3.train.rl import make_rl_train_step

    mesh = make_mesh(jax.devices()[:n])
    cfg = SolverConfig(horizon=horizon, max_iters=45, tol=1e-4, gtol=3e-4,
                       no_progress_iters=10)
    model = make_dnn1()
    p0 = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9), jnp.float32))
    opt = optax.adam(1e-4)
    scen = sample_scenarios(jax.random.PRNGKey(3), batch, SamplerConfig()).astype(jnp.float32)
    parts, failures = [], []
    for mode in ("fd", "analytic"):
        mk = lambda m: make_rl_train_step(model, opt, QuadParams(), CostWeights(),
                                          cfg, RewardConfig(), mesh=m, grad_mode=mode)
        c_s, t_s, (p_s, _, mean_s, r_s) = _timed(
            mk(mesh), replicate(mesh, p0), replicate(mesh, opt.init(p0)),
            shard_batch(mesh, scen), reps=1)
        c_u, t_u, (p_u, _, mean_u, r_u) = _timed(
            mk(None), p0, opt.init(p0), scen, reps=1)
        r_s, r_u = np.asarray(r_s), np.asarray(r_u)
        # tolerances of __graft_entry__.dryrun_multichip: rewards to f32
        # reduction order; params to the Adam step scale (lr = 1e-4)
        r_bad = np.abs(r_s - r_u) > 2e-5 + 2e-5 * np.abs(r_u)
        p_err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                 - 2e-5 * np.abs(np.asarray(b))))
                    for a, b in zip(jax.tree_util.tree_leaves(p_s),
                                    jax.tree_util.tree_leaves(p_u)))
        if r_bad.any() or p_err > 1.5e-4:
            failures.append(f"{mode}: {int(r_bad.sum())}/{batch} rewards off, "
                            f"param excess {p_err:.2e}")
        parts.append(f"rl[{mode}] {batch} scenarios H={horizon}: {n} cards "
                     f"{t_s:.2f} s/step vs 1 card {t_u:.2f} s/step (compile "
                     f"{c_s - t_s:.1f}/{c_u - t_u:.1f} s), mean reward "
                     f"{float(mean_s):.3f} vs {float(mean_u):.3f}, rewards off "
                     f"tolerance {int(r_bad.sum())}/{batch} (max rel "
                     f"{float(np.max(np.abs(r_s - r_u) / (np.abs(r_u) + 1e-6))):.1e}), "
                     f"param error beyond rtol {p_err:.1e} (atol 1.5e-4)")
    say("[multichip] " + " | ".join(parts) + f" on {n} x {card}")
    if failures:
        raise AssertionError("sharded != single-card step: " + "; ".join(failures))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded RL step on a 4-card mesh "
                         "and its single-card comparison")
    args = ap.parse_args()

    card = phase_device(args.chips)
    import jax

    if args.chips == 4:
        phase_multichip(card, 4)
    else:
        from bench import bench_problems, bench_solver_config

        cfg = bench_solver_config()
        problems = bench_problems(2048, seed=0)
        golden = phase_reference(cfg, problems, card)
        phase_solves(cfg, problems, golden, card)
        phase_training(cfg, card)
        phase_closed_loop(card)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
