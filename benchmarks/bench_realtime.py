"""Real-time AND quality at ONE operating point (BASELINE.md's last row).

The reference replans at 10 Hz — every control query (traversal-time fixed
point + DNN2 + full MPC solve, main.py:67-106) must fit a 100 ms budget on
the deployment machine.  This benchmark measures latency and closed-loop
success at ONE config, on both axes in the same run:

  1. latency: wall-clock of every 10 Hz replan tick of the SHIPPED deployment
     adapter (sim/external_controller.ExternalSimController — the
     Yixiao_ctrl_wrapper.computeControl role) driven against a host-side
     plant loop, warm-started exactly as deployed.  The adapter's
     `max_iters=45` is a CAP: the solver's while_loop exits on convergence,
     so warm ticks run only as many DDP iterations as the replan needs.
  2. the 100 Hz inner loop: at plant rate the deployed stack runs only the
     gate-state Kalman step (10 ms budget); the traversal-time fixed point
     feeds the replan and is measured inside the tick.
  3. quality: closed-loop success of the same checkpoint at the same solver
     config over --n seeded scenarios (the bench_success protocol), with
     per-replan solver-iteration telemetry from the sim logs.

Prints ONE JSON line:
  {"metric": "realtime_replan", "value": <tick_p90_s>, "unit": "s",
   "vs_baseline": <0.1/tick_p90>, "success_rate": ..., "ok": ...}
ok = tick_p90 < 0.1 s AND success_rate >= 0.95 at the SAME config.

The JSON names the device and, on a GPU, the card's name and power limit.

Usage: python benchmarks/bench_realtime.py [--n 128] [--ckpt artifacts/nn3_1]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rpy_and_rates_from_state(q_wxyz, omega_body):
    """Invert the adapter's state reassembly: quat -> (rpy, euler rates).

    ExternalSimController consumes what a physics engine reports — Euler
    angles/rates — and maps them back to body rates via angu_vel_tran_w2b
    (Yixiao_ctrl_wrapper.py:176-184).  Here we produce those engine-side
    quantities from the plant's (quat, omega_body) so the adapter's full
    conversion path is exercised (d_rpy = Q(rpy) @ omega_b with
    Q = inv(Q_inv))."""
    w, x, y, z = q_wxyz
    # ZYX euler from quaternion (scipy 'xyz' extrinsic == engine rpy)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    rpy = np.array([roll, pitch, yaw])
    Q_inv = np.array(
        [
            [1.0, 0.0, -np.sin(pitch)],
            [0.0, np.cos(roll), np.sin(roll) * np.cos(pitch)],
            [0.0, -np.sin(roll), np.cos(roll) * np.cos(pitch)],
        ]
    )
    d_rpy = np.linalg.solve(Q_inv, np.asarray(omega_body))
    return rpy, d_rpy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="artifacts/nn3_1")
    ap.add_argument("--n", type=int, default=128,
                    help="success-eval scenario count (bench_success protocol)")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--latency-trajectories", type=int, default=2,
                    help="host-driven closed-loop trajectories timed tick by "
                         "tick (each costs one adapter compile)")
    ap.add_argument("--skip-success", action="store_true",
                    help="latency part only (development)")
    ap.add_argument("--max-iters", type=int, default=30,
                    help="DDP iteration cap of THE operating point (both the "
                         "latency ticks and the success eval use it)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from learningagileflight_se3.config import (
        CostWeights,
        GateMotionConfig,
        QuadParams,
        SolverConfig,
        Variant,
    )
    from learningagileflight_se3.dynamics.quadrotor import euler_step_renorm
    from learningagileflight_se3.core.rotations import axis_angle_to_quat
    from learningagileflight_se3.geometry.gate import (
        gate_from_width,
        gate_move,
        rotate_y,
    )
    from learningagileflight_se3.models.mlp import make_dnn2
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.sim.closed_loop import (
        evaluate_closed_loop_full,
        make_closed_loop_sim,
    )
    from learningagileflight_se3.sim.external_controller import (
        ExternalSimController,
    )
    from learningagileflight_se3.sim.tsolver import make_traversal_time_solver
    from learningagileflight_se3.utils.checkpoint import load_params
    from learningagileflight_se3.utils.compile_cache import enable_compile_cache
    from learningagileflight_se3.utils.device import describe_device

    enable_compile_cache()
    platform = jax.default_backend()
    card = describe_device()
    log(f"device {card}")
    on_cpu = platform == "cpu"

    # THE operating point: identical to bench_success.py (the 96% config)
    params_q, weights = QuadParams(), CostWeights()
    solver_cfg = SolverConfig(
        horizon=50, max_iters=args.max_iters,
        tol=1e-9 if on_cpu else 1e-4, gtol=1e-7 if on_cpu else 3e-4,
        no_progress_iters=0 if on_cpu else 10,
        # the throughput-proven capped adaptive line search (bench.py
        # operating point): without it every warm tick whose search fails
        # walks the full 14-trip ladder lock-step - most of the tick's
        # forward-kernel bill
        ls_adaptive=not on_cpu, ls_max_trips=14 if on_cpu else 4,
    )
    motion = GateMotionConfig()

    model2 = make_dnn2()
    like = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    p2 = load_params(args.ckpt, like=like)

    key = jax.random.PRNGKey(args.seed)
    ks, kg = jax.random.split(key)
    scen_all = np.asarray(sample_scenarios(ks, max(args.n, 8)))
    gate_keys = jax.random.split(kg, max(args.n, 8))

    # ------------- part 1: per-tick latency of the shipped adapter --------
    plant_dt = 0.01
    control_every = 10
    step_plant = jax.jit(
        lambda s, u: euler_step_renorm(s, u, plant_dt, params_q)
    )
    tick_times = []
    n_traj = args.latency_trajectories
    for j in range(n_traj):
        scen = scen_all[j]
        start, final = scen[0:3], scen[3:6]
        yaw, width, pitch0 = scen[6], scen[7], scen[8]
        pts0 = rotate_y(gate_from_width(jnp.asarray(width)), pitch0)
        moves, V = gate_move(
            pts0, gate_keys[j], jnp.asarray(motion.velocity), motion.omega_y,
            T=args.steps * plant_dt, dt=plant_dt,
            noise_std=motion.noise_std, noise_clip=motion.noise_clip,
        )
        moves_np, V_np = np.asarray(moves), np.asarray(V)

        ctrl = ExternalSimController(
            model2, p2, final,
            gate_motion=lambda i: (moves_np[i], V_np[i]),
            w_rot=motion.omega_y,
            variant=Variant.MAIN,
            solver_cfg=solver_cfg,
            fixed_point_tol=1e-3,      # main-variant tol (quad_moving.py:45)
            # secant acceleration: same fixed point to the same tolerance in
            # ~4 DNN2 evaluations instead of ~40 averaging trips (the
            # averaging tsolver alone cost ~38 ms of the 100 ms tick)
            fixed_point_accel="secant",
        )
        q0 = axis_angle_to_quat(jnp.asarray(yaw), jnp.array([0.0, 0.0, 1.0]))
        state = np.concatenate([start, np.zeros(3), np.asarray(q0), np.zeros(3)])
        traj_ticks = []
        t0 = time.perf_counter()
        for i in range(args.steps):
            if i % control_every == 0:
                s = np.asarray(state, dtype=np.float64)
                rpy, d_rpy = rpy_and_rates_from_state(s[6:10], s[10:13])
                t1 = time.perf_counter()
                _mixed, _t = ctrl.compute_control(
                    i, s[0:3], s[[7, 8, 9, 6]], s[3:6], d_rpy, rpy
                )
                # fetch-sync happens inside compute_control (np.asarray(u))
                traj_ticks.append(time.perf_counter() - t1)
            state = np.asarray(step_plant(jnp.asarray(state), jnp.asarray(ctrl.u)))
        log(f"traj {j}: {len(traj_ticks)} ticks in {time.perf_counter()-t0:.1f}s "
            f"(first tick incl. compile {traj_ticks[0]:.1f}s)")
        tick_times.extend(traj_ticks[1:])  # drop the compile tick
    ticks = np.asarray(tick_times)
    tick_p50 = float(np.median(ticks))
    tick_p90 = float(np.percentile(ticks, 90))
    tick_max = float(ticks.max())
    log(f"replan tick: p50 {tick_p50*1e3:.1f} ms  p90 {tick_p90*1e3:.1f} ms "
        f"max {tick_max*1e3:.1f} ms  over {len(ticks)} ticks "
        f"(budget 100 ms)")

    # Null-call round trip of the device: every tick pays one dispatch and
    # one fetch; reported with the net-of-round-trip tick so the artifact
    # separates program cost from dispatch cost.
    null_fn = jax.jit(lambda x: x + 1.0)
    x0_null = jnp.zeros(())
    float(null_fn(x0_null))
    rtts = []
    for _ in range(30):
        t1 = time.perf_counter()
        float(null_fn(x0_null))
        rtts.append(time.perf_counter() - t1)
    rtt_p50 = float(np.median(rtts))
    tick_p90_net = tick_p90 - rtt_p50
    log(f"null-call round trip p50 {rtt_p50*1e3:.1f} ms; "
        f"tick p90 net of it {tick_p90_net*1e3:.1f} ms")

    # ------------- part 2: the 100 Hz inner loop ---------------------------
    # At plant rate the deployed stack runs only gate-state estimation (the
    # Kalman step; sim/estimator.py) — the traversal-time fixed point and
    # everything else the reference's 100 Hz loop recomputes (main.py:67)
    # feeds the 10 Hz replan and is measured INSIDE the tick above.  The KF
    # step must fit the 10 ms plant budget.  It is measured on the HOST CPU
    # device: a 12-dim linear filter belongs on the flight computer.
    from learningagileflight_se3.sim.estimator import (
        gate_observation, kalman_init, make_kalman_step,
    )

    cpu0 = jax.devices("cpu")[0]
    kstep = jax.jit(make_kalman_step(dt=plant_dt), device=cpu0)
    pts = gate_from_width(jnp.asarray(scen_all[0][7]))
    obs = jax.device_put(gate_observation(pts), cpu0)
    ks = jax.device_put(kalman_init(gate_observation(pts)), cpu0)
    ks = kstep(ks, obs)
    jax.block_until_ready(ks)
    inner = []
    for _ in range(50):
        t1 = time.perf_counter()
        ks = kstep(ks, obs)
        jax.block_until_ready(ks)
        inner.append(time.perf_counter() - t1)
    inner_p50 = float(np.median(inner))
    log(f"100 Hz KF step (host CPU): p50 {inner_p50*1e3:.2f} ms (budget 10 ms)")
    # diagnostic: the tsolver fixed point alone (runs inside the tick;
    # secant mode = what the deployed adapter uses)
    tsolve = jax.jit(make_traversal_time_solver(model2, tol=1e-3,
                                                accel="secant"))
    st = jnp.asarray(np.concatenate(
        [scen_all[0][0:3], np.zeros(10)]).astype(np.float32))
    fp = jnp.asarray(scen_all[0][3:6])
    vel = jnp.asarray(motion.velocity)
    float(tsolve(p2, st, fp, pts, vel, motion.omega_y))  # compile + sync
    ts_lat = []
    for _ in range(30):
        t1 = time.perf_counter()
        float(tsolve(p2, st, fp, pts, vel, motion.omega_y))
        ts_lat.append(time.perf_counter() - t1)
    tsolve_p50 = float(np.median(ts_lat))
    log(f"tsolver fixed point (inside the tick): p50 {tsolve_p50*1e3:.2f} ms")

    # ------------- part 3: success at the SAME config ---------------------
    success = None
    iters_p50 = iters_p90 = None
    if not args.skip_success:
        sim = make_closed_loop_sim(
            model2, params_q, weights, solver_cfg,
            motion_cfg=motion, steps=args.steps,
            # the SAME tsolver mode as the latency ticks (one config)
            fixed_point_accel="secant",
        )
        scen_j = jnp.asarray(scen_all[: args.n], jnp.float32)

        def run_one(s, k):
            trace = sim(p2, s, k)
            return (
                evaluate_closed_loop_full(trace, s[3:6]),
                trace.solver_iters,
            )

        run = jax.jit(jax.vmap(run_one))
        t0 = time.time()
        res, solver_iters = run(scen_j, gate_keys[: args.n])
        trav = np.asarray(res.traversed)
        solver_iters = np.asarray(solver_iters)
        log(f"success eval: {args.n} x {args.steps}-step sims in "
            f"{time.time()-t0:.1f}s")
        success = float(trav.astype(bool).mean())
        # per-replan iteration telemetry (nonzero rows = replan steps)
        it = solver_iters[solver_iters > 0]
        iters_p50 = float(np.median(it))
        iters_p90 = float(np.percentile(it, 90))
        log(f"success {success:.4f}; replan solver iters p50 {iters_p50:.0f} "
            f"p90 {iters_p90:.0f} max {int(it.max())}")

    # STRICT gate: the raw tick (dispatch round trip included) must fit the
    # 100 ms budget; ok_net is reported alongside, informational only.
    ok_raw = tick_p90 < 0.1
    ok_net = tick_p90_net < 0.1
    ok = ok_raw and (success is None or success >= 0.95)
    out = {
        "metric": "realtime_replan",
        "value": round(tick_p90, 6),
        "unit": "s",
        "vs_baseline": round(0.1 / tick_p90, 2),
        "ok": bool(ok),
        "ok_raw_budget": bool(ok_raw),
        "ok_net_of_rtt_budget": bool(ok_net),
        "tick_p50_s": round(tick_p50, 6),
        "tick_p90_s": round(tick_p90, 6),
        "tick_max_s": round(tick_max, 6),
        "device_link_rtt_p50_s": round(rtt_p50, 6),
        "tick_p90_net_of_rtt_s": round(tick_p90_net, 6),
        "n_ticks": int(len(ticks)),
        "inner_loop_kf_p50_s": round(inner_p50, 6),
        "tsolver_p50_s": round(tsolve_p50, 6),
        "success_rate": success,
        "replan_iters_p50": iters_p50,
        "replan_iters_p90": iters_p90,
        "solver_max_iters": solver_cfg.max_iters,
        "horizon": solver_cfg.horizon,
        "n_scenarios": args.n if not args.skip_success else 0,
        "ckpt": args.ckpt,
        "seed": args.seed,
        "platform": platform,
        "device": card,
    }
    print(json.dumps(out))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
