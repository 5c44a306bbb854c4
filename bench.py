"""Benchmark: batched MPC solver throughput on one GPU.

Prints ONE JSON line:
  {"metric": "mpc_solves_per_sec_chip", "value": N, "unit": "solves/s",
   "vs_baseline": N / 10.0, ...}

Baseline: the reference solves ONE ~863-variable CasADi/IPOPT NLP per MPC
query with a 100 ms real-time budget at 10 Hz replanning on a single CPU core
(BASELINE.md: main.py:76; quad_OC.py:104-212) => 10 solves/s/core.

Each solve here is the full H=50 gate-traversal problem from a cold start
(hover initialization, fresh scenario) under a 60-iteration DDP budget with
progress-window termination — the same work the reference's RL gradient
workers do 9x per sample.  Solution
quality of that budget is MEASURED IN-BENCH against a 150-iteration
fully-converged run of the same scenarios and emitted in the JSON
(converged_frac, median/q90 cost excess, frac within 1%).  Diagnostics go to
stderr; stdout carries exactly the one JSON line, which names the device.
A GPU is required: there is no CPU fallback.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_solver_config():
    """The benchmark's operating point (see main)."""
    from learningagileflight_se3.config import SolverConfig

    return SolverConfig(horizon=50, max_iters=60, tol=1e-4, gtol=3e-4,
                        ls_adaptive=True, ls_max_trips=4, no_progress_iters=10)


def bench_problems(batch, seed):
    """`batch` cold problems from sampled scenarios (f32): traversal pose at
    the gate centre, pitch half the gate's, t from distance / 4 clipped to
    [2, 4] s.  Returns the solver's (x0, u_last, goal, tra_pos, tra_ang, t)."""
    from learningagileflight_se3.models.sampler import sample_scenarios, scenario_to_problem

    scen = sample_scenarios(jax.random.PRNGKey(seed), batch).astype(jnp.float32)
    probs = jax.vmap(scenario_to_problem)(scen)
    x0 = probs["x0"]
    tra_ang = jnp.concatenate(
        [jnp.zeros((batch, 1)), scen[:, 8:9] * 0.5, jnp.zeros((batch, 1))], axis=1
    ).astype(jnp.float32)
    t = jnp.clip(jnp.linalg.norm(x0[:, 0:3], axis=1) / 4.0, 2.0, 4.0).astype(jnp.float32)
    return (x0, jnp.zeros((batch, 4), jnp.float32), probs["goal_pos"],
            jnp.zeros((batch, 3), jnp.float32), tra_ang, t)


def main():
    from learningagileflight_se3.config import (
        CostWeights,
        QuadParams,
        SolverConfig,
    )
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver
    from learningagileflight_se3.utils.compile_cache import enable_compile_cache
    from learningagileflight_se3.utils.device import describe_device

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    log(f"device: {dev} ({dev.device_kind})")

    params_q = QuadParams()
    weights = CostWeights()
    # f32: relative tolerances sized to f32 resolution.
    # Operating point (round-4 frontier sweep): 60-iter budget,
    # line search capped at 4 trips/iteration (adaptive warm-started
    # backtracking), and the r4 progress-WINDOW termination
    # (no_progress_iters=10): a lane whose last 10 iterations made < tol
    # cumulative progress is terminal (the f32 resolution floor holds
    # pg_rel at ~1e-2, so the KKT gates alone cannot certify it).  The
    # window frees finished lanes' line-search trips; the freed budget
    # funds cap 60, which the r4 frontier sweep shows strictly dominates
    # the r3 cap-50 point on quality: conv 0.82 (was 0.40), q90 excess
    # 5.2e-3 (was 6.4e-3), frac-within-1% 0.955 (was 0.942) — all measured
    # against the TRUE uncapped 150-iter golden — at ~16% sync throughput
    # cost.
    solver_cfg = bench_solver_config()
    batch = 2048  # not yet re-swept on the GPU (ROADMAP speed item 1)

    solve = jax.jit(make_batched_mpc_solver(params_q, weights, solver_cfg))

    # timings end in a host fetch of the result (np.asarray)
    t0 = time.time()
    sol = solve(*bench_problems(batch, 0))
    np.asarray(sol.control_traj)
    compile_s = time.time() - t0
    log(f"compile+first batch ({batch} solves): {compile_s:.1f}s; "
        f"iters mean {float(sol.iterations.mean()):.1f} max {int(sol.iterations.max())}, "
        f"converged {int(sol.converged.sum())}/{batch}")

    # fresh scenarios per rep (same shapes -> cached executable)
    n_rep = 3
    rep_args = [bench_problems(batch, 100 + i) for i in range(n_rep)]
    for a in rep_args:
        jax.block_until_ready(a)

    # single-call latency mode: fetch-sync between batches
    times = []
    for i, a in enumerate(rep_args):
        t0 = time.time()
        sol = solve(*a)
        np.asarray(sol.control_traj)
        times.append(time.time() - t0)
        log(f"rep {i} (sync): {times[-1]:.3f}s  ({batch/times[-1]:.1f} solves/s)")
    sync_sps = batch / min(times)

    # pipelined throughput mode (the training regime: steps enqueue
    # back-to-back, host gap hidden behind device work)
    n_pipe = 12
    pipe_times = []
    for rep in range(2):  # best of 2
        t0 = time.time()
        sols = [solve(*rep_args[i % n_rep]) for i in range(n_pipe)]
        for s in sols:
            np.asarray(s.control_traj)
        pipe_times.append(time.time() - t0)
        log(f"pipelined x{n_pipe} rep {rep}: {pipe_times[-1]:.3f}s "
            f"({n_pipe * batch / pipe_times[-1]:.1f} solves/s)")
    pipe_elapsed = min(pipe_times)
    solves_per_sec = n_pipe * batch / pipe_elapsed
    log(f"pipelined best: {solves_per_sec:.1f} solves/s; sync mode {sync_sps:.1f}")
    # ---- solution quality at the benchmark budget, measured in-bench ----
    # golden = fully-converged (150-iter) solves of the SAME scenarios with
    # the FULL uncapped line-search ladder (ls_adaptive=False, 14 trips) —
    # an independent quality anchor that does not share the benchmarked
    # config's trip-cap failure modes (advisor r3 finding: a capped golden
    # can hide quality loss the cap itself causes).
    golden_cfg = SolverConfig(horizon=50, max_iters=150, tol=1e-4, gtol=3e-4,
                              ls_adaptive=False, ls_max_trips=14)
    solve_golden = jax.jit(make_batched_mpc_solver(params_q, weights, golden_cfg))
    sol_g = solve_golden(*rep_args[0])
    Jg = np.asarray(sol_g.cost)
    sol_b = solve(*rep_args[0])
    Jb = np.asarray(sol_b.cost)
    conv_frac = float(np.asarray(sol_b.converged).mean())
    excess = (Jb - Jg) / np.maximum(np.abs(Jg), 1e-6)
    log(f"quality vs 150-iter golden: converged {conv_frac:.3f} "
        f"excess med {np.median(excess):.2e} q90 {np.percentile(excess, 90):.2e} "
        f"frac<1% {(excess < 0.01).mean():.3f} "
        f"(golden itself converged {float(np.asarray(sol_g.converged).mean()):.3f})")

    # ---- certified tier: status-driven selective re-solve (VERDICT r4 #6) -
    # The fast tier's per-lane exit `status` separates true-KKT certificates
    # (status 1) from budget-floor
    # exits (cap/window/blowout).  The certified tier re-solves every
    # non-KKT lane COLD with the uncapped golden config and merges by min
    # cost, so each lane either carries a KKT certificate from the fast
    # pass or the reference-grade solve.  Both tiers are timed end-to-end
    # (main + gather + rescue) and reported; the headline stays the fast tier.
    status0 = np.asarray(sol_b.status)
    n_rescue = int((status0 != 1).sum())
    RES = max(128, int(np.ceil(min(n_rescue, batch) / 128) * 128))
    # compile the rescue tile once (fixed shape)
    idx0 = np.resize(np.where(status0 != 1)[0], RES)
    sol_r = solve_golden(*[np.asarray(a)[idx0] for a in rep_args[0]])
    np.asarray(sol_r.cost)
    # PIPELINED certified timing: all fast passes are dispatched
    # up-front, so rescue(i) (host gather + golden re-solve) overlaps
    # the still-running fast pass of rep i+1 — the training-regime
    # schedule, same as the fast tier's pipelined mode.
    cert_q = None
    t0 = time.time()
    mains = [solve(*a) for a in rep_args]
    rescues = []
    for i, a in enumerate(rep_args):
        s_main = mains[i]
        st = np.asarray(s_main.status)
        Jm = np.asarray(s_main.cost)
        idx = np.where(st != 1)[0]
        if len(idx) == 0:
            rescues.append((None, None, Jm))
            continue
        if len(idx) > RES:  # keep the tile static: most-suspicious first
            rel_pg = np.asarray(s_main.grad_norm) / (np.abs(Jm) + 1.0)
            idx = idx[np.argsort(-rel_pg[idx])[:RES]]
        pad = np.resize(idx, RES)
        s_r = solve_golden(*[np.asarray(x)[pad] for x in a])
        rescues.append((idx, s_r, Jm))
    J_certs = []
    for idx, s_r, Jm in rescues:
        J_cert = Jm.copy()
        if idx is not None:
            Jr = np.asarray(s_r.cost)
            J_cert[idx] = np.minimum(Jm[idx], Jr[: len(idx)])
        J_certs.append(J_cert)
    cert_elapsed = time.time() - t0
    ex_c = (J_certs[0] - Jg) / np.maximum(np.abs(Jg), 1e-6)
    cert_q = {
        "q90_cost_excess": float(np.percentile(ex_c, 90)),
        "q99_cost_excess": float(np.percentile(ex_c, 99)),
        "frac_within_1pct": float((ex_c < 0.01).mean()),
        "frac_within_1e3": float((ex_c < 1e-3).mean()),
    }
    cert_sps = len(rep_args) * batch / cert_elapsed
    certified = {
        "solves_per_sec": round(cert_sps, 2),
        "vs_baseline": round(cert_sps / 10.0, 2),
        "rescue_frac": round(n_rescue / batch, 3),
        "rescue_tile": RES,
        **(cert_q or {}),
    }
    # cert_q stays None when rep 0 needed no rescue (all lanes KKT)
    q99_s = (f"q99 excess {cert_q['q99_cost_excess']:.1e} "
             f"frac<1e-3 {cert_q['frac_within_1e3']:.4f}"
             if cert_q else "rep 0 fully KKT - no rescue quality row")
    log(f"certified tier: {cert_sps:.1f} solves/s "
        f"(rescue {n_rescue}/{batch} lanes) " + q99_s)

    baseline = 10.0  # IPOPT solves/s/core implied by the 10 Hz budget
    out = {
        "metric": "mpc_solves_per_sec_chip",
        "value": round(solves_per_sec, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / baseline, 2),
        "sync_solves_per_sec": round(sync_sps, 2),
        "batch": batch,
        "horizon": 50,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "device": describe_device(),
        "mean_solver_iters": round(float(sol.iterations.mean()), 1),
        "compile_s": round(compile_s, 1),
        "converged_frac": round(conv_frac, 4),
        "median_cost_excess_vs_converged": float(np.median(excess)),
        "q90_cost_excess_vs_converged": float(np.percentile(excess, 90)),
        "q99_cost_excess_vs_converged": float(np.percentile(excess, 99)),
        "frac_within_1pct_of_converged": round(float((excess < 0.01).mean()), 4),
        "frac_within_1e3_of_converged": round(float((excess < 1e-3).mean()), 4),
        "certified_tier": certified,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
