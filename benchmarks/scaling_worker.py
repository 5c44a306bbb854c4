"""Worker for the multi-process scaling row of bench_scaling.py.

Each process joins a jax.distributed CPU cluster (the REAL multi-host init
path, parallel/distributed.py), contributes virtual CPU devices to a global
scenario mesh, and times a fixed number of globally-sharded steps.  The
parent compares 2-process against 1-process throughput at the SAME global
device count — isolating exactly the cross-process machinery (gloo
collectives, distributed dispatch) the reference's fork backend
(deep_learning.py:66-72) never exercised.

Two modes:
  * "solve":     batched MPC solves (raw solver throughput);
  * "trainstep": the FULL RL training step (train/rl.py make_rl_train_step
    with the mesh/shard_map/psum path and the optax update) — the
    throughput of the path that actually scales training, per-step analytic
    learning signal included.

Usage: python scaling_worker.py <pid> <nproc> <port> <devs_per_proc>
                                <batch> <horizon> <iters> <reps> <outdir>
                                [mode]
"""

import json
import os
import sys
import time

# runnable from a plain checkout: benchmarks/ is not the package root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    (pid, nproc, port, dpp, batch, horizon, iters, reps, outdir) = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
        int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]),
        int(sys.argv[8]), sys.argv[9],
    )
    mode = sys.argv[10] if len(sys.argv) > 10 else "solve"

    import jax

    jax.config.update("jax_platforms", "cpu")
    from learningagileflight_se3.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from learningagileflight_se3.parallel.distributed import (
        global_batch_from_host,
        initialize_distributed,
    )

    ok = initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
        local_device_count=dpp,
    )
    assert ok and jax.process_count() == nproc
    assert len(jax.devices()) == dpp * nproc

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from learningagileflight_se3.config import (
        CostWeights, QuadParams, SolverConfig,
    )
    from learningagileflight_se3.models.sampler import (
        sample_scenarios, scenario_to_problem,
    )
    from learningagileflight_se3.parallel.mesh import make_mesh
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver

    mesh = make_mesh()
    cfg = SolverConfig(horizon=horizon, max_iters=iters, tol=1e-4, gtol=3e-4)
    key = jax.random.PRNGKey(0)  # identical on every process
    scen = np.asarray(sample_scenarios(key, batch), np.float32)
    scen_g = global_batch_from_host(mesh, scen)

    if mode == "trainstep":
        # the path that actually scales training: shard_map'ed batched
        # analytic learning signal + psum gradient reduction + optax update
        # (train/rl.py make_rl_train_step — deep_learning.py:66-83's role)
        import optax
        from learningagileflight_se3.config import (
            LearnedGradConfig, RewardConfig,
        )
        from learningagileflight_se3.models.mlp import make_dnn1
        from learningagileflight_se3.train.rl import make_rl_train_step

        model = make_dnn1()
        nn_params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 9)))
        optimizer = optax.adam(1e-4)
        opt_state = optimizer.init(nn_params)
        step = make_rl_train_step(
            model, optimizer, QuadParams(), CostWeights(), cfg,
            RewardConfig(), LearnedGradConfig(), mesh=mesh,
            grad_mode="analytic",
        )
        nn_params, opt_state, mr, _ = step(nn_params, opt_state, scen_g)
        jax.block_until_ready(mr)  # compile + warm
        multihost_utils.sync_global_devices("warm")
        t0 = time.perf_counter()
        for _ in range(reps):
            nn_params, opt_state, mr, _ = step(nn_params, opt_state, scen_g)
            jax.block_until_ready(mr)
        multihost_utils.sync_global_devices("done")
        elapsed = time.perf_counter() - t0
        rate = reps / elapsed          # train steps / s
        rate_key = "steps_per_sec"
    else:
        solve = jax.jit(make_batched_mpc_solver(
            QuadParams(), CostWeights(), cfg))
        probs = jax.jit(jax.vmap(scenario_to_problem))(scen_g)
        # every sharded input goes through the same host->global path
        # (make_array_from_callback handles the multi-process case)
        gput = lambda a: global_batch_from_host(mesh, np.asarray(a, np.float32))
        x0 = probs["x0"]
        args = (x0, gput(np.zeros((batch, 4))), probs["goal_pos"],
                gput(np.zeros((batch, 3))), gput(np.zeros((batch, 3))),
                jnp.clip(jnp.linalg.norm(x0[:, 0:3], axis=1) / 4.0, 2.0, 4.0))

        sol = solve(*args)
        jax.block_until_ready(sol.cost)  # compile + warm
        multihost_utils.sync_global_devices("warm")
        t0 = time.perf_counter()
        for _ in range(reps):
            sol = solve(*args)
            jax.block_until_ready(sol.cost)
        multihost_utils.sync_global_devices("done")
        elapsed = time.perf_counter() - t0
        rate = batch * reps / elapsed  # solves / s
        rate_key = "solves_per_sec"

    if pid == 0:
        out = {
            "nproc": nproc,
            "devices": dpp * nproc,
            "batch": batch,
            "reps": reps,
            "mode": mode,
            "elapsed_s": elapsed,
            rate_key: rate,
        }
        with open(f"{outdir}/mp_{mode}_{nproc}.json", "w") as f:
            json.dump(out, f)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
