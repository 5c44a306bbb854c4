"""Worker for the 2-process CPU collective test (SURVEY.md §4 anchor 5).

Each process initializes jax.distributed (gloo CPU collectives), contributes
4 virtual CPU devices to a global 8-device scenario mesh, runs ONE sharded
RL training step (shard_map + psum, train/rl.py), and writes the resulting
mean reward and updated DNN1 parameters for the parent test to compare with
a single-process 8-device run of the identical step.

Usage: python mp_worker.py <process_id> <num_processes> <port> <outdir>
"""

import sys


def main():
    pid, nproc, port, outdir = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
        sys.argv[4],
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from learningagileflight_se3.parallel.distributed import (
        global_batch_from_host,
        initialize_distributed,
    )

    ok = initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
        local_device_count=4,
    )
    assert ok and jax.process_count() == nproc, (
        f"distributed init failed: {jax.process_count()} processes"
    )
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    import numpy as np
    import jax.numpy as jnp
    import optax

    from learningagileflight_se3.config import (
        CostWeights,
        QuadParams,
        RewardConfig,
        SamplerConfig,
        SolverConfig,
    )
    from learningagileflight_se3.models.mlp import make_dnn1
    from learningagileflight_se3.models.sampler import sample_scenarios
    from learningagileflight_se3.parallel.mesh import make_mesh, replicate
    from learningagileflight_se3.train.rl import make_rl_train_step

    mesh = make_mesh()  # global: all 8 devices across both processes
    model = make_dnn1()
    key = jax.random.PRNGKey(7)
    nn_params = model.init(key, jnp.zeros((1, 9), jnp.float64))
    optimizer = optax.adam(1e-4)
    opt_state = optimizer.init(nn_params)

    solver_cfg = SolverConfig(horizon=5, max_iters=2)
    step = make_rl_train_step(
        model, optimizer, QuadParams(), CostWeights(), solver_cfg,
        RewardConfig(), mesh=mesh, grad_mode="fd",
    )

    scen_host = np.asarray(sample_scenarios(key, 8, SamplerConfig()))
    scen = global_batch_from_host(mesh, scen_host)
    nn_params = replicate(mesh, nn_params)
    opt_state = replicate(mesh, opt_state)

    nn_params, opt_state, mean_r, _ = step(nn_params, opt_state, scen)
    leaves = jax.tree_util.tree_leaves(nn_params)
    flat = np.concatenate([np.asarray(jax.device_get(l)).ravel() for l in leaves])
    np.savez(
        f"{outdir}/result_{pid}.npz",
        mean_r=np.asarray(jax.device_get(mean_r)),
        params=flat,
    )
    print(f"worker {pid}: mean_r={float(jax.device_get(mean_r)):.6f}", flush=True)


if __name__ == "__main__":
    main()
