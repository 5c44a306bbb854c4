"""Multi-process collective test (SURVEY.md §4 anchor 5): the same sharded
RL step (shard_map + psum over the scenario mesh) must produce identical
results whether the 8-device mesh lives in one process or is split across
two jax.distributed processes with gloo CPU collectives — the multi-host
equivalence the reference's fork-based backend (deep_learning.py:66-72)
never had to prove."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_reference():
    """The identical step on this process's 8 virtual devices."""
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
    from learningagileflight_se3.parallel.distributed import global_batch_from_host
    from learningagileflight_se3.parallel.mesh import make_mesh, replicate
    from learningagileflight_se3.train.rl import make_rl_train_step

    mesh = make_mesh()
    model = make_dnn1()
    key = jax.random.PRNGKey(7)
    nn_params = model.init(key, jnp.zeros((1, 9), jnp.float64))
    optimizer = optax.adam(1e-4)
    opt_state = optimizer.init(nn_params)
    step = make_rl_train_step(
        model, optimizer, QuadParams(), CostWeights(),
        SolverConfig(horizon=5, max_iters=2), RewardConfig(),
        mesh=mesh, grad_mode="fd",
    )
    scen_host = np.asarray(sample_scenarios(key, 8, SamplerConfig()))
    scen = global_batch_from_host(mesh, scen_host)
    nn_params = replicate(mesh, nn_params)
    opt_state = replicate(mesh, opt_state)
    nn_params, opt_state, mean_r, _ = step(nn_params, opt_state, scen)
    leaves = jax.tree_util.tree_leaves(nn_params)
    flat = np.concatenate([np.asarray(l).ravel() for l in leaves])
    return float(mean_r), flat


@pytest.mark.slow
def test_two_process_psum_matches_single_process(tmp_path):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    ref_mean_r, ref_params = _single_process_reference()

    for pid in range(2):
        res = np.load(tmp_path / f"result_{pid}.npz")
        # both processes hold the full replicated updated params
        np.testing.assert_allclose(res["params"], ref_params, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            float(res["mean_r"]), ref_mean_r, rtol=1e-12, atol=1e-12
        )
