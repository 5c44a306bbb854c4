"""The shipped trained-model artifacts (reference contract:
gym_pybullet_drone/nn3_1.pth + last_inputs.npy, consumed at main.py:42).

This repo commits the full trained stack under artifacts/: DNN1 pretrained
(nn_pre), DNN1 after RL (nn_deep), DNN2 (nn3_1), the training curves, and
the closed-loop evidence (summary.json: 96.9% success over 64 scenarios;
bench_success.json: 96.1% over 128 held-out seeds).  These tests are the
"fresh clone" guarantee: the committed weights load and fly.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import SolverConfig
from learningagileflight_se3.models.mlp import make_dnn1, make_dnn2
from learningagileflight_se3.models.sampler import sample_scenarios
from learningagileflight_se3.utils.checkpoint import load_params

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts")


class TestCommittedArtifacts:
    def test_summary_claims_success(self):
        with open(os.path.join(ART, "summary.json")) as f:
            s = json.load(f)
        assert s["closed_loop_success_rate"] >= 0.8
        assert s["closed_loop_eval_scenarios"] >= 64
        assert s["imitation_loss_last"] < 0.01

    def test_checkpoints_load_and_apply(self):
        m1, m2 = make_dnn1(), make_dnn2()
        like1 = m1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        like2 = m2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
        for name, like, model, dim in (
            ("nn_pre", like1, m1, 9),
            ("nn_deep", like1, m1, 9),
            ("nn3_1", like2, m2, 18),
        ):
            p = load_params(os.path.join(ART, name), like=like)
            out = model.apply(p, jnp.zeros((3, dim)))
            assert out.shape == (3, 7)
            assert bool(jnp.isfinite(out).all()), name

    def test_rl_actually_moved_the_params(self):
        """nn_deep must differ from nn_pre (the RL stage did something)."""
        m1 = make_dnn1()
        like = m1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        p_pre = load_params(os.path.join(ART, "nn_pre"), like=like)
        p_rl = load_params(os.path.join(ART, "nn_deep"), like=like)
        diffs = jax.tree_util.tree_map(
            lambda a, b: float(jnp.abs(a - b).max()), p_pre, p_rl
        )
        assert max(jax.tree_util.tree_leaves(diffs)) > 1e-3

    @pytest.mark.slow
    def test_committed_dnn2_flies_closed_loop(self):
        """Load the committed DNN2 and fly 2 fresh scenarios end-to-end
        (500-step moving-gate sim); at least one must traverse the gate.
        (Full-scale evidence: artifacts/bench_success.json, 128 flights.)"""
        from learningagileflight_se3.sim.closed_loop import (
            evaluate_closed_loop,
            make_closed_loop_sim,
        )

        m2 = make_dnn2()
        like = m2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
        p2 = load_params(os.path.join(ART, "nn3_1"), like=like)
        cfg = SolverConfig(horizon=50, max_iters=45, tol=1e-9, gtol=1e-7)
        sim = make_closed_loop_sim(m2, solver_cfg=cfg, steps=500)
        scens = sample_scenarios(jax.random.PRNGKey(77), 2)
        keys = jax.random.split(jax.random.PRNGKey(78), 2)

        def one(s, k):
            return evaluate_closed_loop(sim(p2, s, k), s[3:6])

        trav, margin, final_d = jax.jit(jax.vmap(one))(scens, keys)
        assert np.asarray(trav).astype(bool).any(), (
            f"neither scenario traversed: margins {np.asarray(margin)}, "
            f"final dists {np.asarray(final_d)}"
        )
