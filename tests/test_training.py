"""Training-pipeline tests: samplers match reference distributions/labels,
each stage's step runs and learns on tiny shapes, and the sharded RL step
produces identical results to the unsharded one on an 8-device CPU mesh
(SURVEY.md section 4 anchors 4-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from learningagileflight_se3.config import (
    CostWeights,
    QuadParams,
    RewardConfig,
    SamplerConfig,
    SolverConfig,
)
from learningagileflight_se3.models.mlp import make_dnn1, make_dnn2, surrogate_inner_loss
from learningagileflight_se3.models.sampler import (
    pretrain_label,
    sample_general_scenario,
    sample_random_gate,
    sample_scenario,
    sample_scenarios,
    scenario_to_problem,
)
from learningagileflight_se3.parallel.mesh import make_mesh, replicate, shard_batch
from learningagileflight_se3.train.imitation import (
    make_imitation_collect,
    make_imitation_train_step,
)
from learningagileflight_se3.train.pretrain import make_pretrain_step
from learningagileflight_se3.train.rl import make_rl_train_step

TINY = SolverConfig(horizon=6, max_iters=8)
PQ, CW, RC, SC = QuadParams(), CostWeights(), RewardConfig(), SamplerConfig()


class TestSamplers:
    def test_scenario_ranges(self):
        scen = np.asarray(sample_scenarios(jax.random.PRNGKey(0), 2000))
        # ranges of quad_nn.py:18-48
        assert scen[:, 0].min() >= -5 and scen[:, 0].max() <= 5
        assert scen[:, 1].min() >= -14 and scen[:, 1].max() <= -4
        assert scen[:, 4].min() >= 4 and scen[:, 4].max() <= 8
        assert np.abs(scen[:, 6]).max() <= 0.1
        assert scen[:, 7].min() >= 0.5 and scen[:, 7].max() <= 1.25
        assert np.abs(scen[:, 8]).max() <= np.pi / 2 + 1e-6
        # pitch-width coupling: |pitch| >= clip(1.3*(1.2-w), 0, pi/3)
        min_angle = np.clip(1.3 * (1.2 - scen[:, 7]), 0, np.pi / 3)
        assert np.all(np.abs(scen[:, 8]) >= min_angle - 1e-9)
        # roughly bimodal: both signs occur
        assert (scen[:, 8] > 0).mean() > 0.3 and (scen[:, 8] < 0).mean() > 0.3

    def test_random_gate(self):
        """gene_gate geometry (quad_nn.py:60-74): corner1 at origin, corner3
        on +x with diagonal in [1.5, 3], corner2 above, corner4 below."""
        g = np.asarray(jax.vmap(sample_random_gate)(
            jax.random.split(jax.random.PRNGKey(0), 500)))
        np.testing.assert_allclose(g[:, 0], 0.0)
        assert np.all(g[:, 2, 0] >= 1.5) and np.all(g[:, 2, 0] <= 3.0)
        np.testing.assert_allclose(g[:, :, 1], 0.0, atol=1e-12)  # planar (y=0)
        assert np.all(g[:, 1, 2] >= 0) and np.all(g[:, 3, 2] <= 0)
        assert np.all(g[:, 1, 2] <= g[:, 2, 0]) and np.all(g[:, 3, 2] >= -g[:, 2, 0])

    def test_general_scenario(self):
        """con_sample (quad_nn.py:77-115): 25-dim layout with unit quaternion,
        spherical init position at radius in [3, 16], rigid gate placement."""
        s = np.asarray(jax.vmap(sample_general_scenario)(
            jax.random.split(jax.random.PRNGKey(1), 500)))
        assert s.shape == (500, 25)
        r = np.linalg.norm(s[:, 0:3], axis=-1)
        assert r.min() >= 3.0 - 1e-9 and r.max() <= 16.0 + 1e-9
        # theta clipped to [pi/4, 3pi/4] -> |z| <= r/sqrt(2)
        assert np.all(np.abs(s[:, 2]) <= r / np.sqrt(2) + 1e-9)
        q = s[:, 18:22]
        np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-12)
        # gate corners are a rigidly-transformed gene_gate: check the diagonal
        # length |corner3 - corner1| stays in [1.5, 3]
        gate = s[:, 3:15].reshape(-1, 4, 3)
        dia = np.linalg.norm(gate[:, 2] - gate[:, 0], axis=-1)
        assert dia.min() >= 1.5 - 1e-9 and dia.max() <= 3.0 + 1e-9

    def test_pretrain_label(self):
        scen = jnp.zeros(9).at[0:3].set(jnp.asarray([0.0, -9.0, 0.0]))
        lab = np.asarray(pretrain_label(scen))
        # t = clip(round(9/4, 1), 2, 4) = 2.2 — round-half-to-even, matching
        # Python round() in the reference (quad_nn.py:56)
        np.testing.assert_allclose(lab, [0, 0, 0, 0, 0, 0, 2.2], atol=1e-9)
        far = jnp.zeros(9).at[0:3].set(jnp.asarray([20.0, 0.0, 0.0]))
        assert float(pretrain_label(far)[6]) == 4.0

    def test_scenario_to_problem(self):
        scen = jnp.asarray([1.0, -8.0, 0.5, 0.0, 6.0, 0.0, 0.1, 1.0, 0.4])
        prob = scenario_to_problem(scen)
        assert prob["x0"].shape == (13,)
        np.testing.assert_allclose(np.asarray(prob["x0"][0:3]), [1, -8, 0.5])
        np.testing.assert_allclose(
            np.asarray(prob["x0"][6:10]),
            [np.cos(0.05), 0, 0, np.sin(0.05)],
            atol=1e-12,
        )
        assert prob["gate_pts"].shape == (4, 3)


class TestPretrain:
    def test_loss_decreases(self):
        model = make_dnn1()
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        opt = optax.adam(1e-3)
        opt_state = opt.init(params)
        step = jax.jit(make_pretrain_step(model, opt), static_argnums=(3,))
        key = jax.random.PRNGKey(1)
        losses = []
        for i in range(60):
            key, k = jax.random.split(key)
            params, opt_state, loss = step(params, opt_state, k, 64)
            losses.append(float(loss))
        assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10])


class TestRLStep:
    def _setup(self):
        model = make_dnn1()
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        opt = optax.adam(1e-4)
        return model, params, opt, opt.init(params)

    def test_unsharded_step_runs(self):
        model, params, opt, opt_state = self._setup()
        step = make_rl_train_step(model, opt, PQ, CW, TINY, RC)
        scen = sample_scenarios(jax.random.PRNGKey(2), 4)
        p2, os2, mean_r, rewards = step(params, opt_state, scen)
        assert rewards.shape == (4,)
        assert np.isfinite(float(mean_r))
        # params actually changed
        diff = jax.tree_util.tree_reduce(
            lambda a, b: a + float(jnp.abs(b).sum()),
            jax.tree_util.tree_map(lambda a, b: a - b, p2, params),
            0.0,
        )
        assert diff > 0

    def test_sharded_matches_unsharded(self):
        assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
        model, params, opt, opt_state = self._setup()
        scen = sample_scenarios(jax.random.PRNGKey(3), 8)

        step_u = make_rl_train_step(model, opt, PQ, CW, TINY, RC)
        pu, _, mru, ru = step_u(params, opt_state, scen)

        mesh = make_mesh(jax.devices()[:8])
        step_s = make_rl_train_step(model, opt, PQ, CW, TINY, RC, mesh=mesh)
        ps, _, mrs, rs = step_s(
            replicate(mesh, params), replicate(mesh, opt_state), shard_batch(mesh, scen)
        )
        np.testing.assert_allclose(np.asarray(ru), np.asarray(rs), rtol=1e-10)
        # params are f32; per-shard summation + psum reorders the reduction,
        # so allow f32-level noise through the Adam update
        for a, b in zip(jax.tree_util.tree_leaves(pu), jax.tree_util.tree_leaves(ps)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=3e-4)

    def test_analytic_mode_runs(self):
        model, params, opt, opt_state = self._setup()
        step = make_rl_train_step(model, opt, PQ, CW, TINY, RC, grad_mode="analytic")
        scen = sample_scenarios(jax.random.PRNGKey(4), 2)
        _, _, mean_r, rewards = step(params, opt_state, scen)
        assert np.isfinite(float(mean_r))


class TestImitation:
    def test_collect_shapes_and_labels(self):
        model1 = make_dnn1()
        p1 = model1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        collect = jax.jit(make_imitation_collect(model1, PQ, CW, TINY))
        scen = sample_scenarios(jax.random.PRNGKey(5), 3)
        inputs, labels = collect(p1, scen)
        H = TINY.horizon
        assert inputs.shape == (3 * H, 18)
        assert labels.shape == (3 * H, 7)
        # countdown label: t decreases by 0.1 per step (nn_train_2.py:83)
        lab0 = np.asarray(labels[:H, 6])
        np.testing.assert_allclose(np.diff(lab0), -0.1, atol=1e-6)
        # width/pitch passthrough (nn_train_2.py:79)
        np.testing.assert_allclose(
            np.asarray(inputs[:H, 16:18]), np.tile(np.asarray(scen[0, 7:9]), (H, 1)),
            atol=1e-7,
        )

    @pytest.mark.slow
    def test_train_step_decreases_loss(self):
        model1, model2 = make_dnn1(), make_dnn2()
        p1 = model1.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        p2 = model2.init(jax.random.PRNGKey(1), jnp.zeros((1, 18)))
        collect = jax.jit(make_imitation_collect(model1, PQ, CW, TINY))
        inputs, labels = collect(p1, sample_scenarios(jax.random.PRNGKey(6), 2))
        opt = optax.adam(1e-3)
        os2 = opt.init(p2)
        step = jax.jit(make_imitation_train_step(model2, opt))
        losses = []
        for _ in range(50):
            p2, os2, loss = step(p2, os2, inputs, labels)
            losses.append(float(loss))
        assert losses[-1] < 0.5 * losses[0]


class TestSurrogateLoss:
    def test_gradient_is_dp_weighted(self):
        """grad of <dp, out> w.r.t. params == dp-weighted output Jacobian —
        the reference's myloss chain rule (quad_nn.py:141-145)."""
        model = make_dnn1()
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        x = jnp.ones((2, 9))
        dp = jnp.asarray(np.random.default_rng(0).normal(size=(2, 7)))

        g1 = jax.grad(lambda p: surrogate_inner_loss(model.apply(p, x), dp))(params)
        g2 = jax.grad(lambda p: jnp.sum(model.apply(p, x) * dp))(params)
        for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


class TestCheckpointResume:
    def test_resume_matches_uninterrupted(self, tmp_path):
        """run_rl_training with checkpoint_every=1 interrupted after 2 of 4
        epochs and resumed reproduces the uninterrupted 4-epoch params —
        optimizer moments and the per-epoch sampling stream survive the
        restart (the reference cannot do this: whole-model pickles only,
        SURVEY.md section 5)."""
        from learningagileflight_se3.train.rl import run_rl_training

        model = make_dnn1()
        params0 = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        key = jax.random.PRNGKey(7)
        kw = dict(batch_size=2, lr=1e-4, params_q=PQ, weights=CW,
                  solver_cfg=TINY, reward_cfg=RC, log_fn=lambda *a: None)

        _, p_full, r_full = run_rl_training(key, params0, epochs=4, **kw)

        ck = str(tmp_path / "rl_ck")
        run_rl_training(key, params0, epochs=2, checkpoint_dir=ck,
                        checkpoint_every=1, **kw)
        _, p_res, r_res = run_rl_training(
            key, params0, epochs=4, checkpoint_dir=ck, checkpoint_every=1,
            resume=True, **kw,
        )
        assert len(r_res) == 2  # only the remaining epochs ran
        np.testing.assert_allclose(r_res, r_full[2:], rtol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(p_full),
                        jax.tree_util.tree_leaves(p_res)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)

    @pytest.mark.slow
    def test_nonfinite_signal_is_masked(self):
        """A scenario whose learning signal goes non-finite must not poison
        the batch gradient (failure-detection gap of the reference)."""
        from learningagileflight_se3.train.rl import make_rl_train_step

        model = make_dnn1()
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        opt = optax.adam(1e-4)
        step = make_rl_train_step(model, opt, PQ, CW, TINY, RC)
        scen = sample_scenarios(jax.random.PRNGKey(2), 4)
        # poison one scenario with a NaN start position -> NaN solve/reward
        scen = scen.at[1, 0].set(jnp.nan)
        p2, _, _, rewards = step(params, opt.init(params), scen)
        assert not np.isfinite(np.asarray(rewards)[1])
        for leaf in jax.tree_util.tree_leaves(p2):
            assert np.isfinite(np.asarray(leaf)).all()


class TestShardedFaultInjection:
    """Failure masking proven UNDER shard_map, not just single-device
    (VERDICT r2 stretch item: chaos-test the sharded RL step).  Three
    injected faults — NaN state, off-distribution magnitude, exploding
    warm-start-scale position — each on a different shard of an 8-device
    mesh; the masked sharded update must (a) stay finite and (b) equal the
    masked unsharded update bit-for-near-bit."""

    def _setup(self):
        model = make_dnn1()
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
        opt = optax.adam(1e-4)
        return model, params, opt, opt.init(params)

    def _poisoned_batch(self):
        scen = sample_scenarios(jax.random.PRNGKey(11), 8)
        scen = scen.at[1, 0].set(jnp.nan)       # NaN start (shard 1)
        scen = scen.at[3, :3].set(1e6)          # absurd start position (shard 3)
        scen = scen.at[6, 3:6].set(-1e6)        # absurd goal (shard 6)
        return scen

    def test_sharded_masked_update_finite_and_matches_unsharded(self):
        assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
        model, params, opt, opt_state = self._setup()
        scen = self._poisoned_batch()

        step_u = make_rl_train_step(model, opt, PQ, CW, TINY, RC)
        pu, _, mru, ru = step_u(params, opt_state, scen)

        mesh = make_mesh(jax.devices()[:8])
        step_s = make_rl_train_step(model, opt, PQ, CW, TINY, RC, mesh=mesh)
        ps, _, mrs, rs = step_s(
            replicate(mesh, params), replicate(mesh, opt_state),
            shard_batch(mesh, scen),
        )
        # the NaN lane is reported non-finite on both paths
        assert not np.isfinite(np.asarray(ru)[1])
        assert not np.isfinite(np.asarray(rs)[1])
        # masked updates are finite despite three poisoned shards
        for leaf in jax.tree_util.tree_leaves(ps):
            assert np.isfinite(np.asarray(leaf)).all()
        # sharded == unsharded with failures in the batch (the psum over
        # masked signals must not reintroduce the poison)
        for a, b in zip(jax.tree_util.tree_leaves(pu),
                        jax.tree_util.tree_leaves(ps)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=3e-4)

    def test_clean_lanes_unaffected_by_poisoned_shardmates(self):
        """The healthy scenarios' rewards must be identical whether or not
        poisoned scenarios share the batch (per-lane isolation)."""
        model, params, opt, opt_state = self._setup()
        clean = sample_scenarios(jax.random.PRNGKey(11), 8)
        poisoned = self._poisoned_batch()
        mesh = make_mesh(jax.devices()[:8])
        step = make_rl_train_step(model, opt, PQ, CW, TINY, RC, mesh=mesh)
        _, _, _, r_clean = step(
            replicate(mesh, params), replicate(mesh, opt_state),
            shard_batch(mesh, clean),
        )
        _, _, _, r_mixed = step(
            replicate(mesh, params), replicate(mesh, opt_state),
            shard_batch(mesh, poisoned),
        )
        healthy = [0, 2, 4, 5, 7]
        np.testing.assert_allclose(
            np.asarray(r_clean)[healthy], np.asarray(r_mixed)[healthy],
            rtol=1e-6,
        )


class TestBatchedFDSignal:
    def test_batched_fd_matches_vmapped(self):
        """make_fd_gradient_batched must equal vmap(make_fd_gradient)
        exactly (same solves, different batching) — the RL step's
        throughput path may not change the learning signal."""
        from learningagileflight_se3.policy import (
            make_fd_gradient,
            make_fd_gradient_batched,
        )

        fd1 = make_fd_gradient(PQ, CW, TINY, RC)
        fdb = jax.jit(make_fd_gradient_batched(PQ, CW, TINY, RC))
        scen = sample_scenarios(jax.random.PRNGKey(9), 4)
        probs = jax.vmap(scenario_to_problem)(scen)
        tra_pos = jnp.zeros((4, 3))
        tra_ang = jax.random.normal(jax.random.PRNGKey(1), (4, 3)) * 0.2
        t = jnp.full((4,), 0.4)
        u_last = jnp.zeros((4, 4))

        g_v, r_v = jax.jit(jax.vmap(
            lambda x0, gl, pts, tp, ta, ti: fd1(x0, u_last[0], gl, pts, tp, ta, ti)
        ))(probs["x0"], probs["goal_pos"], probs["gate_pts"],
           tra_pos, tra_ang, t)
        g_b, r_b = fdb(probs["x0"], u_last, probs["goal_pos"],
                       probs["gate_pts"], tra_pos, tra_ang, t)
        np.testing.assert_allclose(np.asarray(r_b), np.asarray(r_v), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(g_b), np.asarray(g_v),
                                   rtol=1e-10, atol=1e-12)

    def test_batched_analytic_matches_vmapped(self):
        """make_analytic_gradient_batched must equal
        vmap(make_analytic_gradient): same forward solves (the batched XLA
        backend is the vmapped single solver on CPU) and the same
        implicit-function VJP kernel."""
        from learningagileflight_se3.policy import (
            make_analytic_gradient,
            make_analytic_gradient_batched,
        )

        ana1 = make_analytic_gradient(PQ, CW, TINY, RC)
        anab = jax.jit(make_analytic_gradient_batched(PQ, CW, TINY, RC))
        scen = sample_scenarios(jax.random.PRNGKey(21), 3)
        probs = jax.vmap(scenario_to_problem)(scen)
        tra_pos = jnp.zeros((3, 3))
        tra_ang = jax.random.normal(jax.random.PRNGKey(2), (3, 3)) * 0.2
        t = jnp.full((3,), 0.4)
        u_last = jnp.zeros((3, 4))

        g_v, r_v = jax.jit(jax.vmap(
            lambda x0, gl, pts, tp, ta, ti: ana1(x0, u_last[0], gl, pts, tp, ta, ti)
        ))(probs["x0"], probs["goal_pos"], probs["gate_pts"],
           tra_pos, tra_ang, t)
        g_b, r_b = anab(probs["x0"], u_last, probs["goal_pos"],
                        probs["gate_pts"], tra_pos, tra_ang, t)
        np.testing.assert_allclose(np.asarray(r_b), np.asarray(r_v), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(g_b), np.asarray(g_v),
                                   rtol=1e-8, atol=1e-12)
