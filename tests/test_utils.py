"""Profiling and checkpoint utility tests (SURVEY.md section 5 subsystems)."""

import os

import numpy as np
import jax
import jax.numpy as jnp


class TestStageTimer:
    def test_accumulates_and_reports(self):
        from learningagileflight_se3.utils.profiling import StageTimer

        timer = StageTimer()
        for _ in range(3):
            with timer("compute"):
                x = timer.block(jnp.ones((64, 64)) @ jnp.ones((64, 64)))
        with timer("other"):
            pass
        lines = []
        totals = timer.report(log_fn=lines.append)
        assert set(totals) == {"compute", "other"}
        assert timer.counts["compute"] == 3
        assert totals["compute"] > 0
        assert len(lines) == 2 and "compute" in lines[0]

    def test_device_trace_writes(self, tmp_path):
        from learningagileflight_se3.utils.profiling import device_trace

        d = str(tmp_path / "trace")
        with device_trace(d):
            jax.block_until_ready(jnp.arange(8.0) * 2.0)
        found = any(f for _, _, fs in os.walk(d) for f in fs)
        assert found, "no trace files written"

    def test_device_trace_none_is_noop(self):
        from learningagileflight_se3.utils.profiling import device_trace

        with device_trace(None):
            pass


class TestCheckpoint:
    def test_params_roundtrip(self, tmp_path):
        from learningagileflight_se3.utils.checkpoint import (
            load_params,
            save_params,
        )

        tree = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}
        p = str(tmp_path / "ck")
        save_params(p, tree)
        back = load_params(p, like=tree)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_train_state_roundtrip(self, tmp_path):
        import optax

        from learningagileflight_se3.utils.checkpoint import (
            load_train_state,
            save_train_state,
            train_state_exists,
        )

        params = {"w": jnp.ones((4, 4))}
        opt = optax.adam(1e-3)
        opt_state = opt.init(params)
        p = str(tmp_path / "state")
        assert not train_state_exists(p)
        save_train_state(p, params, opt_state, epoch=7)
        assert train_state_exists(p)
        p2, os2, e2 = load_train_state(p, params, opt_state)
        assert e2 == 7
        np.testing.assert_array_equal(np.asarray(p2["w"]), np.ones((4, 4)))
        for a, b in zip(jax.tree_util.tree_leaves(opt_state), jax.tree_util.tree_leaves(os2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_train_state_resume_continues_adam(self, tmp_path):
        """A run saved mid-way and resumed from the .npz takes exactly the
        steps an uninterrupted run takes: params, Adam moments and the step
        count all survive the file, bit for bit."""
        import optax

        from learningagileflight_se3.utils.checkpoint import (
            load_train_state,
            save_train_state,
        )

        opt = optax.adam(1e-2)
        loss = lambda p: jnp.sum((p["w"] - 3.0) ** 2) + jnp.sum(p["b"] ** 2)

        def steps(p, s, n):
            for _ in range(n):
                u, s = opt.update(jax.grad(loss)(p), s, p)
                p = optax.apply_updates(p, u)
            return p, s

        p0 = {"w": jnp.linspace(0.0, 1.0, 6).reshape(2, 3), "b": jnp.ones(3)}
        p_full, s_full = steps(p0, opt.init(p0), 6)
        p_half, s_half = steps(p0, opt.init(p0), 3)
        path = str(tmp_path / "run" / "state")
        save_train_state(path, p_half, s_half, epoch=3)
        p_r, s_r, e = load_train_state(path, p0, opt.init(p0))
        assert e == 3
        p_res, s_res = steps(p_r, s_r, 3)
        for a, b in zip(jax.tree_util.tree_leaves((p_full, s_full)),
                        jax.tree_util.tree_leaves((p_res, s_res))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_npz_layout_and_like_checks(self, tmp_path):
        """Leaves are stored under their tree paths; a restore against a
        tree of another shape, or with leaves missing, is refused."""
        import pytest

        from learningagileflight_se3.utils.checkpoint import (
            load_params,
            save_params,
        )

        tree = {"params": {"Dense_0": {"kernel": jnp.ones((2, 3)),
                                       "bias": jnp.zeros(3)}}}
        p = str(tmp_path / "ck")
        save_params(p, tree)
        with np.load(p + ".npz") as z:
            assert sorted(z.files) == ["params/Dense_0/bias",
                                       "params/Dense_0/kernel"]
        bad = {"params": {"Dense_0": {"kernel": jnp.ones((3, 3)),
                                      "bias": jnp.zeros(3)}}}
        with pytest.raises(ValueError):
            load_params(p, like=bad)
        with pytest.raises(KeyError):
            load_params(p, like={"params": {"Dense_1": {"bias": jnp.zeros(3)}}})


class TestPlainMLP:
    def test_shipped_dnn2_matches_recorded_outputs(self):
        """The plain-JAX MLP applied to the shipped artifacts/nn3_1.npz gives
        the outputs recorded from the original implementation when the
        checkpoint was converted (tests/data/nn3_1_flax_outputs.npz)."""
        from learningagileflight_se3.models.mlp import make_dnn2
        from learningagileflight_se3.utils.checkpoint import load_params

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        m2 = make_dnn2()
        like = m2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
        p2 = load_params(os.path.join(root, "artifacts", "nn3_1"), like=like)
        with np.load(os.path.join(root, "tests", "data",
                                  "nn3_1_flax_outputs.npz")) as rec:
            out = m2.apply(p2, jnp.asarray(rec["inputs"]))
            np.testing.assert_allclose(np.asarray(out), rec["outputs"],
                                       rtol=1e-6, atol=1e-6)

    def test_init_tree_and_torch_bounds(self):
        """init builds the Dense_<i> kernel/bias tree with the PyTorch
        nn.Linear bounds U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
        from learningagileflight_se3.models.mlp import make_dnn1

        p = make_dnn1().init(jax.random.PRNGKey(3), jnp.zeros((1, 9)))
        shapes = jax.tree_util.tree_map(lambda a: a.shape, p)
        assert shapes == {"params": {
            "Dense_0": {"kernel": (9, 64), "bias": (64,)},
            "Dense_1": {"kernel": (64, 64), "bias": (64,)},
            "Dense_2": {"kernel": (64, 7), "bias": (7,)},
        }}
        for name, fan_in in (("Dense_0", 9), ("Dense_1", 64), ("Dense_2", 64)):
            for leaf in p["params"][name].values():
                assert float(jnp.abs(leaf).max()) <= 1.0 / np.sqrt(fan_in)
