"""Behavioral closed-loop tests (SURVEY.md section 4 anchor 6, VERDICT r1
item 8): assert the full L2->L7 stack — window inputs -> policy -> window
-frame MPC -> 100 Hz plant — actually FLIES THROUGH THE GATE when the policy
supplies good decision variables, without needing a trained network.

The reference never asserts this anywhere; its only closed-loop evidence is
eyeballed animations (main.py:117-129).  Here an *oracle policy* stands in
for DNN2: traversal pose at the gate center with zero rotation (adequate for
a wide, lightly-pitched gate) and a traversal time that counts down with the
window-frame normal distance — exactly the countdown structure DNN2 is
trained to produce (nn_train_2.py:81-83 labels t - 0.1*i).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import (
    CostWeights,
    GateMotionConfig,
    QuadParams,
    SolverConfig,
)
from learningagileflight_se3.sim.closed_loop import (
    evaluate_closed_loop,
    make_closed_loop_sim,
)


class OraclePolicy:
    """DNN2 stand-in with the same `.apply(params, inp)` contract
    (models/mlp.py make_dnn2): 18-dim window input -> 7 decision variables.

    out[0:3] = 0 (traverse the gate center; the window-frame MPC's traversal
    cost is centered at the origin), out[3:6] = 0 (level attitude), and
    out[6] = -rel_y / speed — the approach side of the main-variant scenarios
    has rel_y < 0 (start offset (0,-9,0) vs window normal ay=+y), so t is
    positive on approach, counts down toward the plane, and goes negative
    after crossing (which parks the Gaussian traversal weight before the
    horizon and leaves pure goal tracking, the same post-crossing behavior a
    trained DNN2's t - 0.1*i countdown produces)."""

    def __init__(self, speed: float = 2.5):
        self.speed = speed

    def apply(self, params, inp):
        rel_y = inp[..., 1]
        t = -rel_y / self.speed
        zeros = jnp.zeros(inp.shape[:-1] + (6,), inp.dtype)
        return jnp.concatenate([zeros, t[..., None]], axis=-1)


def _run_sim(scenario, motion_cfg, steps=400, speed=2.5, key=11):
    policy = OraclePolicy(speed=speed)
    cfg = SolverConfig(horizon=50, max_iters=30, tol=1e-9, gtol=1e-7)
    sim = jax.jit(
        make_closed_loop_sim(
            policy, QuadParams(), CostWeights(), cfg,
            motion_cfg=motion_cfg, steps=steps,
        )
    )
    scen = jnp.asarray(scenario)
    log = sim({}, scen, jax.random.PRNGKey(key))
    return log, evaluate_closed_loop(log, np.asarray(scenario[3:6]))


class TestOraclePolicyTraversal:
    @pytest.mark.slow
    def test_static_gate_traversal(self):
        """Static wide gate, mild pitch: the oracle policy must traverse
        inside the corners with positive clearance and then close on the
        goal.  Pins L2 (dynamics/costs) -> L3 (solver) -> L7 (closed loop)
        behaviorally — no network, no training."""
        scenario = np.array([0.0, -8.0, 0.0,   # start
                             0.0, 6.0, 0.0,    # goal
                             0.0,              # yaw
                             1.2,              # gate width (wide)
                             0.15])            # gate pitch (mild)
        static = GateMotionConfig(velocity=(0.0, 0.0, 0.0), omega_y=0.0,
                                  noise_std=0.0)
        log, (trav, margin, final_d) = _run_sim(scenario, static)
        states = np.asarray(log.states)
        assert np.all(np.isfinite(states)), "sim diverged"
        assert bool(trav), "oracle policy failed to traverse a static gate"
        assert float(margin) > 0.05, f"clearance too small: {float(margin)}"
        assert float(final_d) < 1.5, f"did not reach the goal: {float(final_d)}"

    @pytest.mark.slow
    def test_moving_gate_traversal(self):
        """Slow-moving, slowly-rotating gate: the 10 Hz replanning loop with
        the t-ahead gate prediction (main.py:86-88 semantics) must still put
        the quad through the window."""
        scenario = np.array([0.0, -8.0, 0.0, 0.0, 6.0, 0.0, 0.0, 1.2, 0.1])
        moving = GateMotionConfig(velocity=(0.3, 0.1, 0.1), omega_y=0.3,
                                  noise_std=0.0)
        log, (trav, margin, final_d) = _run_sim(scenario, moving)
        assert np.all(np.isfinite(np.asarray(log.states))), "sim diverged"
        assert bool(trav), "oracle policy failed to traverse a moving gate"
        assert float(margin) > 0.0


class TestEvaluateClosedLoopDirections:
    def test_crossing_detected_both_directions(self):
        """The sampled scenarios fly -y -> +y (sampler offsets quad_nn.py:
        21-26) while the window normal ay points +y: a crossing must be
        detected regardless of direction (regression: r1 only counted
        + -> - crossings, so every real traversal scored False)."""
        from learningagileflight_se3.geometry.gate import gate_from_width
        from learningagileflight_se3.sim.closed_loop import ClosedLoopLog

        N = 60
        pts = np.asarray(gate_from_width(jnp.asarray(1.0)))

        def make_log(y0, y1):
            ys = np.linspace(y0, y1, N + 1)
            states = np.zeros((N + 1, 13))
            states[:, 1] = ys
            states[:, 6] = 1.0
            return ClosedLoopLog(
                states=jnp.asarray(states),
                controls=jnp.zeros((N + 1, 4)),
                torques=jnp.zeros((N + 1, 4)),
                hl_variables=jnp.zeros((N + 1, 7)),
                tra_times=jnp.zeros(N),
                abs_tra_times=jnp.zeros(N),
                times=jnp.zeros(N),
                pitches=jnp.zeros(N),
                gate_moves=jnp.asarray(np.tile(pts[None], (N + 1, 1, 1))),
                solver_iters=jnp.zeros(N, jnp.int32),
                gate_vel_used=jnp.zeros((N, 4)),
            )

        for y0, y1 in [(-5.0, 5.0), (5.0, -5.0)]:
            trav, margin, _ = evaluate_closed_loop(
                make_log(y0, y1), np.array([0.0, y1, 0.0])
            )
            assert bool(trav), f"crossing {y0}->{y1} not detected"
            assert float(margin) == pytest.approx(0.5)

    def test_nonfinite_states_never_traverse(self):
        """A diverged sim (NaN states) must score traversed=False, not
        crash or return a spurious crossing."""
        from learningagileflight_se3.geometry.gate import gate_from_width
        from learningagileflight_se3.sim.closed_loop import ClosedLoopLog

        N = 20
        pts = np.asarray(gate_from_width(jnp.asarray(1.0)))
        states = np.full((N + 1, 13), np.nan)
        states[:, 6] = 1.0
        log = ClosedLoopLog(
            states=jnp.asarray(states),
            controls=jnp.zeros((N + 1, 4)),
            torques=jnp.zeros((N + 1, 4)),
            hl_variables=jnp.zeros((N + 1, 7)),
            tra_times=jnp.zeros(N),
            abs_tra_times=jnp.zeros(N),
            times=jnp.zeros(N),
            pitches=jnp.zeros(N),
            gate_moves=jnp.asarray(np.tile(pts[None], (N + 1, 1, 1))),
            solver_iters=jnp.zeros(N, jnp.int32),
            gate_vel_used=jnp.zeros((N, 4)),
        )
        trav, _, _ = evaluate_closed_loop(log, np.array([0.0, 5.0, 0.0]))
        assert not bool(trav)
