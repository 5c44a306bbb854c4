"""Stage 3 — imitation learning of DNN2 from DNN1's MPC rollouts
(reference nn_train_2.py).

Reference: 16 forked processes each run one IPOPT solve to produce a 51x13
teacher trajectory (nn_train_2.py:29-40), then every state along the
trajectory is relabeled with the teacher's output and a counted-down
traversal time out[6] - 0.1*i (nn_train_2.py:76-83), trained with MSE at lr
1e-6.

Here the rollout collection is the batched MPC solver (one XLA call
for the whole scenario batch) and the 50x relabeling is a reshape.  The
reference's world-frame-input quirk (nn_train_2.py:77 trains DNN2 on
world-frame states while deployment feeds window-frame states, main.py:93) is
exposed as `window_frame`: False replicates the exercised reference behavior,
True is the arguably-intended variant (SURVEY.md section 7 hard-part 6).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import optax

from learningagileflight_se3.config import (
    CostWeights,
    QuadParams,
    SamplerConfig,
    SolverConfig,
)
from learningagileflight_se3.core.rotations import (
    dcm_to_quat,
    quat_mul,
    rodrigues_to_quat,
)
from learningagileflight_se3.geometry.gate import (
    final_to_window,
    gate_centroid,
    gate_frame,
    transform_state_to_window,
)
from learningagileflight_se3.models.mlp import make_dnn1, make_dnn2
from learningagileflight_se3.models.sampler import sample_scenarios, scenario_to_problem


def traversal_pose_to_window(gate_pts, tra_pos, tra_ang):
    """Teacher traversal pose (world frame, as DNN1 emits it and the RL-stage
    MPC consumes it) -> window frame, the frame the DEPLOYED MPC solves in
    (sim/closed_loop.py replan: solve(window state, ..., out[0:3], out[3:6])).

    Position: the usual rigid transform.  Attitude: the desired body->world
    DCM R_tra maps to a desired body->window DCM R_wg @ R_tra — matching
    transform_state_to_window's quaternion convention — re-expressed as the
    Gibbs/Rodrigues vector q_vec/q_w that Rd2Rp inverts (quad_policy.py:10-13:
    theta = 2*atan(|w|) means |w| = tan(theta/2), i.e. w IS the Gibbs vector).
    """
    R_wg = gate_frame(gate_pts)
    c = gate_centroid(gate_pts)
    pos_w = R_wg @ (tra_pos - c)
    q_tra = rodrigues_to_quat(tra_ang)          # world-frame desired attitude
    q_win = quat_mul(dcm_to_quat(R_wg), q_tra)  # window-frame desired attitude
    # Gibbs vector = q_vec / q_w; flip to the q_w > 0 hemisphere first (the
    # two quaternion signs are the same rotation) and guard q_w ~ 0 (a 180
    # degree desired attitude never occurs for gate traversals).
    q_win = jnp.where(q_win[0] < 0, -q_win, q_win)
    ang_w = q_win[1:4] / jnp.maximum(q_win[0], 1e-6)
    return pos_w, ang_w


def make_imitation_collect(
    model1,
    params_q: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    window_frame: bool = False,
    consistent_labels: bool = False,
):
    """collect(nn1_params, scenarios (B,9)) -> (inputs (B*H, 18), labels (B*H, 7)).

    Per scenario: teacher DNN1 output -> one MPC solve -> relabel every step i
    with [teacher_out(6), t - 0.1*i] (nn_train_2.py:81-83).

    consistent_labels=True (requires window_frame) additionally maps the
    teacher's traversal pose into the window frame, so the labels live in the
    SAME frame the deployed MPC interprets DNN2's output in.  The reference
    trains on world-frame poses and deploys window-frame (nn_train_2.py:81 vs
    main.py:96-106) — near-consistent only because its static training gates
    sit at the origin; the pitch rotation is still unaccounted for."""
    if consistent_labels and not window_frame:
        raise ValueError("consistent_labels requires window_frame=True")
    from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver

    bsolve = make_batched_mpc_solver(params_q, weights, solver_cfg,
                                     return_gains=False)
    H = solver_cfg.horizon
    dt = solver_cfg.dt

    def one(nn1_params, scen, states):
        """Post-solve relabeling for one scenario; `states` (H,13) is the
        teacher MPC trajectory, steps 0..H-1 (nn_train_2.py:74-77)."""
        prob = scenario_to_problem(scen)
        out = model1.apply(nn1_params, scen)
        if window_frame:
            states = jax.vmap(
                lambda s: transform_state_to_window(prob["gate_pts"], s)
            )(states)
            final = final_to_window(prob["gate_pts"], prob["goal_pos"])
        else:
            final = prob["goal_pos"]
        if consistent_labels:
            pos_lab, ang_lab = traversal_pose_to_window(
                prob["gate_pts"], out[0:3], out[3:6]
            )
            pose_lab = jnp.concatenate([pos_lab, ang_lab])
        else:
            pose_lab = out[0:6]
        gap = scen[7:9]  # width, pitch (nn_train_2.py:79)
        inputs = jnp.concatenate(
            [
                states,
                jnp.tile(final[None, :], (H, 1)),
                jnp.tile(gap[None, :], (H, 1)),
            ],
            axis=1,
        )  # (H, 18)
        steps = jnp.arange(H, dtype=scen.dtype)
        labels = jnp.concatenate(
            [
                jnp.tile(pose_lab[None, :], (H, 1)),
                (out[6] - steps * dt * 1.0)[:, None],
            ],
            axis=1,
        )  # (H, 7); countdown 0.10 per step (nn_train_2.py:83)
        return inputs, labels

    def collect(nn1_params, scen_b):
        # all B teacher solves as ONE batched solver call (the fused
        # kernels on a GPU, vmapped XLA elsewhere -- identical semantics)
        B = scen_b.shape[0]
        probs = jax.vmap(scenario_to_problem)(scen_b)
        outs = model1.apply(nn1_params, scen_b)
        sols = bsolve(
            probs["x0"], jnp.zeros((B, 4), scen_b.dtype),
            probs["goal_pos"], outs[:, 0:3], outs[:, 3:6], outs[:, 6],
        )
        states = sols.state_traj[:, :H]  # (B, H, 13)
        inputs, labels = jax.vmap(
            lambda s, st: one(nn1_params, s, st))(scen_b, states)
        return inputs.reshape(-1, 18), labels.reshape(-1, 7)

    return collect


def make_imitation_train_step(model2, optimizer):
    """One MSE step over a collected (inputs, labels) batch."""

    def step(nn2_params, opt_state, inputs, labels):
        def loss_fn(p):
            pred = model2.apply(p, inputs)
            return jnp.mean((pred - labels) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(nn2_params)
        updates, opt_state = optimizer.update(grads, opt_state, nn2_params)
        nn2_params = optax.apply_updates(nn2_params, updates)
        return nn2_params, opt_state, loss

    return step


def run_imitation_training(
    key,
    nn1_params,
    epochs: int = 100,
    batch_scenarios: int = 16,
    sgd_passes: int = 4,
    lr: float = 1e-6,
    params_q: QuadParams = QuadParams(),
    weights: CostWeights = CostWeights(),
    solver_cfg: SolverConfig = SolverConfig(),
    sampler_cfg: SamplerConfig = SamplerConfig(),
    window_frame: bool = False,
    consistent_labels: bool = False,
    nn2_params=None,
    lr_schedule: bool = False,
    log_fn=print,
):
    """Full stage-3 driver (hyperparams nn_train_2.py:14-17: 1600 teacher
    trajectories total at 16/epoch; lr 1e-6).

    lr_schedule=True swaps the reference's fixed lr for cosine decay from lr
    to lr/100 over the run — the reference's lr 1e-6 needs ~80k sequential
    SGD steps to move the net; a decayed 1e-3 reaches lower loss in ~1k
    batched steps."""
    model1 = make_dnn1()
    model2 = make_dnn2()
    if nn2_params is None:
        key, ik = jax.random.split(key)
        nn2_params = model2.init(ik, jnp.zeros((1, 18)))
    if lr_schedule:
        sched = optax.cosine_decay_schedule(lr, epochs * sgd_passes, alpha=0.01)
        optimizer = optax.adam(sched)
    else:
        optimizer = optax.adam(lr)
    opt_state = optimizer.init(nn2_params)

    collect = make_imitation_collect(
        model1, params_q, weights, solver_cfg, window_frame, consistent_labels
    )
    step = make_imitation_train_step(model2, optimizer)

    # Device-resident epoch loop (ONE jit dispatch for the whole stage): the
    # reference forks 16 IPOPT processes per epoch and runs a Python SGD loop
    # (nn_train_2.py:29-40,86-99); here teacher collection + the sgd passes
    # scan on-device.
    @jax.jit
    def run_all(nn2_params, opt_state, key):
        def epoch_body(carry, k):
            nn2_params, opt_state = carry
            scen = sample_scenarios(k, batch_scenarios, sampler_cfg)
            inputs, labels = collect(nn1_params, scen)

            def sgd_body(c, _):
                p, o = c
                p, o, loss = step(p, o, inputs, labels)
                return (p, o), loss

            (nn2_params, opt_state), pass_losses = jax.lax.scan(
                sgd_body, (nn2_params, opt_state), None, length=sgd_passes
            )
            return (nn2_params, opt_state), pass_losses[-1]

        keys = jax.random.split(key, epochs)
        (nn2_params, opt_state), losses = jax.lax.scan(
            epoch_body, (nn2_params, opt_state), keys
        )
        return nn2_params, losses

    nn2_params, losses_arr = run_all(nn2_params, opt_state, key)
    losses = [float(l) for l in losses_arr]
    log_fn(f"imitation {epochs} epochs loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    return model2, nn2_params, losses
