"""Stage 2 — differentiable-MPC reinforcement learning of DNN1
(reference deep_learning.py).

Reference structure: 5 restarts x 100 epochs x batch 100, where each sample
forks a process that builds a fresh CasADi NLP and runs 9 IPOPT solves for
the FD gradient (deep_learning.py:24-32,66-72; quad_policy.py:94-112), then
the parent applies one Adam step per sample with the surrogate loss
<dp, out> (deep_learning.py:75-81).

Re-design: the whole batch's 9B probe solves are ONE batched solver call
(policy.make_fd_gradient_batched); per-scenario learning signals dp are
reduced into a
single surrogate-loss gradient (mean over batch replaces the reference's
sequential per-sample Adam steps — documented deviation) and psum'd over
the scenario axis with shard_map.  `grad_mode='analytic'` switches the
learning signal to the implicit-function VJP (1 solve instead of 9 per
scenario).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from learningagileflight_se3.config import (
    CostWeights,
    LearnedGradConfig,
    QuadParams,
    RewardConfig,
    SamplerConfig,
    SolverConfig,
)
from learningagileflight_se3.models.mlp import make_dnn1, surrogate_inner_loss
from learningagileflight_se3.models.sampler import sample_scenarios, scenario_to_problem
from learningagileflight_se3.parallel.mesh import SCENARIO_AXIS
from learningagileflight_se3.policy import (
    make_analytic_gradient_batched,
    make_fd_gradient_batched,
)


def make_rl_train_step(
    model,
    optimizer,
    params_q: QuadParams,
    weights: CostWeights,
    solver_cfg: SolverConfig,
    reward_cfg: RewardConfig,
    grad_cfg: LearnedGradConfig = LearnedGradConfig(),
    mesh: Optional[Mesh] = None,
    grad_mode: str = "fd",
):
    """Build the jitted RL step.

    step(nn_params, opt_state, scenarios (B,9)) ->
        (nn_params, opt_state, mean_reward, rewards (B,))

    When `mesh` is given, the step is shard_map'ed: scenarios sharded over the
    scenario axis, params replicated, gradients psum-reduced over the mesh."""
    if grad_mode == "fd":
        # batched: all 9*B probe solves are ONE batched-solver call, not a
        # stack of per-scenario solver calls —
        # semantics identical to vmap(make_fd_gradient), tested in
        # tests/test_training.py::TestRLStep::test_batched_fd_matches_vmapped
        fdb = make_fd_gradient_batched(
            params_q, weights, solver_cfg, reward_cfg, grad_cfg
        )

        def batch_signals(nn_params, scen_b):
            probs = jax.vmap(scenario_to_problem)(scen_b)
            outs = model.apply(nn_params, scen_b)
            return fdb(
                probs["x0"],
                jnp.zeros((scen_b.shape[0], 4), scen_b.dtype),
                probs["goal_pos"],
                probs["gate_pts"],
                outs[:, 0:3],
                outs[:, 3:6],
                outs[:, 6],
            )

        flip = 1.0  # fd returns the NEGATED ascent gradient already
    elif grad_mode == "analytic":
        # batched like the fd path: one batched solver call forward,
        # vmapped implicit-function VJP backward
        anab = make_analytic_gradient_batched(
            params_q, weights, solver_cfg, reward_cfg, grad_cfg=grad_cfg
        )

        def batch_signals(nn_params, scen_b):
            probs = jax.vmap(scenario_to_problem)(scen_b)
            outs = model.apply(nn_params, scen_b)
            g, rewards = anab(
                probs["x0"],
                jnp.zeros((scen_b.shape[0], 4), scen_b.dtype),
                probs["goal_pos"],
                probs["gate_pts"],
                outs[:, 0:3],
                outs[:, 3:6],
                outs[:, 6],
            )
            return -g, rewards  # match the reference's neg-grad convention

        flip = 1.0
    else:
        raise ValueError(grad_mode)

    def batch_grads(nn_params, scen_b):
        dp, rewards = batch_signals(nn_params, scen_b)
        # failure detection (SURVEY.md section 5): the reference uses IPOPT's
        # output unconditionally (quad_OC.py:174-175) so a diverged solve
        # silently poisons the gradient; here non-finite per-scenario signals
        # are masked out of the update (their reward stays visible in logs).
        valid = (
            jnp.all(jnp.isfinite(dp), axis=-1)
            & jnp.isfinite(rewards)
            & jnp.all(jnp.isfinite(scen_b), axis=-1)
        )
        dp = jnp.where(valid[:, None], dp, 0.0)
        # also zero the inputs of masked rows: with dp = 0 their surrogate
        # term is 0 * d(out)/d(theta), which must be a FINITE zero
        scen_m = jnp.where(valid[:, None], scen_b, 0.0)

        def loss_fn(p):
            outs = model.apply(p, scen_m)
            return flip * surrogate_inner_loss(outs, dp) / scen_b.shape[0]

        grads = jax.grad(loss_fn)(nn_params)
        return grads, rewards

    if mesh is None:

        @jax.jit
        def step(nn_params, opt_state, scen):
            grads, rewards = batch_grads(nn_params, scen)
            updates, opt_state = optimizer.update(grads, opt_state, nn_params)
            nn_params = optax.apply_updates(nn_params, updates)
            return nn_params, opt_state, jnp.mean(rewards), rewards

        return step

    n_shards = mesh.shape[SCENARIO_AXIS]

    def sharded_grads(nn_params, scen_local):
        grads, rewards = batch_grads(nn_params, scen_local)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, SCENARIO_AXIS) / n_shards, grads
        )
        return grads, rewards

    smapped = shard_map(
        sharded_grads,
        mesh=mesh,
        in_specs=(P(), P(SCENARIO_AXIS)),
        out_specs=(P(), P(SCENARIO_AXIS)),
    )

    @jax.jit
    def step(nn_params, opt_state, scen):
        grads, rewards = smapped(nn_params, scen)
        updates, opt_state = optimizer.update(grads, opt_state, nn_params)
        nn_params = optax.apply_updates(nn_params, updates)
        return nn_params, opt_state, jnp.mean(rewards), rewards

    return step


def run_rl_training(
    key,
    pretrained_params,
    epochs: int = 100,
    batch_size: int = 128,
    lr: float = 1e-4,
    params_q: QuadParams = QuadParams(),
    weights: CostWeights = CostWeights(),
    solver_cfg: SolverConfig = SolverConfig(),
    reward_cfg: RewardConfig = RewardConfig(),
    sampler_cfg: SamplerConfig = SamplerConfig(),
    mesh: Optional[Mesh] = None,
    grad_mode: str = "fd",
    lr_schedule: bool = False,
    log_fn=print,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 20,
    resume: bool = False,
):
    """Full stage-2 driver (one restart of deep_learning.py's outer loop;
    hyperparams deep_learning.py:13-16, lr 1e-4).

    With checkpoint_dir set, the FULL training state (params + Adam moments +
    epoch) is checkpointed every checkpoint_every epochs and `resume=True`
    continues mid-run — per-epoch scenario keys are fold_in(key, epoch) so the
    resumed sampling stream is identical to an uninterrupted run."""
    from learningagileflight_se3.utils.checkpoint import (
        load_train_state,
        save_train_state,
        train_state_exists,
    )

    model = make_dnn1()
    if lr_schedule:
        # cosine decay to lr/10: the fixed-lr run plateaus ~epoch 60 with the
        # update noise floor of the clipped FD signal (quad_policy.py:100-105)
        optimizer = optax.adam(optax.cosine_decay_schedule(lr, epochs, alpha=0.1))
    else:
        optimizer = optax.adam(lr)
    opt_state = optimizer.init(pretrained_params)
    nn_params = pretrained_params
    start_epoch = 0
    if checkpoint_dir is not None and resume and train_state_exists(checkpoint_dir):
        nn_params, opt_state, start_epoch = load_train_state(
            checkpoint_dir, nn_params, opt_state
        )
        log_fn(f"rl resume from {checkpoint_dir} at epoch {start_epoch}")
    step = make_rl_train_step(
        model, optimizer, params_q, weights, solver_cfg, reward_cfg,
        mesh=mesh, grad_mode=grad_mode,
    )

    # Device-resident epoch loop: epochs scan inside ONE jit dispatch per
    # checkpoint interval (per-epoch keys stay fold_in(key, epoch), so the
    # sampling stream is bit-identical to the old host loop and to a resumed
    # run).  The reference pays a process fork + 9 IPOPT solves per SAMPLE
    # (deep_learning.py:66-72); here a whole checkpoint interval of training
    # is one XLA program.
    @functools.partial(jax.jit, static_argnums=(3,))
    def run_epochs(nn_params, opt_state, epoch0, n_epochs):
        def body(carry, e):
            nn_params, opt_state = carry
            scen = sample_scenarios(
                jax.random.fold_in(key, e), batch_size, sampler_cfg
            )
            nn_params, opt_state, mean_r, _ = step(nn_params, opt_state, scen)
            return (nn_params, opt_state), mean_r

        (nn_params, opt_state), mrs = jax.lax.scan(
            body, (nn_params, opt_state), epoch0 + jnp.arange(n_epochs)
        )
        return nn_params, opt_state, mrs

    chunk = checkpoint_every if checkpoint_dir is not None else epochs - start_epoch
    mean_rewards = []
    epoch = start_epoch
    while epoch < epochs:
        n = min(chunk, epochs - epoch)
        nn_params, opt_state, mrs = run_epochs(nn_params, opt_state, epoch, n)
        mean_rewards.extend(float(r) for r in mrs)
        epoch += n
        log_fn(f"rl epoch {epoch}/{epochs} mean reward {mean_rewards[-1]:.3f}")
        if checkpoint_dir is not None:
            save_train_state(checkpoint_dir, nn_params, opt_state, epoch)
    if checkpoint_dir is not None:
        save_train_state(checkpoint_dir, nn_params, opt_state, epochs)
    return model, nn_params, mean_rewards
