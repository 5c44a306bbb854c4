"""Stage 1 — supervised pretraining of DNN1 (reference nn_train.py).

The reference runs 3 epochs x 10,000 single-sample Adam steps (lr 2e-5,
MSE to the t_output label, nn_train.py:10-39).  Here scenarios sample
on-device and steps are batched: `batch_size` scenarios per optimizer step,
sharded over the scenario mesh axis.  Label semantics (t_output,
quad_nn.py:51-57) are exact.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from learningagileflight_se3.config import SamplerConfig
from learningagileflight_se3.models.mlp import make_dnn1
from learningagileflight_se3.models.sampler import pretrain_label, sample_scenarios


def make_pretrain_step(model, optimizer, sampler_cfg: SamplerConfig = SamplerConfig()):
    """One jitted pretraining step: sample batch -> MSE -> Adam update.

    step(params, opt_state, key, batch_size) -> (params, opt_state, loss)."""

    def step(params, opt_state, key, batch_size: int):
        scen = sample_scenarios(key, batch_size, sampler_cfg)
        labels = jax.vmap(pretrain_label)(scen)

        def loss_fn(p):
            pred = model.apply(p, scen)
            return jnp.mean((pred - labels) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def run_pretraining(
    key,
    steps: int = 3000,
    batch_size: int = 256,
    lr: float = 2e-5,
    sampler_cfg: SamplerConfig = SamplerConfig(),
    params=None,
    log_every: int = 100,
    log_fn=print,
):
    """Full stage-1 driver. Default budget 3000x256 ~= 25x the reference's
    30,000 single-sample steps (nn_train.py:10-12) at a fraction of the time.

    Device-resident: the whole step loop is ONE lax.scan inside ONE jit
    dispatch — the reference's 30,000 Python-loop Adam steps
    (nn_train.py:24-39) would each pay a host->device round trip."""
    model = make_dnn1()
    if params is None:
        key, init_key = jax.random.split(key)
        params = model.init(init_key, jnp.zeros((1, 9)))
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)
    step = make_pretrain_step(model, optimizer, sampler_cfg)

    @functools.partial(jax.jit, static_argnums=(3,))
    def run_chunk(params, opt_state, key, n_steps):
        def body(carry, _):
            params, opt_state, key = carry
            key, k = jax.random.split(key)
            params, opt_state, loss = step(params, opt_state, k, batch_size)
            return (params, opt_state, key), loss

        (params, opt_state, key), losses = jax.lax.scan(
            body, (params, opt_state, key), None, length=n_steps
        )
        return params, opt_state, key, losses

    # chunk at the logging cadence: a handful of dispatches total
    losses = []
    done = 0
    while done < steps:
        n = min(log_every, steps - done)
        params, opt_state, key, chunk_losses = run_chunk(params, opt_state, key, n)
        done += n
        losses.append(float(chunk_losses[-1]))
        log_fn(f"pretrain step {done}/{steps} loss {losses[-1]:.6f}")
    return model, params, losses


def evaluate_pretrain(model, params, key, n: int = 1000,
                      sampler_cfg: SamplerConfig = SamplerConfig()):
    """Mean MSE over fresh samples (nn_train.py:46-62 test phase)."""
    scen = sample_scenarios(key, n, sampler_cfg)
    labels = jax.vmap(pretrain_label)(scen)
    pred = model.apply(params, scen)
    return float(jnp.mean((pred - labels) ** 2))
