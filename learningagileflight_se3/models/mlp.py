"""Policy networks DNN1 / DNN2 in plain JAX — the reference's PyTorch
`network` (quad_nn.py:119-145).

  DNN1:  9 -> 64 -> 64 -> 7   (nn_train.py:7-9)   scenario -> traversal params
  DNN2: 18 -> 128 -> 128 -> 7 (nn_train_2.py:11-13) window-frame state -> same

Output 7-vector: [tra_pos(3), tra_ang Rodrigues(3), tra_time(1)].

`surrogate_inner_loss` is the reference's `myloss` (quad_nn.py:141-145):
L = <dp, out>, whose theta-gradient is (dr/dout)^T (dout/dtheta) — the
deterministic policy-gradient-through-MPC chain rule (deep_learning.py:75-81).

Weight init defaults to the PyTorch nn.Linear scheme
U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for both kernel and bias so training
dynamics match the reference's starting distribution.

The parameter tree is {"params": {"Dense_<i>": {"kernel": (in, out),
"bias": (out,)}}}, the layout of the shipped checkpoints in artifacts/.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MLP:
    """ReLU multilayer perceptron: Dense layers of `features` (hidden sizes +
    output size), ReLU between them.  `init(key, x)` builds the parameter
    tree for inputs shaped like x; `apply(params, x)` runs it."""

    features: Sequence[int]
    torch_init: bool = True

    def init(self, key, x):
        fan_in = x.shape[-1]
        layers = {}
        for i, (f, k) in enumerate(zip(self.features,
                                       jax.random.split(key, len(self.features)))):
            kk, kb = jax.random.split(k)
            if self.torch_init:
                bound = 1.0 / jnp.sqrt(jnp.asarray(fan_in, jnp.float32))
                kernel = jax.random.uniform(kk, (fan_in, f), jnp.float32,
                                            -bound, bound)
                bias = jax.random.uniform(kb, (f,), jnp.float32, -bound, bound)
            else:  # LeCun normal kernel, zero bias
                kernel = jax.random.truncated_normal(
                    kk, -2.0, 2.0, (fan_in, f), jnp.float32
                ) * (1.0 / jnp.sqrt(fan_in) / 0.87962566103423978)
                bias = jnp.zeros((f,), jnp.float32)
            layers[f"Dense_{i}"] = {"kernel": kernel, "bias": bias}
            fan_in = f
        return {"params": layers}

    def apply(self, params, x):
        layers = params["params"]
        n = len(self.features)
        for i in range(n):
            layer = layers[f"Dense_{i}"]
            x = x @ layer["kernel"] + layer["bias"]
            if i < n - 1:
                x = jax.nn.relu(x)
        return x


def make_dnn1(hidden: int = 64):
    """9 -> hidden -> hidden -> 7 (nn_train.py:7-9,15)."""
    return MLP(features=(hidden, hidden, 7))


def make_dnn2(hidden: int = 128):
    """18 -> hidden -> hidden -> 7 (nn_train_2.py:11-13,23)."""
    return MLP(features=(hidden, hidden, 7))


def surrogate_inner_loss(outputs, dp):
    """myloss (quad_nn.py:141-145): sum over batch of <dp_i, out_i>."""
    return jnp.sum(outputs * jax.lax.stop_gradient(dp))
