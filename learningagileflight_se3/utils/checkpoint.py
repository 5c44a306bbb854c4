"""Checkpointing — replaces the reference's whole-model torch pickles
(`torch.save(model, FILE)` at nn_train.py:42, deep_learning.py:94,
nn_train_2.py:101) with one `.npz` file per pytree: each leaf stored under
its tree path ("params/Dense_0/kernel", "opt_state/0/mu/params/...") and
restored against a `like` tree, bit for bit.

A checkpoint named `path` lives in `path + ".npz"` (a name that already ends
in .npz is used as it is)."""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp


def _file(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _key(path) -> str:
    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            parts.append(str(k.key))
        elif isinstance(k, jax.tree_util.SequenceKey):
            parts.append(str(k.idx))
        elif isinstance(k, jax.tree_util.GetAttrKey):
            parts.append(k.name)
        elif isinstance(k, jax.tree_util.FlattenedIndexKey):
            parts.append(str(k.key))
        else:
            raise TypeError(f"unsupported tree key {k!r}")
    return "/".join(parts)


def save_params(path: str, params) -> None:
    """Write every leaf of `params` to path.npz under its tree path."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    arrays = {_key(p): np.asarray(leaf) for p, leaf in leaves}
    f = _file(path)
    os.makedirs(os.path.dirname(f), exist_ok=True)
    tmp = f[:-4] + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, f)  # a reader never sees a half-written checkpoint


def load_params(path: str, like):
    """Read path.npz into like's tree structure; every leaf is checked
    against like's shape and dtype, and the file must hold exactly like's
    leaves."""
    with np.load(_file(path)) as z:
        stored = {k: z[k] for k in z.files}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    restored = []
    for p, leaf in leaves:
        key = _key(p)
        if key not in stored:
            raise KeyError(f"checkpoint {path} has no leaf {key!r}")
        arr = stored.pop(key)
        ref = np.asarray(leaf)
        if arr.shape != ref.shape or arr.dtype != ref.dtype:
            raise ValueError(
                f"{key}: stored {arr.dtype}{arr.shape}, expected "
                f"{ref.dtype}{ref.shape}")
        restored.append(jnp.asarray(arr))
    if stored:
        raise ValueError(f"checkpoint {path} has leaves not in `like`: "
                         f"{sorted(stored)}")
    return jax.tree_util.tree_unflatten(treedef, restored)


def save_train_state(path: str, nn_params, opt_state, epoch: int) -> None:
    """Full training-state checkpoint (params + OPTIMIZER STATE + progress) —
    the mid-run resumability the reference lacks (SURVEY.md section 5: the
    reference restarts each stage from whole-model pickles with fresh Adam
    moments)."""
    save_params(
        path,
        {
            "nn_params": nn_params,
            "opt_state": opt_state,
            "epoch": np.asarray(epoch, np.int32),
        },
    )


def load_train_state(path: str, nn_params_like, opt_state_like):
    """Restore (nn_params, opt_state, epoch) saved by save_train_state."""
    like = {
        "nn_params": nn_params_like,
        "opt_state": opt_state_like,
        "epoch": np.zeros((), np.int32),
    }
    st = load_params(path, like=like)
    return st["nn_params"], st["opt_state"], int(st["epoch"])


def train_state_exists(path: str) -> bool:
    return os.path.exists(_file(path))
