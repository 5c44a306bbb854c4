"""ctypes bindings for the native host runtime (native/fastquad.cpp).

The accelerator owns the compute path; libfastquad owns host-side work the reference
delegated to native dependencies (IPOPT/CasADi/PyBullet): high-throughput
scenario sampling, an independent float64 plant oracle, and host-side reward
evaluation of device rollouts.

The library is built from native/fastquad.cpp by `make -C native/` into the
git-ignored native/build/ on first use in each process; make rebuilds it
whenever the source is newer, so a stale library is never loaded.  Everything
here degrades gracefully (`available()` -> False) if no C++ toolchain
exists.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libfastquad.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    dp = ctypes.POINTER(ctypes.c_double)

    lib.fastquad_sample_scenarios.argtypes = [ctypes.c_uint64, ctypes.c_int64, dp]
    lib.fastquad_sample_scenarios.restype = None

    lib.fastquad_euler_step.argtypes = [dp, dp, ctypes.c_double, dp, dp]
    lib.fastquad_euler_step.restype = None

    lib.fastquad_rollout.argtypes = [dp, dp, ctypes.c_int64, ctypes.c_double, dp, dp]
    lib.fastquad_rollout.restype = None

    lib.fastquad_collision_score.argtypes = [dp, dp, ctypes.c_int64, ctypes.c_double]
    lib.fastquad_collision_score.restype = ctypes.c_double

    lib.fastquad_trajectory_reward.argtypes = [
        dp, ctypes.c_int64, dp, dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, dp,
    ]
    lib.fastquad_trajectory_reward.restype = ctypes.c_double
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_c(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _params_vec(params) -> np.ndarray:
    return np.array(
        [params.Jx, params.Jy, params.Jz, params.mass, params.l, params.c, params.g]
    )


def sample_scenarios(seed: int, n: int) -> np.ndarray:
    """(n, 9) scenario batch from the native sampler (quad_nn.py:18-48
    distribution; xoshiro PRNG — same law, different stream than jax.random)."""
    lib = _load()
    assert lib is not None, "libfastquad unavailable"
    out = np.empty((n, 9), dtype=np.float64)
    lib.fastquad_sample_scenarios(
        ctypes.c_uint64(seed), n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    )
    return out


def euler_step(x, u, dt: float, params) -> np.ndarray:
    lib = _load()
    assert lib is not None
    x, xp = _as_c(x)
    u, up = _as_c(u)
    p, pp = _as_c(_params_vec(params))
    out = np.empty(13, dtype=np.float64)
    lib.fastquad_euler_step(xp, up, dt, pp, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def rollout(x0, U, dt: float, params) -> np.ndarray:
    lib = _load()
    assert lib is not None
    x0, xp = _as_c(x0)
    U, Up = _as_c(U)
    p, pp = _as_c(_params_vec(params))
    H = U.shape[0]
    out = np.empty((H + 1, 13), dtype=np.float64)
    lib.fastquad_rollout(xp, Up, H, dt, pp, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def collision_score(gate_pts, tip_traj, horizon: int, d_min: float = 0.2) -> float:
    lib = _load()
    assert lib is not None
    g, gp = _as_c(gate_pts)
    t, tp = _as_c(tip_traj)
    return float(lib.fastquad_collision_score(gp, tp, horizon, d_min))


def trajectory_reward(
    states, gate_pts, goal, horizon: int,
    wing_len: float = 1.5, d_min: float = 0.2,
    collision_weight: float = 1000.0, path_weight: float = 0.5,
    offset: float = 100.0,
):
    """Returns (reward, collision_sum, path)."""
    lib = _load()
    assert lib is not None
    s, sp = _as_c(states)
    g, gp = _as_c(gate_pts)
    go, gop = _as_c(goal)
    stats = np.zeros(2, dtype=np.float64)
    r = lib.fastquad_trajectory_reward(
        sp, horizon, gp, gop, wing_len, d_min, collision_weight, path_weight,
        offset, stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return float(r), float(stats[0]), float(stats[1])
