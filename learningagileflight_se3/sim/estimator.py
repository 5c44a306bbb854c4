"""Gate-state Kalman filter — the working replacement for the reference's
dead `kalman` class (quad_moving.py:8-27, which crashes on construction via
`np.zeros(2,60)` and is never called).

The reference's closed loop feeds the GROUND-TRUTH gate velocity `V[i]` and
pitch rate `w` into the traversal-time solver and gate-pose prediction
(main.py:67,86-88) — the broken filter signals that estimating them from
observed gate poses was intended.  This module provides that capability as a
functional, jittable constant-velocity KF over the observable gate pose:

  state  x = [center(3), v_center(3), pitch, pitch_rate]  in R^8
  obs    y = [center(3), pitch]                            in R^4  per tick

Process model: constant velocity / constant pitch rate with white
acceleration noise (standard discrete CV model); observation = position
components.  Everything is closed-form per step (no matrix inversion beyond
a 4x4 solve), scan-friendly, and vmappable over a batch of gates.

The measurement itself comes from the gate corners via `gate_centroid` /
`gate_pitch` (geometry/gate.py), i.e. from what a perception stack would
output.  `make_gate_observer` adds optional Gaussian corner noise so the
filter is exercised with realistic inputs in tests and the closed-loop sim
(sim/closed_loop.py `estimate_gate_motion=True`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from learningagileflight_se3.geometry.gate import gate_centroid, gate_pitch

NS = 8  # [cx cy cz vx vy vz pitch pitch_rate]
NO = 4  # [cx cy cz pitch]


class KalmanState(NamedTuple):
    x: jnp.ndarray    # (8,) mean
    P: jnp.ndarray    # (8,8) covariance


def kalman_init(obs0, pos_var: float = 1.0, vel_var: float = 4.0,
                dtype=jnp.float32) -> KalmanState:
    """Initialize from the first observation: zero velocity, broad prior."""
    obs0 = jnp.asarray(obs0, dtype)
    x = jnp.zeros(NS, dtype)
    x = x.at[0:3].set(obs0[0:3])
    x = x.at[6].set(obs0[3])
    diag = jnp.asarray(
        [pos_var] * 3 + [vel_var] * 3 + [pos_var, vel_var], dtype
    )
    return KalmanState(x=x, P=jnp.diag(diag))


def _model_matrices(dt: float, q_accel: float, r_meas: float, dtype):
    """Constant-velocity F, process noise Q (white-accel), measurement R.

    Q uses the standard CV discretization [[dt^4/4, dt^3/2],[dt^3/2, dt^2]]
    * q_accel per (position, velocity) pair."""
    F = jnp.eye(NS, dtype=dtype)
    for p, v in ((0, 3), (1, 4), (2, 5), (6, 7)):
        F = F.at[p, v].set(dt)
    q11 = q_accel * dt**4 / 4.0
    q12 = q_accel * dt**3 / 2.0
    q22 = q_accel * dt**2
    Q = jnp.zeros((NS, NS), dtype)
    for p, v in ((0, 3), (1, 4), (2, 5), (6, 7)):
        Q = Q.at[p, p].set(q11).at[p, v].set(q12).at[v, p].set(q12).at[v, v].set(q22)
    Hm = jnp.zeros((NO, NS), dtype)
    Hm = Hm.at[0, 0].set(1.0).at[1, 1].set(1.0).at[2, 2].set(1.0).at[3, 6].set(1.0)
    R = r_meas * jnp.eye(NO, dtype=dtype)
    return F, Q, Hm, R


def make_kalman_step(dt: float = 0.01, q_accel: float = 25.0,
                     r_meas: float = 1e-4, pitch_period: float = jnp.pi):
    """step(KalmanState, obs (4,)) -> KalmanState: one predict+update.

    q_accel is the white acceleration PSD (the gate's per-step velocity
    noise, quad_model.py:778, acts as ~N(0, 0.1) accel at 100 Hz); r_meas
    the measurement variance of the perceived gate center/pitch.

    The pitch measurement comes from an atan (gate_pitch, main.py:92) and
    wraps with period pi; the innovation is wrapped accordingly so the filter
    tracks a continuously rotating gate across wrap points."""

    def step(ks: KalmanState, obs) -> KalmanState:
        dtype = ks.x.dtype
        F, Q, Hm, R = _model_matrices(dt, q_accel, r_meas, dtype)
        # predict
        xp = F @ ks.x
        Pp = F @ ks.P @ F.T + Q
        # update (Joseph-form covariance for f32 robustness)
        innov = jnp.asarray(obs, dtype) - Hm @ xp
        half = 0.5 * pitch_period
        innov = innov.at[3].set(((innov[3] + half) % pitch_period) - half)
        S = Hm @ Pp @ Hm.T + R
        K = jnp.linalg.solve(S, Hm @ Pp).T        # (8,4)
        xn = xp + K @ innov
        IKH = jnp.eye(NS, dtype=dtype) - K @ Hm
        Pn = IKH @ Pp @ IKH.T + K @ R @ K.T
        return KalmanState(x=xn, P=0.5 * (Pn + Pn.T))

    return step


def gate_observation(pts, key=None, noise_std: float = 0.0):
    """Gate corners (4,3) -> observation [center(3), pitch], optionally with
    Gaussian corner noise (a stand-in for perception error)."""
    if key is not None and noise_std > 0.0:
        pts = pts + noise_std * jax.random.normal(key, pts.shape, pts.dtype)
    return jnp.concatenate([gate_centroid(pts), gate_pitch(pts)[None]])


def estimated_velocity(ks: KalmanState):
    """(v_center (3,), pitch_rate ()) from the filter state."""
    return ks.x[3:6], ks.x[7]
