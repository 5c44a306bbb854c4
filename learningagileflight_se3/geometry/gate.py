"""Gate (narrow window) kinematics — functional, vmap/jit-safe.

Re-design of the reference's stateful `gate` class (quad_model.py:669-815):
instead of an object mutating `self.gate_point`/`self.I_G`, every function
maps a (4,3) corner array to a new one, so gates batch trivially under vmap
and live inside `lax.scan` closed-loop rollouts.

Conventions preserved from the reference:
  * corners ordered [top-left, top-right, bottom-right, bottom-left] as built
    by main.py:25: [[-w/2,0,1],[w/2,0,1],[w/2,0,-1],[-w/2,0,-1]].
  * the gate frame R_wg (world->window) has ROWS [ax, ay, az] with
    az=[0,0,1], ay=normalize(cross(p1-p0, p2-p1)), ax=cross(ay,az)
    (quad_model.py:696-700).  NOTE: the reference constructor stores the
    TRANSPOSE of this (quad_model.py:683) but every deployment path goes
    through rotate_y/translate first, which store the row form — we implement
    the row form (the behavior actually exercised; SURVEY.md section 7).
  * `rotate_y` spins the [x,z] coordinates about the centroid
    (quad_model.py:686-692); `rotate_z` the [x,y] (quad_model.py:703-709).
  * `transform` maps a 13-state into the window frame (quad_model.py:793-811):
    position/velocity rotated by R_wg, body-frame angular rate unchanged,
    attitude re-expressed via R_wg @ R_body2world.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.core.rotations import dcm_to_quat, quat_to_dcm_w2b


def gate_from_width(width, pitch=None, half_height: float = 1.0):
    """Corner array for a gate of `width` at origin (main.py:25), optionally
    pitched by `pitch` radians about its y axis (main.py:27-28)."""
    w2 = width / 2.0
    h = half_height
    pts = jnp.stack(
        [
            jnp.stack([-w2, jnp.zeros_like(w2), jnp.full_like(w2, h)]),
            jnp.stack([w2, jnp.zeros_like(w2), jnp.full_like(w2, h)]),
            jnp.stack([w2, jnp.zeros_like(w2), jnp.full_like(w2, -h)]),
            jnp.stack([-w2, jnp.zeros_like(w2), jnp.full_like(w2, -h)]),
        ]
    )
    if pitch is not None:
        pts = rotate_y(pts, pitch)
    return pts


def gate_centroid(pts):
    return jnp.mean(pts, axis=0)


def gate_frame(pts):
    """R_wg: world->window rotation, rows [ax, ay, az] (quad_model.py:696-700).

    ax = cross(ay, az) is deliberately NOT normalized, matching the reference."""
    az = jnp.array([0.0, 0.0, 1.0], dtype=pts.dtype)
    n = jnp.cross(pts[1] - pts[0], pts[2] - pts[1])
    ay = n / jnp.linalg.norm(n)
    ax = jnp.cross(ay, az)
    return jnp.stack([ax, ay, az])


def gate_width(pts):
    """|p0 - p1| (main.py:91)."""
    return jnp.linalg.norm(pts[0] - pts[1])


def gate_pitch(pts):
    """atan((p0z - p1z)/(p0x - p1x)) — the real-time pitch estimate (main.py:92)."""
    return jnp.arctan((pts[0, 2] - pts[1, 2]) / (pts[0, 0] - pts[1, 0]))


def rotate_y(pts, angle):
    """Rotate corners about the centroid in the x-z plane (quad_model.py:686-692)."""
    c = gate_centroid(pts)
    rel = pts - c
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    x = ca * rel[:, 0] - sa * rel[:, 2]
    z = sa * rel[:, 0] + ca * rel[:, 2]
    return jnp.stack([x, rel[:, 1], z], axis=1) + c


def rotate_z(pts, angle):
    """Rotate corners about the centroid in the x-y plane (quad_model.py:703-709)."""
    c = gate_centroid(pts)
    rel = pts - c
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    x = ca * rel[:, 0] - sa * rel[:, 1]
    y = sa * rel[:, 0] + ca * rel[:, 1]
    return jnp.stack([x, y, rel[:, 2]], axis=1) + c


def translate(pts, displacement):
    return pts + displacement[None, :]


def transform_state_to_window(pts, state):
    """13-state world -> window frame (gate.transform, quad_model.py:793-811)."""
    R_wg = gate_frame(pts)
    c = gate_centroid(pts)
    r = R_wg @ (state[0:3] - c)
    v = R_wg @ state[3:6]
    R_b2w = quat_to_dcm_w2b(state[6:10]).T
    q = dcm_to_quat(R_wg @ R_b2w)
    return jnp.concatenate([r, v, q, state[10:13]])


def final_to_window(pts, final_point):
    """Goal point world -> window frame (gate.t_final, quad_model.py:814-815)."""
    return gate_frame(pts) @ (final_point - gate_centroid(pts))


def window_inputs(pts, state, final_point):
    """The 18-dim DNN2 input vector (main.py:90-94):
    [state(13) in window frame, final(3) in window frame, width, pitch]."""
    return jnp.concatenate(
        [
            transform_state_to_window(pts, state),
            final_to_window(pts, final_point),
            gate_width(pts)[None],
            gate_pitch(pts)[None],
        ]
    )


def gate_move(pts, key, v, w, T: float = 5.0, dt: float = 0.01,
              noise_std: float = 0.1, noise_clip: float = 0.1):
    """Moving-gate trajectory (gate.move, quad_model.py:769-790): per step,
    rotate about y by dt*w around the current centroid, then translate by
    dt*(v + clipped Gaussian noise).  Returns (moves (N+1,4,3), V (N+1,3))."""
    n = int(T / dt)
    v = jnp.asarray(v, dtype=pts.dtype)
    noise = jnp.clip(
        noise_std * jax.random.normal(key, (n, 3), dtype=pts.dtype),
        -noise_clip,
        noise_clip,
    )

    def body(p, eps):
        p = rotate_y(p, w * dt)
        vel = v + eps
        p = translate(p, dt * vel)
        return p, (p, vel)

    _, (moves, V) = jax.lax.scan(body, pts, noise)
    moves = jnp.concatenate([pts[None], moves], axis=0)
    V = jnp.concatenate([v[None], V], axis=0)
    return moves, V
