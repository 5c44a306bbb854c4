"""Scenario samplers (JAX PRNG) — the reference's numpy samplers
(quad_nn.py:18-57) re-built on jax.random so thousands of scenarios sample
on-device per training step instead of one per forked process.

9-dim DNN1 scenario vector (quad_nn.py:18-48):
  [0:3] initial position  ~ U(-5,5)^3 + (0,-9,0)
  [3:6] final position    ~ U(-2,2)^3 + (0, 6,0)
  [6]   initial yaw       ~ U(-hw, hw)          (hw=0.1 main / pi/6 pybullet)
  [7]   gate width        ~ clip(N(0.9,0.3), 0.5, 1.25)
  [8]   gate pitch        ~ width-coupled bimodal clipped normal (lines 35-45)

Pretrain label (t_output, quad_nn.py:51-57): zeros except
  t = clip(round(|init_pos|/4, 1), 2, 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import SamplerConfig
from learningagileflight_se3.core.rotations import (
    axis_angle_to_quat,
    normalize,
    rodrigues_to_quat,
    skew,
)
from learningagileflight_se3.geometry.gate import gate_from_width


def sample_scenario(key, cfg: SamplerConfig = SamplerConfig()):
    """One 9-dim scenario vector."""
    k = jax.random.split(key, 6)
    init_pos = jax.random.uniform(
        k[0], (3,), minval=-cfg.init_pos_halfwidth, maxval=cfg.init_pos_halfwidth
    ) + jnp.asarray(cfg.init_pos_offset)
    final_pos = jax.random.uniform(
        k[1], (3,), minval=-cfg.final_pos_halfwidth, maxval=cfg.final_pos_halfwidth
    ) + jnp.asarray(cfg.final_pos_offset)
    yaw = jax.random.uniform(k[2], (), minval=-cfg.yaw_halfwidth, maxval=cfg.yaw_halfwidth)
    width = jnp.clip(
        cfg.width_mean + cfg.width_std * jax.random.normal(k[3]),
        cfg.width_clip[0],
        cfg.width_clip[1],
    )
    # pitch distribution coupled to width (quad_nn.py:35-45)
    angle = jnp.clip(1.3 * (1.2 - width), 0.0, jnp.pi / 3)
    angle1 = (jnp.pi / 2 - angle) / 3.0
    judge = jax.random.normal(k[4])
    eps = jax.random.normal(k[5])
    pitch_pos = jnp.clip(angle + angle1 + (2 * angle1 / 3) * eps, angle, jnp.pi / 2)
    pitch_neg = jnp.clip(-angle - angle1 + (2 * angle1 / 3) * eps, -jnp.pi / 2, -angle)
    pitch = jnp.where(judge > 0, pitch_pos, pitch_neg)
    return jnp.concatenate(
        [init_pos, final_pos, yaw[None], width[None], pitch[None]]
    )


def sample_scenarios(key, batch: int, cfg: SamplerConfig = SamplerConfig()):
    return jax.vmap(lambda kk: sample_scenario(kk, cfg))(jax.random.split(key, batch))


def pretrain_label(scenario):
    """t_output (quad_nn.py:51-57). round-to-0.1 kept (non-differentiable is
    fine: it's a supervised label)."""
    t = jnp.clip(jnp.round(jnp.linalg.norm(scenario[0:3]) / 4.0 * 10.0) / 10.0, 2.0, 4.0)
    return jnp.concatenate([jnp.zeros(6, scenario.dtype), t[None]])


def sample_random_gate(key):
    """gene_gate (quad_nn.py:60-74): a random planar quadrilateral gate in the
    x-z plane — corner1 at the origin, corner3 on the +x axis at the diagonal
    length, corners 2/4 scattered above/below.  Returns (4, 3)."""
    k = jax.random.split(key, 5)
    dia = jax.random.uniform(k[0], (), minval=1.5, maxval=3.0)
    p1 = jnp.zeros(3)
    p3 = jnp.array([1.0, 0.0, 0.0]) * dia
    p2x = dia / 2 + (dia / 2) * jax.random.normal(k[1])
    p2z = jax.random.uniform(k[2], (), minval=0.0, maxval=dia)
    p4x = dia / 2 + (dia / 2) * jax.random.normal(k[3])
    p4z = jax.random.uniform(k[4], (), minval=-dia, maxval=0.0)
    p2 = jnp.stack([p2x, 0.0 * p2x, p2z])
    p4 = jnp.stack([p4x, 0.0 * p4x, p4z])
    return jnp.stack([p1, p2, p3, p4])


def _rotvec_to_dcm(rv):
    """Rodrigues rotation-vector -> rotation matrix (scipy R.from_rotvec
    semantics used at quad_nn.py:95-97)."""
    theta = jnp.linalg.norm(rv)
    axis = rv / jnp.maximum(theta, 1e-12)
    K = skew(axis)
    return (
        jnp.eye(3, dtype=rv.dtype)
        + jnp.sin(theta) * K
        + (1.0 - jnp.cos(theta)) * (K @ K)
    )


def sample_general_scenario(key):
    """con_sample (quad_nn.py:77-115): the fully-general 25-dim scenario —
    arbitrary initial position on a random sphere, a random quadrilateral
    gate placed by a composed y/z/rotvec rotation + noisy translation,
    random initial velocity/attitude, and a noisy final point.

    Layout: [init_pos(3), gate corners row-major (12), velocity(3),
    quaternion wxyz (4), final_pos(3)].
    """
    k = jax.random.split(key, 12)
    scaling = jax.random.uniform(k[0], (), minval=3.0, maxval=16.0)
    phi = jax.random.uniform(k[1], (), minval=0.0, maxval=2 * jnp.pi)
    theta = jnp.clip(
        jnp.pi / 2 + (jnp.pi / 8) * jax.random.normal(k[2]),
        jnp.pi / 4,
        3 * jnp.pi / 4,
    )
    sdir = jnp.stack(
        [jnp.sin(theta) * jnp.cos(phi), jnp.sin(theta) * jnp.sin(phi), jnp.cos(theta)]
    )
    init_pos = scaling * sdir

    beta = jax.random.uniform(k[3], (), minval=0.0, maxval=2 * jnp.pi)
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    rot1 = jnp.array([[cb, 0.0, sb], [0.0, 1.0, 0.0], [-sb, 0.0, cb]])
    g = phi - jnp.pi / 2
    cg, sg = jnp.cos(g), jnp.sin(g)
    rot2 = jnp.array([[cg, -sg, 0.0], [sg, cg, 0.0], [0.0, 0.0, 1.0]])
    rot = rot2 @ rot1
    axis = normalize(jax.random.normal(k[4], (3,)), eps=1e-12)
    a = (jnp.pi / 16) * jax.random.normal(k[5])
    rot = _rotvec_to_dcm(a * axis) @ rot

    length = jax.random.uniform(k[6], (), minval=2.0, maxval=scaling - 1.0)
    translation = length * sdir + jax.random.normal(k[7], (3,))
    gate_pts = sample_random_gate(k[8]) @ rot.T + translation

    velocity = 3.0 * jax.random.normal(k[9], (3,))
    rd = 0.5 * jax.random.normal(k[10], (3,))
    quat = rodrigues_to_quat(rd)
    dist = jax.random.uniform(k[11], (), minval=0.0, maxval=scaling)
    # the reference adds fresh N(0,1) noise per final-point coordinate
    # (quad_nn.py:111-114); fold it into one 3-vector draw
    knoise = jax.random.fold_in(k[11], 1)
    final_pos = dist * sdir + jax.random.normal(knoise, (3,))
    return jnp.concatenate(
        [init_pos, gate_pts.reshape(12), velocity, quat, final_pos]
    )


def scenario_to_problem(scenario, half_height: float = 1.0):
    """Expand a 9-dim scenario into MPC problem data, mirroring the per-worker
    setup of deep_learning.py:24-32:
      gate corners from width, pitched by scenario[8] (grad worker lines 25-27);
      initial state [pos, 0 vel, yaw quat about z, 0 omega] (quad_policy.py:16-30,
      ini_q = toQuaternion(yaw, [0,0,1]), deep_learning.py:29).
    Returns dict(x0, goal_pos, gate_pts)."""
    init_pos = scenario[0:3]
    goal = scenario[3:6]
    yaw = scenario[6]
    width = scenario[7]
    pitch = scenario[8]
    gate_pts = gate_from_width(width, pitch, half_height)
    q0 = axis_angle_to_quat(yaw, jnp.array([0.0, 0.0, 1.0], dtype=scenario.dtype))
    x0 = jnp.concatenate(
        [init_pos, jnp.zeros(3, scenario.dtype), q0, jnp.zeros(3, scenario.dtype)]
    )
    return {"x0": x0, "goal_pos": goal, "gate_pts": gate_pts}
