"""Branch-free collision detection + trajectory reward (vmap/jit-safe).

Re-implements the reference's `obstacle.collis_det` (solid_geometry.py:104-168)
and `run_quad.objective` reward (quad_policy.py:67-91) without data-dependent
Python control flow, so it batches over rotors x scenarios and runs inside jit:

  * the first gate-plane crossing becomes a masked argmax over the horizon;
  * the 4-sector classification becomes 4 predicated updates applied in
    reference order (later sectors overwrite earlier — the reference's `if`
    chain reassigns, not accumulates);
  * inside-gate:   score = -max(0, d_min - m)^2, m = min distance to the 4
    edge LINES (solid_geometry.py:122-124);
  * outside-gate:  score = -2*d_min*m - d_min^2, m = min distance to 3 edge
    SEGMENTS (lines s-1, s, s+1 of sector s; solid_geometry.py:127-128);
  * early-exit "started on far side" (solid_geometry.py:110-111) and
    "no crossing" both give score 0, handled by masks.

reward = 1000 * sum_rotors collision - 0.5 * path + 100 (quad_policy.py:85-90),
path = sum_{p=0..3} |r_{H-1-p} - goal|^2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import RewardConfig
from learningagileflight_se3.dynamics.quadrotor import rotor_positions


def _unit(v):
    return v / jnp.linalg.norm(v)


def _line_vertical(p1, p2, point):
    """Distance from point to the infinite line through p1,p2
    (solid_geometry.py:57-60; dir = norm(p1 - p2))."""
    d = _unit(p1 - p2)
    return jnp.linalg.norm(jnp.cross(point - p1, d))


def _line_segment_distance(p1, p2, point):
    """The reference's `line.distance` segment metric (solid_geometry.py:63-78),
    replicated exactly (including its particular b/c/d casing)."""
    a = _line_vertical(p1, p2, point)
    b = jnp.linalg.norm(point - p1)
    c = jnp.linalg.norm(point - p2)
    d = jnp.linalg.norm(p1 - p2)
    far_branch = jnp.where((b**2 - d**2) > a**2, c, a)
    near_branch = jnp.where((c**2 - d**2) > a**2, b, a)
    return jnp.where(b > c, far_branch, near_branch)


def collision_score(gate_pts, tip_traj, horizon: int, d_min: float = 0.2):
    """Collision score for ONE rotor-tip trajectory (horizon+1, 3) against a
    gate (4,3). Mirrors obstacle.collis_det(vert_traj, horizon)."""
    c = jnp.mean(gate_pts, axis=0)
    p = gate_pts  # p[0..3]

    # plane_i = plane(centroid, p_i, p_{i+1}); normal = norm(cross(vec2, vec1))
    idx_next = jnp.array([1, 2, 3, 0])
    vec1 = p - c                      # (4,3) centroid->p_i
    vec2 = p[idx_next] - c            # (4,3) centroid->p_{i+1}
    normals = jax.vmap(lambda a, b: _unit(jnp.cross(b, a)))(vec1, vec2)  # (4,3)
    n_main = normals[0]

    # sector side normals (solid_geometry.py:30-40)
    n1 = jax.vmap(lambda v1, nn: _unit(jnp.cross(v1, nn)))(vec1, normals)
    n2 = jax.vmap(lambda v2, nn: _unit(jnp.cross(nn, v2)))(vec2, normals)
    # n3_i = norm(cross(normal_i, p_{i+1} - p_i))
    n3 = jax.vmap(lambda nn, e: _unit(jnp.cross(nn, e)))(normals, p[idx_next] - p)

    sides = (tip_traj[:horizon] - c) @ n_main  # (H,)
    started_far = sides[0] < 0                 # early return 0 (line 110-111)
    crossed = sides < 0
    has_crossing = jnp.any(crossed)
    t_first = jnp.argmax(crossed)              # first True; >=1 when valid

    pt_t = tip_traj[t_first]
    pt_prev = tip_traj[jnp.maximum(t_first - 1, 0)]
    # plane.interpoint (solid_geometry.py:43-47) with plane.point1 = centroid
    dvec = _unit(pt_t - pt_prev)
    tt = (jnp.dot(n_main, pt_t - c)) / jnp.dot(dvec, n_main)
    intersect = pt_t - tt * dvec

    rel = intersect - c
    in_sector = (n1 @ rel > 0) & (n2 @ rel > 0)                 # (4,)
    inside_gate = jax.vmap(lambda pi, n3i: jnp.dot(pi - intersect, n3i) > 0)(p, n3)

    # min distance to the 4 edge lines (edges p_i -> p_{i+1})
    vert_d = jax.vmap(lambda a, b: _line_vertical(a, b, intersect))(p, p[idx_next])
    m_inside = jnp.min(vert_d)
    score_inside = -jnp.maximum(0.0, d_min - m_inside) ** 2

    # outside: segment distance to lines (s-1, s, s+1) of sector s
    seg_d = jax.vmap(lambda a, b: _line_segment_distance(a, b, intersect))(p, p[idx_next])

    def outside_score(s):
        m = jnp.min(jnp.stack([seg_d[(s - 1) % 4], seg_d[s % 4], seg_d[(s + 1) % 4]]))
        return -2.0 * d_min * m - d_min**2

    score_out = jnp.stack([outside_score(s) for s in range(4)])

    # reference order: sectors 0..3, later matches overwrite (lines 120-165)
    collision = jnp.zeros((), dtype=tip_traj.dtype)
    traversed_inside = jnp.zeros((), dtype=bool)
    for s in range(4):
        val = jnp.where(inside_gate[s], score_inside, score_out[s])
        collision = jnp.where(in_sector[s], val, collision)
        traversed_inside = jnp.where(
            in_sector[s], inside_gate[s], traversed_inside
        )

    valid = has_crossing & ~started_far
    collision = jnp.where(valid, collision, 0.0)
    traversed_inside = jnp.where(valid, traversed_inside, False)
    return collision, traversed_inside


def trajectory_reward(
    state_traj,
    gate_pts,
    goal_pos,
    cfg: RewardConfig,
    horizon: int,
):
    """Full reward of run_quad.objective (quad_policy.py:78-91) for a state
    trajectory (H+1, 13). Returns (reward, collision_sum, path, inside_any)."""
    tips = jax.vmap(lambda x: rotor_positions(x, cfg.wing_len))(state_traj)  # (H+1,4,3)

    def per_rotor(r):
        return collision_score(gate_pts, tips[:, r, :], horizon, cfg.d_min)

    cols, insides = jax.vmap(per_rotor)(jnp.arange(4))
    collision = jnp.sum(cols)
    inside_any = jnp.any(insides)

    ps = jnp.arange(cfg.n_path_points)
    ends = state_traj[horizon - 1 - ps, 0:3]
    path = jnp.sum((ends - goal_pos[None, :]) ** 2)

    reward = (
        cfg.collision_weight * collision - cfg.path_weight * path + cfg.reward_offset
    )
    return reward, collision, path, inside_any
