"""Geometry tests (SURVEY.md section 4 anchor 3): gate kinematics vs hand
values/scipy, and the branch-free collision score vs an independent loop-based
NumPy implementation of the reference algorithm (solid_geometry.py:104-168)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation as R

from learningagileflight_se3.config import RewardConfig
from learningagileflight_se3.geometry.collision import (
    collision_score,
    trajectory_reward,
)
from learningagileflight_se3.geometry.gate import (
    final_to_window,
    gate_centroid,
    gate_frame,
    gate_from_width,
    gate_move,
    gate_pitch,
    gate_width,
    rotate_y,
    rotate_z,
    transform_state_to_window,
    translate,
    window_inputs,
)


# ---------------------------------------------------------------- numpy fixture
def _np_unit(v):
    return v / np.linalg.norm(v)


def _np_vertical(p1, p2, pt):
    d = _np_unit(p1 - p2)
    return np.linalg.norm(np.cross(pt - p1, d))


def _np_segdist(p1, p2, pt):
    a = _np_vertical(p1, p2, pt)
    b = np.linalg.norm(pt - p1)
    c = np.linalg.norm(pt - p2)
    d = np.linalg.norm(p1 - p2)
    if b > c:
        return c if (b**2 - d**2) > a**2 else a
    return b if (c**2 - d**2) > a**2 else a


def np_collis_det(gate_pts, traj, horizon, d_min=0.2):
    """Literal loop/branch transcription of the reference algorithm."""
    pts = [np.asarray(p, float) for p in gate_pts]
    c = np.mean(gate_pts, axis=0)

    def plane(i):
        v1 = pts[i] - c
        v2 = pts[(i + 1) % 4] - c
        normal = _np_unit(np.cross(v2, v1))
        n1 = _np_unit(np.cross(v1, normal))
        n2 = _np_unit(np.cross(normal, v2))
        v3 = pts[(i + 1) % 4] - pts[i]
        n3 = _np_unit(np.cross(normal, v3))
        return normal, n1, n2, n3

    n_main = plane(0)[0]
    if np.dot(n_main, traj[0] - c) < 0:
        return 0.0
    collision = 0.0
    for t in range(horizon):
        if np.dot(n_main, traj[t] - c) < 0:
            d = _np_unit(traj[t] - traj[t - 1])
            tt = 1 / np.dot(d, n_main) * np.dot(n_main, traj[t] - c)
            inter = traj[t] - tt * d
            for s in range(4):
                normal, n1, n2, n3 = plane(s)
                if np.dot(n1, inter - c) > 0 and np.dot(n2, inter - c) > 0:
                    if np.dot(pts[s] - inter, n3) > 0:
                        m = min(
                            _np_vertical(pts[i], pts[(i + 1) % 4], inter)
                            for i in range(4)
                        )
                        collision = -max(0, d_min - m) ** 2
                    else:
                        segs = [
                            _np_segdist(pts[i % 4], pts[(i + 1) % 4], inter)
                            for i in (s - 1, s, s + 1)
                        ]
                        collision = -2 * d_min * min(segs) - d_min**2
            break
    return collision


def straight_traj(p0, p1, n):
    return np.linspace(p0, p1, n)


# ---------------------------------------------------------------------- tests
class TestGateKinematics:
    def test_corners_from_width(self):
        pts = np.asarray(gate_from_width(jnp.asarray(1.0)))
        np.testing.assert_allclose(
            pts, [[-0.5, 0, 1], [0.5, 0, 1], [0.5, 0, -1], [-0.5, 0, -1]], atol=1e-12
        )

    def test_rotate_y_pitch_roundtrip(self):
        pts = gate_from_width(jnp.asarray(1.0))
        rot = rotate_y(pts, jnp.asarray(0.4))
        np.testing.assert_allclose(float(gate_pitch(rot)), 0.4, atol=1e-12)
        np.testing.assert_allclose(float(gate_width(rot)), 1.0, atol=1e-12)
        back = rotate_y(rot, jnp.asarray(-0.4))
        np.testing.assert_allclose(np.asarray(back), np.asarray(pts), atol=1e-12)

    def test_rotate_z(self):
        pts = gate_from_width(jnp.asarray(1.0))
        rot = rotate_z(pts, jnp.asarray(np.pi / 2))
        # x -> y for the relative coords
        np.testing.assert_allclose(np.asarray(rot)[0], [0, -0.5, 1], atol=1e-12)

    def test_frame_unpitched_is_identity(self):
        pts = gate_from_width(jnp.asarray(1.2))
        Rwg = np.asarray(gate_frame(pts))
        np.testing.assert_allclose(Rwg, np.eye(3), atol=1e-12)

    def test_transform_state_identity_gate(self, rng):
        """Unpitched gate at origin: window frame == world frame."""
        pts = gate_from_width(jnp.asarray(1.0))
        s = rng.normal(size=13)
        s[6:10] /= np.linalg.norm(s[6:10])
        if s[6] < 0:
            s[6:10] = -s[6:10]
        out = np.asarray(transform_state_to_window(pts, jnp.asarray(s)))
        np.testing.assert_allclose(out, s, atol=1e-8)

    def test_transform_matches_scipy_composition(self, rng):
        """Pitched+translated gate: attitude re-expression must equal
        scipy's R_wg @ R_body path (quad_model.py:805-807)."""
        pts = translate(rotate_y(gate_from_width(jnp.asarray(0.9)), jnp.asarray(0.5)),
                        jnp.asarray([0.3, 1.0, -0.2]))
        s = rng.normal(size=13)
        s[6:10] /= np.linalg.norm(s[6:10])
        out = np.asarray(transform_state_to_window(pts, jnp.asarray(s)))
        Rwg = np.asarray(gate_frame(pts))
        c = np.asarray(gate_centroid(pts))
        np.testing.assert_allclose(out[0:3], Rwg @ (s[0:3] - c), atol=1e-10)
        np.testing.assert_allclose(out[3:6], Rwg @ s[3:6], atol=1e-10)
        np.testing.assert_allclose(out[10:13], s[10:13], atol=1e-12)
        q = s[6:10]
        r1 = R.from_quat([q[1], q[2], q[3], q[0]])
        r2 = R.from_matrix(Rwg @ r1.as_matrix())
        x, y, z, w = r2.as_quat()
        expected = np.array([w, x, y, z])
        if np.dot(expected, out[6:10]) < 0:
            expected = -expected
        np.testing.assert_allclose(out[6:10], expected, atol=1e-8)

    def test_final_to_window(self):
        pts = translate(gate_from_width(jnp.asarray(1.0)), jnp.asarray([1.0, 2.0, 3.0]))
        out = np.asarray(final_to_window(pts, jnp.asarray([2.0, 4.0, 6.0])))
        np.testing.assert_allclose(out, [1.0, 2.0, 3.0], atol=1e-12)

    def test_window_inputs_shape(self):
        pts = rotate_y(gate_from_width(jnp.asarray(1.0)), jnp.asarray(0.3))
        s = np.zeros(13)
        s[6] = 1.0
        inp = np.asarray(window_inputs(pts, jnp.asarray(s), jnp.asarray([0.0, 6.0, 0.0])))
        assert inp.shape == (18,)
        np.testing.assert_allclose(inp[16], 1.0, atol=1e-12)  # width
        np.testing.assert_allclose(inp[17], 0.3, atol=1e-12)  # pitch

    def test_gate_move_statistics(self):
        pts = gate_from_width(jnp.asarray(1.0))
        moves, V = gate_move(pts, jax.random.PRNGKey(0), [1.0, 0.3, 0.4], np.pi / 2,
                             T=1.0, dt=0.01)
        assert moves.shape == (101, 4, 3)
        assert V.shape == (101, 3)
        # width preserved under rigid motion
        widths = np.asarray(jax.vmap(gate_width)(moves))
        np.testing.assert_allclose(widths, 1.0, atol=1e-9)
        # centroid drift approximately v*T
        drift = np.asarray(gate_centroid(moves[-1]) - gate_centroid(moves[0]))
        np.testing.assert_allclose(drift, [1.0, 0.3, 0.4], atol=0.15)


class TestCollision:
    GATE = np.array([[-0.6, 0, 1.0], [0.6, 0, 1.0], [0.6, 0, -1.0], [-0.6, 0, -1.0]])

    def _check(self, traj, horizon=None, d_min=0.2):
        horizon = horizon if horizon is not None else len(traj) - 1
        got, _ = collision_score(
            jnp.asarray(self.GATE), jnp.asarray(traj), horizon, d_min
        )
        want = np_collis_det(self.GATE, traj, horizon, d_min)
        np.testing.assert_allclose(float(got), want, atol=1e-10)
        return want

    def test_clean_center_pass(self):
        traj = straight_traj([0, -3, 0], [0, 3, 0], 20)
        want = self._check(traj)
        # center of a 1.2x2 gate: min edge distance 0.6 > d_min -> zero penalty
        assert want == 0.0

    def test_near_edge_pass(self):
        traj = straight_traj([0.45, -3, 0], [0.45, 3, 0], 20)
        want = self._check(traj)
        # margin 0.15 < 0.2 -> small negative
        assert want == pytest.approx(-((0.2 - 0.15) ** 2))

    def test_outside_miss(self):
        traj = straight_traj([1.5, -3, 0], [1.5, 3, 0], 20)
        want = self._check(traj)
        # outside: -2*d_min*m - d_min^2, m = distance to nearest edge segment
        assert want == pytest.approx(-2 * 0.2 * 0.9 - 0.04)

    def test_no_crossing(self):
        traj = straight_traj([0, -3, 0], [0, -1, 0], 20)
        assert self._check(traj) == 0.0

    def test_started_far_side(self):
        traj = straight_traj([0, 3, 0], [0, -3, 0], 20)
        assert self._check(traj) == 0.0

    def test_random_trajectories_match_reference_algorithm(self, rng):
        for _ in range(30):
            p0 = rng.uniform(-2, 2, 3) + [0, -4, 0]
            p1 = rng.uniform(-2, 2, 3) + [0, 4, 0]
            traj = straight_traj(p0, p1, 25)
            self._check(traj)

    def test_pitched_gate_random(self, rng):
        pts = np.asarray(rotate_y(jnp.asarray(self.GATE), jnp.asarray(0.7)))
        for _ in range(20):
            p0 = rng.uniform(-2, 2, 3) + [0, -4, 0]
            p1 = rng.uniform(-2, 2, 3) + [0, 4, 0]
            traj = straight_traj(p0, p1, 25)
            horizon = len(traj) - 1
            got, _ = collision_score(jnp.asarray(pts), jnp.asarray(traj), horizon, 0.2)
            want = np_collis_det(pts, traj, horizon, 0.2)
            np.testing.assert_allclose(float(got), want, atol=1e-10)

    def test_trajectory_reward_formula(self):
        """reward = 1000*collision - 0.5*path + 100 (quad_policy.py:90)."""
        cfg = RewardConfig()
        H = 10
        states = np.zeros((H + 1, 13))
        states[:, 6] = 1.0
        states[:, 1] = np.linspace(-3, 3, H + 1)
        goal = np.array([0.0, 3.0, 0.0])
        reward, collision, path, inside = trajectory_reward(
            jnp.asarray(states), jnp.asarray(self.GATE), jnp.asarray(goal), cfg, H
        )
        ends = states[[H - 1, H - 2, H - 3, H - 4], 0:3]
        path_expect = sum(np.dot(e - goal, e - goal) for e in ends)
        np.testing.assert_allclose(float(path), path_expect, atol=1e-10)
        np.testing.assert_allclose(
            float(reward), 1000 * float(collision) - 0.5 * path_expect + 100, atol=1e-9
        )
