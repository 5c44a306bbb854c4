"""End-to-end validation-sim driver (the PyBullet-driver role, reference
gym_pybullet_drone/Pybullet_simulation.py:60-218).

Wires together, exactly as the reference's ``run_simulation`` does:

  scenario sample/replay  (YXCtrlWrapper.__init__, Yixiao_ctrl_wrapper.py:42-94)
  -> precomputed moving-gate trajectory     (gate.move, PyBullet fork deltas)
  -> ValidationEnv at 100 Hz                (GateAviary/DynAviary role)
  -> ExternalSimController at 10 Hz         (YXCtrlWrapper.computeControl role)
  -> SimLogger (npy + CSV + plots)          (gym-pybullet-drones Logger role)
  -> gate-traversal detection + metrics     (Pybullet_simulation.py:183-186)

Defaults mirror the reference's DEFAULT_* block (Pybullet_simulation.py:25-58):
100 Hz sim / 10 Hz control / 5 s, gate origin (0,0,3), start
[3, -3, -0.2] +- 2, goal [0, 4, 0] +- 1, gate width clip(N(0.35,0.1),
[0.3, 0.4]), half height 0.5, gate velocity (1, 0.3, 0.4), pitch rate pi/2.

The "use last sim setting" replay backup (``last_inputs.npy``,
Yixiao_ctrl_wrapper.py:42-65) is provided as an .npz of the full scenario.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import GateMotionConfig, QuadParams, Variant
from learningagileflight_se3.geometry.gate import gate_from_width, gate_move
from learningagileflight_se3.sim.external_controller import ExternalSimController
from learningagileflight_se3.sim.validation_env import (
    ValidationEnv,
    ValidationEnvConfig,
)


@dataclasses.dataclass(frozen=True)
class ValidationSimConfig:
    """run_simulation parameters (Pybullet_simulation.py:25-58)."""

    sim_freq_hz: int = 100
    ctrl_freq_hz: int = 10
    duration_sec: float = 5.0
    gate_origin: Tuple[float, float, float] = (0.0, 0.0, 3.0)
    # nn_sample_pybullet ranges (Yixiao_ctrl_wrapper.py:143-173 + DEFAULT_GATE_PARAS)
    start_p: float = -3.0
    st_p_range: float = 2.0
    end_p: float = 4.0
    end_p_range: float = 1.0
    gate_wid_mean: float = 0.35
    gate_wid_std: float = 0.1
    gate_wid_lim: Tuple[float, float] = (0.3, 0.4)
    half_gate_height: float = 0.5
    gate_v: Tuple[float, float, float] = (1.0, 0.3, 0.4)
    gate_w: float = np.pi / 2
    fixed_point_tol: float = 1e-2      # PyBullet-fork tolerance (gym quad_moving.py:45)


def sample_validation_scenario(rng: np.random.Generator, cfg: ValidationSimConfig) -> dict:
    """nn_sample_pybullet (Yixiao_ctrl_wrapper.py:143-173): start around
    [3, start_p, -0.2], goal around [0, end_p, 0], yaw ~ U(+-pi/6), width ~
    clip-normal, pitch bimodal-coupled to width."""
    start = np.array([3.0, cfg.start_p, -0.2]) + rng.uniform(
        -cfg.st_p_range, cfg.st_p_range, size=3
    )
    final = np.array([0.0, cfg.end_p, 0.0]) + rng.uniform(
        -cfg.end_p_range, cfg.end_p_range, size=3
    )
    yaw = rng.uniform(-np.pi / 6, np.pi / 6)
    width = float(
        np.clip(rng.normal(cfg.gate_wid_mean, cfg.gate_wid_std), *cfg.gate_wid_lim)
    )
    angle = np.clip(1.3 * (1.2 - width), 0.0, np.pi / 3)
    angle1 = (np.pi / 2 - angle) / 3
    if rng.normal() > 0:
        pitch = float(np.clip(rng.normal(angle + angle1, 2 * angle1 / 3), angle, np.pi / 2))
    else:
        pitch = float(
            np.clip(rng.normal(-angle - angle1, 2 * angle1 / 3), -np.pi / 2, -angle)
        )
    return {
        "start_point": start,
        "final_point": final,
        "yaw": float(yaw),
        "gate_width": width,
        "gate_pitch": pitch,
    }


class SimLogger:
    """Timestamped state/control recorder (gym-pybullet-drones Logger role,
    Pybullet_simulation.py:140-143,209-214): in-memory arrays, .npy dump,
    per-field CSVs, optional matplotlib plots."""

    FIELDS = ("x", "y", "z", "qx", "qy", "qz", "qw", "r", "p", "yaw",
              "vx", "vy", "vz", "dr", "dp", "dyaw", "T", "taux", "tauy", "tauz")

    def __init__(self):
        self.timestamps = []
        self.states = []
        self.actions = []
        self.extras = []

    def log(self, timestamp: float, state20, action, extra: float = 0.0):
        self.timestamps.append(float(timestamp))
        self.states.append(np.asarray(state20)[:16])
        self.actions.append(np.asarray(action))
        self.extras.append(float(extra))

    def arrays(self):
        return (
            np.asarray(self.timestamps),
            np.asarray(self.states),
            np.asarray(self.actions),
            np.asarray(self.extras),
        )

    def save(self, folder: str, tag: str = "validation"):
        os.makedirs(folder, exist_ok=True)
        ts, st, ac, ex = self.arrays()
        np.save(os.path.join(folder, f"{tag}_timestamps.npy"), ts)
        np.save(os.path.join(folder, f"{tag}_states.npy"), st)
        np.save(os.path.join(folder, f"{tag}_actions.npy"), ac)
        np.save(os.path.join(folder, f"{tag}_tra_time.npy"), ex)

    def save_as_csv(self, folder: str, tag: str = "validation"):
        os.makedirs(folder, exist_ok=True)
        ts, st, ac, _ = self.arrays()
        data = np.hstack([st, ac])
        header = "t," + ",".join(self.FIELDS)
        np.savetxt(
            os.path.join(folder, f"{tag}.csv"),
            np.hstack([ts[:, None], data]),
            delimiter=",",
            header=header,
            comments="",
        )

    def plot(self, folder: str, tag: str = "validation"):
        from learningagileflight_se3.sim.plotting import _plt

        plt = _plt()
        if plt is None:
            return
        ts, st, ac, _ = self.arrays()
        fig, axes = plt.subplots(2, 2, figsize=(10, 7))
        axes[0, 0].plot(ts, st[:, 0:3]); axes[0, 0].set_title("position")
        axes[0, 1].plot(ts, st[:, 10:13]); axes[0, 1].set_title("velocity")
        axes[1, 0].plot(ts, st[:, 7:10]); axes[1, 0].set_title("rpy")
        axes[1, 1].plot(ts, ac); axes[1, 1].set_title("thrust/torques")
        fig.tight_layout()
        os.makedirs(folder, exist_ok=True)
        fig.savefig(os.path.join(folder, f"{tag}.png"), dpi=110)
        plt.close(fig)


def _traversal_metrics(states, gate_pts_per_step, width, half_height):
    """Crossing analysis in the gate's window frame: did the vehicle cross
    the gate plane inside the opening, and with what edge clearance?
    (the metric the reference only eyeballs via the GUI)."""
    crossed = False
    margin = -np.inf
    for i in range(1, len(states)):
        pts = gate_pts_per_step[i]
        centroid = pts.mean(axis=0)
        # window frame axes: x along corner1->corner2 (top edge), plane
        # normal from the corner cross product
        ex = pts[1] - pts[0]
        ex = ex / np.linalg.norm(ex)
        ez = pts[0] - pts[3]
        ez = ez / np.linalg.norm(ez)
        ey = np.cross(ez, ex)
        prev = states[i - 1][0:3] - centroid
        cur = states[i][0:3] - centroid
        if (prev @ ey) < 0.0 <= (cur @ ey):
            s = (0.0 - prev @ ey) / max(cur @ ey - prev @ ey, 1e-12)
            hit = prev + s * (cur - prev)
            dx, dz = abs(hit @ ex), abs(hit @ ez)
            inside = dx < width / 2 and dz < half_height
            margin = float(min(width / 2 - dx, half_height - dz))
            crossed = bool(inside)
            break
    return crossed, margin


def run_validation_sim(
    model2,
    nn2_params,
    cfg: ValidationSimConfig = ValidationSimConfig(),
    env_cfg: Optional[ValidationEnvConfig] = None,
    params: QuadParams = QuadParams(),
    seed: int = 0,
    output_folder: Optional[str] = None,
    replay_file: Optional[str] = None,
    save_settings: bool = False,
    plot: bool = False,
) -> dict:
    """Fly DNN2 + MPC closed-loop in the independent validation plant.

    Returns a dict with the logger, traversal success/margin, and final
    goal distance.  ``replay_file``/``save_settings`` reproduce the
    reference's last-settings replay backup (Yixiao_ctrl_wrapper.py:42-65).
    """
    rng = np.random.default_rng(seed)
    if replay_file is not None:
        z = np.load(replay_file)
        scen = {k: z[k] for k in z.files}
        scen["yaw"] = float(scen["yaw"])
        scen["gate_width"] = float(scen["gate_width"])
        scen["gate_pitch"] = float(scen["gate_pitch"])
    else:
        scen = sample_validation_scenario(rng, cfg)
    if save_settings and output_folder:
        os.makedirs(output_folder, exist_ok=True)
        np.savez(os.path.join(output_folder, "last_inputs.npz"), **scen)

    origin = np.asarray(cfg.gate_origin, dtype=np.float64)
    n_steps = int(cfg.duration_sec * cfg.sim_freq_hz)
    ctrl_every = int(cfg.sim_freq_hz // cfg.ctrl_freq_hz)

    # precompute the gate trajectory in the RELATIVE frame (PyBullet fork:
    # noise clip 0.2, gym quad_model.py:702-720)
    pts0 = np.asarray(
        gate_from_width(scen["gate_width"], scen["gate_pitch"], cfg.half_gate_height)
    )
    motion_cfg = GateMotionConfig(
        velocity=tuple(cfg.gate_v), omega_y=float(cfg.gate_w), noise_clip=0.2
    )
    moves, V = gate_move(
        jnp.asarray(pts0),
        jax.random.PRNGKey(seed),
        jnp.asarray(cfg.gate_v, dtype=pts0.dtype),
        motion_cfg.omega_y,
        T=cfg.duration_sec,
        dt=1.0 / cfg.sim_freq_hz,
        noise_std=motion_cfg.noise_std,
        noise_clip=motion_cfg.noise_clip,
    )
    moves = np.asarray(moves)
    V = np.asarray(V)

    def gate_motion_rel(step: int):
        i = min(step, len(moves) - 1)
        return moves[i], V[i]

    def gate_motion_world(step: int):
        pts, vel = gate_motion_rel(step)
        return pts + origin, vel

    ctrl = ExternalSimController(
        model2,
        nn2_params,
        final_point=scen["final_point"],
        gate_motion=gate_motion_rel,
        w_rot=float(cfg.gate_w),
        origin=origin,
        variant=Variant.PYBULLET,
        fixed_point_tol=cfg.fixed_point_tol,
    )

    env = ValidationEnv(
        params=params,
        cfg=env_cfg or ValidationEnvConfig(sim_freq_hz=cfg.sim_freq_hz),
        gate_motion=gate_motion_world,
    )
    obs = env.reset(scen["start_point"] + origin, (0.0, 0.0, scen["yaw"]))

    logger = SimLogger()
    action = np.zeros(4)
    t_pred = 0.0
    states13 = []
    for i in range(n_steps):
        if i % ctrl_every == 0:
            action, t_pred = ctrl.compute_control(
                step=i,
                cur_pos=obs[0:3],
                cur_quat_xyzw=obs[3:7],
                cur_vel=obs[10:13],
                cur_euler_rates=obs[13:16],
                cur_rpy=obs[7:10],
            )
        obs = env.step(action)
        states13.append(env.x.copy())
        logger.log(i / cfg.sim_freq_hz, obs, action, extra=t_pred)

    gate_world = [moves[min(i, len(moves) - 1)] + origin for i in range(n_steps)]
    crossed, margin = _traversal_metrics(
        np.asarray(states13), gate_world, scen["gate_width"], cfg.half_gate_height
    )
    final_dist = float(
        np.linalg.norm(env.x[0:3] - (scen["final_point"] + origin))
    )

    if output_folder:
        logger.save(output_folder)
        logger.save_as_csv(output_folder)
        if plot:
            logger.plot(output_folder)

    return {
        "scenario": scen,
        "logger": logger,
        "through_gate": crossed,
        "gate_margin": margin,
        "final_distance": final_dist,
        "states": np.asarray(states13),
    }
