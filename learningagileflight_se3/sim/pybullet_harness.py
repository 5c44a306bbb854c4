"""PyBullet validation harness — the externally-authored-physics half of the
validation story (reference gym_pybullet_drone/Pybullet_simulation.py:60-218
+ GateAviary.py:18-285).

`sim/validation_env.py` is a good independent plant, but it is still
SELF-authored: a shared misconception in dynamics or conventions would pass
it.  This module closes that gap by flying the identical control stack
(`sim/external_controller.ExternalSimController`, the
Yixiao_ctrl_wrapper.computeControl role) inside **Bullet** — a physics
engine this repo's authors did not write — whenever `pybullet` is
importable.  Everything here degrades gracefully: importing this module is
free of pybullet; constructing the sim raises a clear ImportError where
pybullet is absent (the live test is `pytest.importorskip`-guarded).

Design notes vs the reference:
  * The reference drives gym-pybullet-drones' DynAviary in "dynamics" mode:
    the wrapper mixes rotor thrusts to [T, tau_x, tau_y, tau_z]
    (Yixiao_ctrl_wrapper.py:136) and the aviary applies that wrench to the
    base link.  We apply the SAME wrench directly via
    pybullet.applyExternalForce/Torque in the link frame — the identical
    actuation contract without depending on gym-pybullet-drones' wrapper
    stack (its aviary classes are thin URDF+camera management around
    exactly these calls, GateAviary.py:135-230).
  * The vehicle is the generated `assets/hb.urdf` (scripts/gen_assets.py),
    whose mass/inertia/arm values are asserted against config.QuadParams by
    tests/test_assets.py — Bullet integrates ITS OWN rigid-body dynamics
    from those properties; nothing of our plant code is in the loop.
  * The moving gate is a PHYSICAL Bullet body (physical_gate=True): a
    per-scenario window URDF (utils/urdf.window_urdf — opening sized to the
    sampled width/height, the role of GateAviary's `scaled_model`) loaded
    as a fixed-base obstacle and repositioned every physics step to the
    analytic corner trajectory (kinematic gate, exactly GateAviary's
    moving-gate mechanism, GateAviary.py:135-230).  Engine CONTACT events
    between the quad and the frame are recorded and returned alongside the
    analytic window-frame margin — a flight that nicks the frame is now
    caught by Bullet's own collision detection, not only by the margin
    metric.

The always-runnable counterpart is the recorded-replay CONTRACT test
(tests/test_pybullet_harness.py + artifacts/replay_contract.npz): the exact
per-tick (engine observation -> control wrench) mapping of the adapter is
pinned, so the stack that flies here is bit-for-bit the stack a PyBullet
host would call.
"""

from __future__ import annotations

import importlib
import os
from typing import Optional

import numpy as np

from learningagileflight_se3.config import QuadParams, Variant
from learningagileflight_se3.geometry.gate import gate_from_width, gate_move
from learningagileflight_se3.sim.external_controller import ExternalSimController
from learningagileflight_se3.sim.validation_sim import (
    ValidationSimConfig,
    _traversal_metrics,
    sample_validation_scenario,
)

_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
)


def _corners_to_pose(pts):
    """(4,3) corner array -> (centroid, R columns [x y z], quat xyzw) of the
    window body whose URDF opening lies in its local x-z plane (corner
    order [top-left, top-right, bottom-right, bottom-left],
    geometry/gate.gate_from_width)."""
    pts = np.asarray(pts, dtype=np.float64)
    c = pts.mean(axis=0)
    x_ax = pts[1] - pts[0]
    x_ax = x_ax / np.linalg.norm(x_ax)
    z_ax = pts[0] - pts[3]
    z_ax = z_ax / np.linalg.norm(z_ax)
    y_ax = np.cross(z_ax, x_ax)
    R = np.stack([x_ax, y_ax, z_ax], axis=1)  # columns = body axes in world
    # rotation matrix -> quaternion (w,x,y,z), Shepperd's method
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return c, q[[1, 2, 3, 0]]  # xyzw for Bullet


def _require_pybullet():
    try:
        return importlib.import_module("pybullet")
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "pybullet is not installed; the PyBullet validation harness "
            "needs it (pip install pybullet). The recorded-replay contract "
            "test covers the same control stack without it."
        ) from e


def run_pybullet_sim(
    model2,
    nn2_params,
    cfg: ValidationSimConfig = ValidationSimConfig(),
    params: QuadParams = QuadParams(),
    seed: int = 0,
    gui: bool = False,
    urdf: Optional[str] = None,
    replay_file: Optional[str] = None,
    physical_gate: bool = True,
) -> dict:
    """Fly DNN2 + MPC closed-loop in Bullet. Mirrors run_validation_sim's
    loop structure (100 Hz physics / 10 Hz control) and return dict so the
    two harnesses are drop-in comparable.

    physical_gate=True loads the window frame as a Bullet body and records
    engine contact events in the returned dict ("contacts": list of
    (step, world position, normal force), "n_contact_steps")."""
    p = _require_pybullet()

    rng = np.random.default_rng(seed)
    if replay_file is not None:
        z = np.load(replay_file)
        scen = {k: z[k] for k in z.files}
        scen["yaw"] = float(scen["yaw"])
        scen["gate_width"] = float(scen["gate_width"])
        scen["gate_pitch"] = float(scen["gate_pitch"])
    else:
        scen = sample_validation_scenario(rng, cfg)

    origin = np.asarray(cfg.gate_origin, dtype=np.float64)
    n_steps = int(cfg.duration_sec * cfg.sim_freq_hz)
    ctrl_every = int(cfg.sim_freq_hz // cfg.ctrl_freq_hz)
    dt = 1.0 / cfg.sim_freq_hz

    # gate trajectory in the relative frame (PyBullet fork noise clip 0.2)
    import jax
    import jax.numpy as jnp

    pts0 = np.asarray(
        gate_from_width(scen["gate_width"], scen["gate_pitch"], cfg.half_gate_height)
    )
    moves, V = gate_move(
        jnp.asarray(pts0), jax.random.PRNGKey(seed),
        jnp.asarray(cfg.gate_v, dtype=pts0.dtype), float(cfg.gate_w),
        T=cfg.duration_sec, dt=dt, noise_std=0.1, noise_clip=0.2,
    )
    moves, V = np.asarray(moves), np.asarray(V)

    def gate_motion_rel(step: int):
        i = min(step, len(moves) - 1)
        return moves[i], V[i]

    ctrl = ExternalSimController(
        model2, nn2_params,
        final_point=scen["final_point"],
        gate_motion=gate_motion_rel,
        w_rot=float(cfg.gate_w),
        origin=origin,
        variant=Variant.PYBULLET,
        fixed_point_tol=cfg.fixed_point_tol,
    )

    # ---- Bullet world ----
    client = p.connect(p.GUI if gui else p.DIRECT)
    try:
        p.setGravity(0.0, 0.0, -params.g, physicsClientId=client)
        p.setTimeStep(dt, physicsClientId=client)
        start_world = np.asarray(scen["start_point"]) + origin
        q0_xyzw = p.getQuaternionFromEuler([0.0, 0.0, scen["yaw"]])
        body = p.loadURDF(
            urdf or os.path.join(_ASSETS, "hb.urdf"),
            basePosition=start_world.tolist(),
            baseOrientation=q0_xyzw,
            physicsClientId=client,
        )
        # Bullet damps rigid bodies by default; the reference model has none
        p.changeDynamics(body, -1, linearDamping=0.0, angularDamping=0.0,
                         physicsClientId=client)

        gate_body = None
        if physical_gate:
            # per-scenario window URDF (opening sized to the sampled gate),
            # loaded fixed-base and repositioned kinematically every step —
            # the GateAviary.py:60-104 gate-as-obstacle mechanism
            import tempfile

            from learningagileflight_se3.utils.urdf import window_urdf

            with tempfile.NamedTemporaryFile(
                "w", suffix="_window.urdf", delete=False
            ) as f:
                f.write(window_urdf(float(scen["gate_width"]),
                                    float(cfg.half_gate_height)))
                gate_urdf_path = f.name
            c0, q0g = _corners_to_pose(moves[0] + origin)
            gate_body = p.loadURDF(
                gate_urdf_path, basePosition=c0.tolist(),
                baseOrientation=q0g.tolist(), useFixedBase=True,
                physicsClientId=client,
            )
            os.unlink(gate_urdf_path)

        action = np.zeros(4)
        t_pred = 0.0
        states13 = []
        contacts = []
        for i in range(n_steps):
            pos, quat_xyzw = p.getBasePositionAndOrientation(
                body, physicsClientId=client)
            vel_w, omega_w = p.getBaseVelocity(body, physicsClientId=client)
            rpy = np.asarray(p.getEulerFromQuaternion(quat_xyzw))
            R = np.asarray(
                p.getMatrixFromQuaternion(quat_xyzw)).reshape(3, 3)
            omega_b = R.T @ np.asarray(omega_w)
            # euler rates from body rates: d_rpy = Q(rpy) @ omega_b — the
            # adapter inverts this transform (angu_vel_tran_w2b)
            roll, pitch = rpy[0], rpy[1]
            Q_inv = np.array(
                [[1.0, 0.0, -np.sin(pitch)],
                 [0.0, np.cos(roll), np.sin(roll) * np.cos(pitch)],
                 [0.0, -np.sin(roll), np.cos(roll) * np.cos(pitch)]]
            )
            d_rpy = np.linalg.solve(Q_inv, omega_b)

            if i % ctrl_every == 0:
                action, t_pred = ctrl.compute_control(
                    step=i,
                    cur_pos=np.asarray(pos),
                    cur_quat_xyzw=np.asarray(quat_xyzw),
                    cur_vel=np.asarray(vel_w),
                    cur_euler_rates=d_rpy,
                    cur_rpy=rpy,
                )

            # DynAviary dynamics-mode actuation: thrust along body +z,
            # torques in the body frame (GateAviary/DynAviary contract)
            p.applyExternalForce(
                body, -1, forceObj=[0.0, 0.0, float(action[0])],
                posObj=[0.0, 0.0, 0.0], flags=p.LINK_FRAME,
                physicsClientId=client)
            p.applyExternalTorque(
                body, -1, torqueObj=[float(action[1]), float(action[2]),
                                     float(action[3])],
                flags=p.LINK_FRAME, physicsClientId=client)
            if gate_body is not None:
                ci, qi = _corners_to_pose(
                    moves[min(i, len(moves) - 1)] + origin)
                p.resetBasePositionAndOrientation(
                    gate_body, ci.tolist(), qi.tolist(),
                    physicsClientId=client)
            p.stepSimulation(physicsClientId=client)
            if gate_body is not None:
                for cp in p.getContactPoints(
                        bodyA=body, bodyB=gate_body, physicsClientId=client):
                    # cp[5] = position on A (world), cp[9] = normal force
                    contacts.append((i, tuple(cp[5]), float(cp[9])))

            pos, quat_xyzw = p.getBasePositionAndOrientation(
                body, physicsClientId=client)
            vel_w, omega_w = p.getBaseVelocity(body, physicsClientId=client)
            R = np.asarray(p.getMatrixFromQuaternion(quat_xyzw)).reshape(3, 3)
            q = np.asarray(quat_xyzw)[[3, 0, 1, 2]]
            states13.append(np.concatenate(
                [np.asarray(pos), np.asarray(vel_w), q,
                 R.T @ np.asarray(omega_w)]))
    finally:
        p.disconnect(physicsClientId=client)

    states13 = np.asarray(states13)
    gate_world = [moves[min(i, len(moves) - 1)] + origin
                  for i in range(n_steps)]
    crossed, margin = _traversal_metrics(
        states13, gate_world, scen["gate_width"], cfg.half_gate_height)
    final_dist = float(np.linalg.norm(
        states13[-1, 0:3] - (np.asarray(scen["final_point"]) + origin)))
    return {
        "scenario": scen,
        "through_gate": crossed,
        "gate_margin": margin,
        "final_distance": final_dist,
        "states": states13,
        "engine": "pybullet",
        "physical_gate": bool(physical_gate),
        "contacts": contacts,
        "n_contact_steps": len({c[0] for c in contacts}),
    }
