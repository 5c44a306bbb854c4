"""Controller wrapper for EXTERNAL physics simulators (the PyBullet-harness
role, reference gym_pybullet_drone/Yixiao_ctrl_wrapper.py:24-184).

PyBullet itself is out of scope for the device compute path (SURVEY.md section
2.10); this module provides the exact control-stack adapter the reference's
`YXCtrlWrapper.computeControl` implements, against ANY host physics engine
that reports (pos, quat_xyzw, vel, euler_rates):

  1. state reassembly: position relative to the scenario origin, velocity,
     quaternion reorder xyzw -> wxyz (Yixiao_ctrl_wrapper.py:109-113),
     Euler-rate -> body angular rate (angu_vel_tran_w2b, lines 176-184);
  2. traversal-time fixed point (quad_moving.solver; PyBullet fork tol 1e-2);
  3. future-gate-pose prediction + 18-dim window input + DNN2;
  4. window-frame MPC solve (warm-started — capability the reference lacks);
  5. mixing to [thrust, tau_x, tau_y, tau_z] via
     diag([1, -l/2, l/2, -c]) @ A (Yixiao_ctrl_wrapper.py:136).

Everything device-side is one jitted function, and one 10 Hz tick costs
exactly ONE host->device upload (a packed 28-float observation), ONE
dispatch, and ONE device->host fetch (a packed 9-float result).  The
warm-start trajectory and previous control never leave the device between
ticks, and the thrust->wrench mixing happens on device so the fetched
packet already contains the deployable wrench: every extra blocking
transfer would add a host-device round trip to the reference's 100 ms
replan budget (main.py:76).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import (
    CostWeights,
    QuadParams,
    SolverConfig,
    Variant,
    preset,
)
from learningagileflight_se3.geometry.gate import (
    rotate_y,
    translate,
    window_inputs,
)
from learningagileflight_se3.sim.tsolver import make_traversal_time_solver
from learningagileflight_se3.solver.ilqr import make_batched_mpc_solver

# sign matrix A (Yixiao_ctrl_wrapper.py:88): maps rotor thrusts to the
# DynAviary [T, tau] convention together with diag([1, -l/2, l/2, -c])
_A = np.array(
    [
        [1.0, 1.0, 1.0, 1.0],
        [0.0, 1.0, 0.0, -1.0],
        [-1.0, 0.0, 1.0, 0.0],
        [-1.0, 1.0, -1.0, 1.0],
    ]
)


def euler_rates_to_body(d_rpy, rpy):
    """Euler-angle rates -> body angular velocity (angu_vel_tran_w2b,
    Yixiao_ctrl_wrapper.py:176-184)."""
    roll, pitch = rpy[0], rpy[1]
    Q_inv = np.array(
        [
            [1.0, 0.0, -np.sin(pitch)],
            [0.0, np.cos(roll), np.sin(roll) * np.cos(pitch)],
            [0.0, -np.sin(roll), np.cos(roll) * np.cos(pitch)],
        ]
    )
    return Q_inv @ np.asarray(d_rpy)


def quat_xyzw_to_wxyz(q):
    q = np.asarray(q)
    return q[[3, 0, 1, 2]]


class ExternalSimController:
    """Receding-horizon gate-traversal controller for an external simulator.

    Args:
      model2, nn2_params: the DNN2 window-frame policy.
      final_point: goal position in world frame.
      gate_motion: callable step -> (gate_pts (4,3), velocity (3,)) giving
        the gate's current corners and translational velocity (the reference
        precomputes these via gate.move, Yixiao_ctrl_wrapper.py:76-87).
      w_rot: gate pitch rate (rad/s).
      origin: scenario origin subtracted from raw positions
        (self.relative_ori, Yixiao_ctrl_wrapper.py:109).
    """

    def __init__(
        self,
        model2,
        nn2_params,
        final_point,
        gate_motion,
        w_rot: float,
        origin=(0.0, 0.0, 0.0),
        variant: Variant = Variant.PYBULLET,
        solver_cfg: Optional[SolverConfig] = None,
        params: Optional[QuadParams] = None,
        weights: Optional[CostWeights] = None,
        fixed_point_tol: float = 1e-2,
        fixed_point_accel: str = "reference",
        warm_start: bool = True,
    ):
        p, w, s, *_ = preset(variant)
        self.params = params or p
        self.weights = weights or w
        self.solver_cfg = solver_cfg or s
        self.model2 = model2
        self.nn2_params = nn2_params
        self.final_point = np.asarray(final_point, dtype=np.float64)
        self.gate_motion = gate_motion
        self.w_rot = float(w_rot)
        self.origin = np.asarray(origin, dtype=np.float64)
        self.warm_start = warm_start

        self.u = np.zeros(4)
        self._mix = np.diag([1.0, -self.params.l / 2, self.params.l / 2, -self.params.c]) @ _A

        tsolve = make_traversal_time_solver(model2, tol=fixed_point_tol,
                                            accel=fixed_point_accel)
        solve = make_batched_mpc_solver(
            self.params, self.weights, self.solver_cfg, return_gains=False
        )
        H = self.solver_cfg.horizon
        ulb, uub = self.solver_cfg.u_lb, self.solver_cfg.u_ub

        mix_dev = jnp.asarray(self._mix)
        final_dev = jnp.asarray(self.final_point)

        # Device-resident tick carry (previous control + warm-start U): the
        # warm trajectory is produced and consumed on device, so it is never
        # fetched.
        @jax.jit
        def _device_step(nn2_params, obs, u_prev, U_warm):
            state = obs[0:13]
            gate_pts = obs[13:25].reshape(4, 3)
            velo = obs[25:28]
            t = tsolve(nn2_params, state, final_dev, gate_pts, velo, self.w_rot)
            pts_f = rotate_y(translate(gate_pts, t * velo), t * self.w_rot)
            inp = window_inputs(pts_f, state, final_dev)
            out = model2.apply(nn2_params, inp)
            # one query as a batch of one; row 0 is the answer
            one = lambda a: a[None]
            sol = solve(
                one(inp[0:13]), one(u_prev), one(inp[13:16]),
                one(out[0:3]), one(out[3:6]), one(out[6]),
                U_init=one(U_warm),
            )
            u = sol.control_traj[0, 0]
            packed = jnp.concatenate(
                [mix_dev @ u, u, jnp.reshape(t, (1,)).astype(u.dtype)]
            )
            return packed, u, sol.control_traj[0]

        self._device_step = _device_step
        # The tick carry must present the SAME aval AND sharding on every
        # call: jit outputs are committed (SingleDeviceSharding) and
        # strongly typed, so the initial carry is device_put-committed with
        # the canonical strong float dtype — otherwise tick 1 recompiles
        # the whole program (a ~3 s stall mid-flight).
        dev0 = jax.devices()[0]
        self._nn2_dev = jax.device_put(nn2_params, dev0)
        self._u_dev = jax.device_put(
            jnp.zeros(4, dtype=jnp.result_type(float)), dev0)
        self._U_dev = None
        self._hover_U = jax.device_put(
            jnp.full((H, 4), 0.5 * (ulb + uub), dtype=jnp.result_type(float)),
            dev0)

    def compute_control(self, step, cur_pos, cur_quat_xyzw, cur_vel, cur_euler_rates, cur_rpy):
        """One 10 Hz control query. Returns ([T, tau_x, tau_y, tau_z], t)."""
        gate_pts, velo = self.gate_motion(step)
        state = np.hstack(
            [
                np.asarray(cur_pos) - self.origin,
                np.asarray(cur_vel),
                quat_xyzw_to_wxyz(cur_quat_xyzw),
                euler_rates_to_body(cur_euler_rates, cur_rpy),
            ]
        )
        obs = np.concatenate(
            [state, np.asarray(gate_pts, dtype=np.float64).ravel(),
             np.asarray(velo, dtype=np.float64)]
        )
        U_warm = self._U_dev if (self.warm_start and self._U_dev is not None) else self._hover_U
        packed, self._u_dev, self._U_dev = self._device_step(
            self._nn2_dev, jnp.asarray(obs), self._u_dev, U_warm
        )
        res = np.asarray(packed)  # the tick's single blocking fetch
        self.u = res[4:8]
        return res[0:4], float(res[8])
