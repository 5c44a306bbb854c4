"""Typed configuration for the whole framework.

The reference hard-codes every hyperparameter as module-level magic numbers and
maintains behavioral variants as *forked files* (top-level vs
gym_pybullet_drone/ copies).  Here every knob is a field on a frozen dataclass
and the fork deltas are captured as two `Variant` presets.

Reference values (cited against /root/reference):
  - vehicle "hb": J=(0.0023,0.0023,0.004), m=0.5, l=0.35, c=0.0245
    (quad_policy.py:36-37); gravity g=9.78 (quad_model.py:37).
  - cost weights wrt=5, wqt=80, wthrust=0.1, wrf=5, wvf=5, wqf=0, wwf=3
    (quad_policy.py:38).
  - control bounds [0, 2*1.22] N/rotor, omega bound +-pi/2 (quad_policy.py:46-51);
    PyBullet fork uses ub=2.4 (gym_pybullet_drone/quad_policy.py:48).
  - horizon 50, dt 0.1 (quad_policy.py:17,43).
  - traversal attitude cost squared in main variant (quad_model.py:210),
    un-squared in the PyBullet fork (gym copy:200).
  - reward 1000*collision - 0.5*path + 100, safety margin d_min=0.2
    (quad_policy.py:90; solid_geometry.py:115).
  - sampler ranges (quad_nn.py:18-48) and the PyBullet fork deltas
    (gym_pybullet_drone/Yixiao_ctrl_wrapper.py:143-173).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import jax.numpy as jnp


class Variant(enum.Enum):
    """Fork deltas of the reference, exposed as config instead of file copies."""

    MAIN = "main"          # top-level files of the reference
    PYBULLET = "pybullet"  # gym_pybullet_drone/ fork


@dataclasses.dataclass(frozen=True)
class QuadParams:
    """Physical parameters of the quadrotor (reference quad_policy.py:36-37)."""

    Jx: float = 0.0023
    Jy: float = 0.0023
    Jz: float = 0.004
    mass: float = 0.5
    l: float = 0.35       # arm length
    c: float = 0.0245     # torque coefficient
    g: float = 9.78       # gravity (quad_model.py:37 uses 9.78, not 9.81)

    @property
    def J(self) -> Tuple[float, float, float]:
        return (self.Jx, self.Jy, self.Jz)

    def inertia_diag(self):
        return jnp.array([self.Jx, self.Jy, self.Jz])


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """Weights of the gate-traversal optimal-control cost (quad_policy.py:38)."""

    wrt: float = 5.0       # traversal position
    wqt: float = 80.0      # traversal attitude
    wthrust: float = 0.1   # thrust magnitude
    wrf: float = 5.0       # goal position (path + final)
    wvf: float = 5.0       # goal velocity
    wqf: float = 0.0       # goal attitude
    wwf: float = 3.0       # angular-rate
    w_du: float = 1.0      # control-rate smoothing |u_k - u_{k-1}|^2 (quad_OC.py:150)
    # Gaussian traversal-time window: amp * exp(-decay*(dt*k - t)^2) (quad_OC.py:145)
    tra_amp: float = 60.0
    tra_decay: float = 10.0
    # traversal attitude term squared? (quad_model.py:210 vs gym fork:200)
    squared_attitude: bool = True


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched iLQR solver configuration (replaces CasADi/IPOPT, quad_OC.py:104-212)."""

    horizon: int = 50
    dt: float = 0.1
    u_lb: float = 0.0
    u_ub: float = 2.44          # 2*1.22 (quad_policy.py:48-51); PYBULLET: 2.4
    w_bound: float = 1.5707963267948966   # omega in [-pi/2, pi/2]
    w_bound_weight: float = 0.0 # soft penalty weight for the omega bound (0 = off)
    max_iters: int = 64         # iLQR iterations (static; converged problems no-op)
    tol: float = 1e-9           # relative cost-decrease tolerance
    gtol: float = 1e-7          # relative projected-gradient (KKT) tolerance
    stall_gtol: float = 1e-4    # loose KKT gate for the 'stalled' early exit:
                                # an iterate may stop on a failed line search at
                                # high reg ONLY if it is already near-optimal;
                                # otherwise keep escalating reg (saddle escape)
    use_ddp: bool = True        # include 2nd-order dynamics terms (full DDP)
    reg_init: float = 1.0
    reg_min: float = 1e-8
    reg_max: float = 1e8
    reg_shrink: float = 0.5     # reg multiplier after an accepted step
    reg_grow: float = 8.0       # reg multiplier after a rejected step
    boxqp_iters: int = 6        # projected-Newton iterations for the 4-dim boxQP
    line_search_steps: int = 14 # backtracking powers of 0.5 (min alpha ~1.2e-4)
    ls_adaptive: bool = False   # warm-start the backtracking at (last accepted
                                # index - 1) instead of alpha=1 every iteration.
                                # Default OFF: on hard cold single solves the
                                # warm start can crawl at small alphas (the
                                # H=50 flagship needs 69 iterations fixed vs
                                # >300 adaptive).  The batched THROUGHPUT path
                                # turns it on together with ls_max_trips=4,
                                # where it pays: +1.2pp frac-within-1%-of-
                                # golden at equal budget and it is what makes
                                # the trip cap safe (each lane retries near
                                # its own working step size)
    ls_max_trips: int = 14      # alpha evaluations per solver iteration before
                                # the search reports failure and hands the lane
                                # to the reg schedule (grow x8, retry).
                                # Default 14 = the full ladder (reference-
                                # faithful).  The batched THROUGHPUT path sets
                                # 4: in lock-step any ONE failing lane walking
                                # the whole ladder costs the WHOLE batch a
                                # forward kernel per depth — measured 13.9
                                # forward kernels/iteration at batch 2048,
                                # 4.0 with the cap, for +38% solves/s at equal
                                # quality (bench.py: cap 4 @ 50 iters beats
                                # uncapped @ 45 on both axes).  Single-problem
                                # cold solves keep the full ladder: the cap
                                # can tip a cold solve into a nearby worse
                                # basin (observed +0.3% at H=15)
    no_progress_iters: int = 0  # progress-WINDOW termination: terminate a
                                # lane when an entire window of this many
                                # iterations produced less than tol*(|J|+1)
                                # CUMULATIVE cost decrease, regardless of the
                                # KKT residual.  Measured necessity (r4
                                # audit, scripts/dev_convergence_audit.py):
                                # at f32, 835/2048 bench lanes sit
                                # within 1e-3 of the converged cost but hold
                                # pg_rel ~1e-2 — the true gradient stays
                                # large at the f32 rollout's resolution
                                # floor, so neither the gtol nor the stall
                                # gate ever fires and the lane burns the
                                # full iteration cap (and every warm-started
                                # 10 Hz replan ran to the cap).  A WINDOW is
                                # the only cut that proved quality-safe:
                                # consecutive-rejection strikes and model-
                                # decrement gates both cut lanes mid-descent
                                # (stiff reg-escalation phases legally make
                                # zero progress for several iterations
                                # before a big accepted step).  Default 0 =
                                # OFF: the floor is an f32 throughput/
                                # deployment heuristic (set ~8 at those
                                # operating points — bench.py, closed-loop
                                # deployment); the f64 oracle path keeps
                                # run-to-tolerance semantics.
    quantize_t: bool = True     # round traversal time to 0.1 s (quad_policy.py:70)
    backward: str = "sequential"  # Riccati sweep: "sequential" (reverse scan)
                                  # or "parallel" (associative scan over the
                                  # horizon, O(log H) depth; iLQR mode — see
                                  # solver/parallel_riccati.py)

    @property
    def n_state(self) -> int:
        return 13

    @property
    def n_ctrl(self) -> int:
        return 4


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Trajectory reward (quad_policy.py:85-90; solid_geometry.py:115)."""

    collision_weight: float = 1000.0
    path_weight: float = 0.5
    reward_offset: float = 100.0
    d_min: float = 0.2         # safety margin inside the gate
    wing_len: float = 1.5      # rotor-tip span used for collision (quad_policy.py:19)
    n_path_points: int = 4     # terminal points entering the path term


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Scenario sampler ranges (quad_nn.py:18-48; PyBullet fork deltas gym copy:18-35)."""

    init_pos_halfwidth: float = 5.0
    init_pos_offset: Tuple[float, float, float] = (0.0, -9.0, 0.0)
    final_pos_halfwidth: float = 2.0
    final_pos_offset: Tuple[float, float, float] = (0.0, 6.0, 0.0)
    yaw_halfwidth: float = 0.1            # PYBULLET: pi/6
    width_mean: float = 0.9               # PYBULLET: same mean, sigma 0.2
    width_std: float = 0.3
    width_clip: Tuple[float, float] = (0.5, 1.25)   # PYBULLET: (0.8, 1.5)
    gate_half_height: float = 1.0         # gate corners at z = +-1 (main.py:25)


@dataclasses.dataclass(frozen=True)
class GateMotionConfig:
    """Moving-gate kinematics (quad_model.py:769-790; main.py:45-47)."""

    velocity: Tuple[float, float, float] = (1.0, 0.3, 0.4)
    omega_y: float = 1.5707963267948966   # pi/2 rad/s pitch rate
    noise_std: float = 0.1
    noise_clip: float = 0.1               # PYBULLET fork: 0.2
    sim_T: float = 5.0
    sim_dt: float = 0.01


@dataclasses.dataclass(frozen=True)
class LearnedGradConfig:
    """Reference finite-difference learning-signal semantics (quad_policy.py:94-112)."""

    delta: float = 1e-3
    clip: float = 0.5
    pos_scale: float = 0.1
    # angle grads scaled by 1/(500*a_i^2 + 5)
    ang_scale_a: float = 500.0
    ang_scale_b: float = 5.0
    t_probe: float = 0.1
    t_step: float = 0.05
    t_threshold: float = 2.0


def preset(variant: Variant = Variant.MAIN):
    """Return (QuadParams, CostWeights, SolverConfig, RewardConfig, SamplerConfig,
    GateMotionConfig) for a reference variant."""
    if variant == Variant.MAIN:
        return (
            QuadParams(),
            CostWeights(),
            SolverConfig(),
            RewardConfig(),
            SamplerConfig(),
            GateMotionConfig(),
        )
    # PyBullet fork deltas (SURVEY.md section 2.9)
    return (
        QuadParams(),
        CostWeights(squared_attitude=False),
        SolverConfig(u_ub=2.4),
        RewardConfig(),
        SamplerConfig(
            yaw_halfwidth=0.5235987755982988,  # pi/6
            width_std=0.2,
            width_clip=(0.8, 1.5),
        ),
        GateMotionConfig(noise_clip=0.2),
    )
