"""LearningAgileFlight-SE3: a JAX learning + MPC framework for agile
quadrotor flight through narrow (possibly moving) gates.

A ground-up JAX/XLA re-design of the capabilities of the reference
system (yanrui89/LearningAgileFlight_SE3): SE(3) quadrotor dynamics, a
gate-traversal optimal-control problem, a differentiable batched MPC solver
(iLQR with control box constraints replacing CasADi/IPOPT), vmap-safe gate
geometry + collision reward, plain-JAX policy networks (DNN1/DNN2), the full
three-stage training pipeline (supervised pretrain -> differentiable-MPC RL ->
imitation), scaled over device meshes with `shard_map` + collectives.

Layering (bottom -> top):
  core/      pure-JAX quaternion / rotation / SE(3) math
  dynamics/  analytic 13-state quadrotor ODE + Euler/RK4 steppers + rollouts
  costs/     goal / traversal / thrust stage costs and the Gaussian time window
  solver/    batched control-limited iLQR + differentiable-MPC gradients
  geometry/  gate kinematics and branch-free collision reward
  oracle/    independent CPU f64 oracle solvers (test-only)
  models/    MLP policies (DNN1, DNN2) + scenario samplers
  train/     pretraining, RL, imitation drivers
  parallel/  mesh construction and sharded training steps
  sim/       closed-loop evaluation (moving gate), traversal-time solver
  utils/     config-free helpers: logging, IO, checkpoints
"""

__version__ = "0.1.0"

from learningagileflight_se3.config import (
    QuadParams,
    CostWeights,
    SolverConfig,
    SamplerConfig,
    Variant,
)
