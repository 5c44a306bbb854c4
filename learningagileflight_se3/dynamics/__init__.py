from learningagileflight_se3.dynamics.quadrotor import (
    quad_ode,
    euler_step,
    rk4_step,
    rollout,
    mixer_matrix,
    thrust_torque,
    rotor_positions,
)
