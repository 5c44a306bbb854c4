from learningagileflight_se3.oracle.numpy_reference import (
    np_quad_ode,
    np_euler_step,
    np_rollout,
    np_total_cost,
)
from learningagileflight_se3.oracle.shooting import solve_shooting_oracle
from learningagileflight_se3.oracle.lifted_nlp import (
    LiftedSolution,
    solve_lifted_oracle,
)
