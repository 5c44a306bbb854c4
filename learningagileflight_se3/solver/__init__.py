from learningagileflight_se3.solver.ilqr import (
    MPCSolution,
    make_mpc_solver,
    make_batched_mpc_solver,
)
from learningagileflight_se3.solver.boxqp import boxqp
from learningagileflight_se3.solver.constrained import make_w_bounded_solver
from learningagileflight_se3.solver.costate import make_costate_extractor
