from learningagileflight_se3.sim.tsolver import make_traversal_time_solver
from learningagileflight_se3.sim.closed_loop import (
    ClosedLoopLog,
    ClosedLoopMetrics,
    evaluate_closed_loop,
    evaluate_closed_loop_full,
    make_closed_loop_sim,
)
from learningagileflight_se3.sim.external_controller import (
    ExternalSimController,
    euler_rates_to_body,
)
from learningagileflight_se3.sim.validation_env import (
    ValidationEnv,
    ValidationEnvConfig,
)
from learningagileflight_se3.sim.validation_sim import (
    SimLogger,
    ValidationSimConfig,
    run_validation_sim,
    sample_validation_scenario,
)
