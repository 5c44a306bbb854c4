from learningagileflight_se3.costs.gate_costs import (
    goal_cost,
    traversal_cost,
    thrust_cost,
    traversal_weight,
    stage_cost,
    final_cost,
    total_trajectory_cost,
)
