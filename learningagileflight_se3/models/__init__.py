from learningagileflight_se3.models.mlp import MLP, make_dnn1, make_dnn2, surrogate_inner_loss
from learningagileflight_se3.models.sampler import (
    sample_scenario,
    sample_scenarios,
    pretrain_label,
    scenario_to_problem,
)
