from learningagileflight_se3.train.pretrain import (
    make_pretrain_step,
    run_pretraining,
)
from learningagileflight_se3.train.rl import (
    make_rl_train_step,
    run_rl_training,
)
from learningagileflight_se3.train.imitation import (
    make_imitation_collect,
    make_imitation_train_step,
    run_imitation_training,
)
