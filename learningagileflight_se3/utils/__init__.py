from learningagileflight_se3.utils.checkpoint import save_params, load_params
