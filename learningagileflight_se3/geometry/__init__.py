from learningagileflight_se3.geometry.gate import (
    gate_from_width,
    gate_centroid,
    gate_frame,
    gate_width,
    gate_pitch,
    rotate_y,
    rotate_z,
    translate,
    transform_state_to_window,
    final_to_window,
    window_inputs,
    gate_move,
)
from learningagileflight_se3.geometry.collision import (
    collision_score,
    trajectory_reward,
)
