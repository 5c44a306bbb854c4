from learningagileflight_se3.core.rotations import (
    quat_to_dcm_w2b,
    quat_to_dcm_b2w,
    omega_matrix,
    quat_mul,
    quat_conj,
    axis_angle_to_quat,
    rodrigues_to_axis_angle,
    rodrigues_to_quat,
    skew,
    dcm_to_quat,
    normalize,
)
