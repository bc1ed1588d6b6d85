"""Camera calibration, the port of autoware_vision_pilot_tpu/calibration:
the ground-plane homography (homography.py) and the standard camera pose
(camera_pose.py). numpy and cv2 on the host, no torch; the same
functions and exports, held to the JAX package's by
tests/test_torch_calibration.py."""
from .camera_pose import (
    get_rotation_matrix,
    undistort_image,
    rotation_homography,
    standardize_pose,
)
from .homography import (
    compute_homography,
    compute_homography_ransac,
    homography_reprojection_error,
    save_homography_yaml,
    load_homography_yaml,
)
