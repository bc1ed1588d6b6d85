"""The int8 inference wrapper of Scene3D at full depth against the JAX
package's, conv by conv, on the CPU: the checks of
tests/test_torch_infer_int8.py (whose docstring says what is held and why)
on a network whose B0 trunk is not cut to dryrun depth, so that every int8
shape of the trunk at min_channels 128, and the N = 1 depth head, is held
too.
"""
import pytest

from test_torch_infer_int8 import build_wrappers, check_conv_by_conv, check_weights_and_scales
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module", params=["scene_3d"])
def wrappers(request):
    return build_wrappers(request.param)


def test_int8_wrapper_weights_and_scales_equal_jax(wrappers):
    check_weights_and_scales(wrappers)


def test_int8_wrapper_conv_by_conv_equals_jax(wrappers):
    check_conv_by_conv(wrappers)
