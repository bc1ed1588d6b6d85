"""The port's train step on EgoLanes and stochastic depth against the JAX
package's, on the CPU in f32 at atol 2e-4, rtol 1e-3, with the same masks
on both sides (tests/test_torch_train_step.py has the method).

EgoLanes at dryrun depth (B0_DRYRUN_STAGES, ctx_hw (2, 4)) on 64x128,
batch 2, its weighted BCE + edge loss: the train-mode logits, the loss, the
gradients, the BatchNorm running statistics, the params and AdamW's
moments after two steps.
"""
import pytest

from test_torch_train_step import (check_forward_and_loss, check_grads_stats_moments,  # noqa: F401
                                   one_thread, run_both)


@pytest.fixture(scope="module")
def ego_lanes():
    with pytest.MonkeyPatch.context() as mp:
        return run_both(mp, "EgoLanes", 1, 2, False)


def test_train_forward_and_loss(ego_lanes):
    check_forward_and_loss(*ego_lanes)


def test_gradients_bn_stats_and_moments(ego_lanes):
    check_grads_stats_moments(*ego_lanes)
