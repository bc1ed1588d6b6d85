"""AutoSteer 2.0 (models/auto_steer.py), AutoDrive (models/auto_drive.py)
and the legacy EgoPath heads (models/ego_path.py) of the port against the
JAX package's, on the CPU in f32.

Weights and inputs are drawn with numpy from seeds; the JAX variables load
into the port through convert/from_jax.py with strict=True. Tolerance: atol
2e-4, rtol 1e-3 (tests/test_models_parity.py's bar; the YOLO nets'
activations grow to ~1e2 through CTX and C2PSA, so the relative term
carries).

Geometry: AutoDrive at 128x256, whose CTX maps are all at least 4x8
(XLA:CPU runs 3x3 convs on maps smaller than the kernel ~90x slower).
AutoSteer 2.0 at 128x1024: its height branch compresses the stride-4 width
by 16 twice, so at 128x256 the JAX network's height map is 0 columns wide
(and PyTorch refuses a window wider than its input); at 128x1024 it is one
column, as at the reference's 512x1024. The legacy AutoSteerHead at JAX's
test_auto_steer_head_functional shapes (a 10x20 context, a 40x80 neck).
"""
import jax
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.models import auto_drive as jad
from autoware_vision_pilot_tpu.models import auto_steer as jast
from autoware_vision_pilot_tpu.models import ego_path as jep
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import auto_drive as tad
from autoware_vision_pilot_tpu_torch.models import auto_steer as tast
from autoware_vision_pilot_tpu_torch.models import ego_path as tep

from test_torch_layers import (P, assert_close, normal_input, port_with,
                               seeded_variables, to_port)

STEER_HW = (128, 1024)
DRIVE_HW = (128, 256)


def run(port, jmod, v, *inputs):
    port_with(port, v)
    with torch.no_grad():
        ys = port(*[to_port(x) for x in inputs])
    return ys, jax.jit(jmod.apply)(v, *inputs)


def test_auto_steer_network():
    x = normal_input((1, *STEER_HW, 3), seed=1)
    jmod = jast.AutoSteerNetwork("n", *STEER_HW, precision=P)
    v = seeded_variables(jmod, x, seed=2)
    (lane, height), (lane_j, height_j) = run(tast.AutoSteerNetwork("n", *STEER_HW), jmod, v, x)
    assert tuple(lane.shape) == (1, 1, STEER_HW[0] // 8, 1)
    assert tuple(height.shape) == (1, 1, STEER_HW[0] // 8, 1)
    assert_close(lane, lane_j)
    assert_close(height, height_j)
    # a soft-argmax over the columns, divided by their count: in [0, 1)
    assert 0 <= float(lane.min()) and float(lane.max()) < 1


def test_auto_steer_percept_head_column_soft_argmax():
    """The head alone on feature maps of the 512x1024 geometry (p2 128x256,
    p3 64x128, 64 channels): the soft-argmax runs over W, the NHWC axis 2
    of the JAX module, dim 3 here."""
    p2 = normal_input((1, 128, 256, 64), seed=3)
    p3 = normal_input((1, 64, 128, 64), seed=4)
    jmod = jast.AutoSteerPerceptHead(128, precision=P)
    v = seeded_variables(jmod, (p2, p3), seed=5)
    port = port_with(tast.AutoSteerPerceptHead(128, 64), v)
    with torch.no_grad():
        lane, height = port((to_port(p2), to_port(p3)))
    lane_j, height_j = jax.jit(jmod.apply)(v, (p2, p3))
    assert tuple(lane.shape) == (1, 1, 64, 1) and tuple(height.shape) == (1, 1, 64, 1)
    assert_close(lane, lane_j)
    assert_close(height, height_j)


@pytest.fixture(scope="module")
def auto_drive():
    xp = normal_input((1, *DRIVE_HW, 3), seed=6)
    xc = normal_input((1, *DRIVE_HW, 3), seed=7)
    jmod = jad.AutoDriveNetwork(*DRIVE_HW, precision=P)
    v = seeded_variables(jmod, xp, xc, seed=8)
    return jmod, v, xp, xc


def test_auto_drive_network(auto_drive):
    jmod, v, xp, xc = auto_drive
    ys, refs = run(tad.AutoDriveNetwork(*DRIVE_HW), jmod, v, xp, xc)
    for name, y, r in zip(("d_norm", "curvature", "flag_logit"), ys, refs):
        assert tuple(y.shape) == (1, 1), name
        np.testing.assert_allclose(y.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    assert float(ys[0]) >= 0 and abs(float(ys[1])) <= 1
    d = torch.tensor([[0.0], [0.25], [1.0]])
    np.testing.assert_array_equal(tad.AutoDriveHead.to_distance_meters(d).numpy(),
                                  np.asarray(jad.AutoDriveHead.to_distance_meters(d.numpy())))


def test_auto_drive_backbone_runs_both_frames_as_one_batch(auto_drive):
    """The two frames go through the backbone as one batch of 2B, as in the
    JAX network, and the head sees frame t-1's P5 first: swapping the
    frames changes the outputs, and a batch of two pairs gives each pair's
    own."""
    jmod, v, xp, xc = auto_drive
    port = port_with(tad.AutoDriveNetwork(*DRIVE_HW), v)
    seen = []
    port.backbone.register_forward_hook(lambda m, a, y: seen.append(tuple(a[0].shape)))
    with torch.no_grad():
        one = port(to_port(xp), to_port(xc))
        swapped = port(to_port(xc), to_port(xp))
        both = port(to_port(np.concatenate([xp, xc])), to_port(np.concatenate([xc, xp])))
    assert seen == [(2, 3, *DRIVE_HW), (2, 3, *DRIVE_HW), (4, 3, *DRIVE_HW)]
    assert not torch.equal(one[2], swapped[2])
    for a, b, c in zip(one, swapped, both):
        np.testing.assert_allclose(c.numpy(), torch.cat([a, b]).numpy(), atol=2e-5, rtol=1e-5)


def test_bev_path_context_loads_strictly():
    """No dead upsample is declared on either side: the JAX tree fills the
    port's state_dict exactly."""
    x = normal_input((1, 10, 20, 1456), seed=9)
    jmod = jep.BEVPathContext(precision=P)
    v = seeded_variables(jmod, x, seed=10)
    port = tep.BEVPathContext()
    sd = variables_to_state_dict(v, port)
    assert set(sd) == set(port.state_dict())
    assert not any("upsample" in k for k in sd)
    port_with(port, v)
    with torch.no_grad():
        y = port(to_port(x))
    assert_close(y, jax.jit(jmod.apply)(v, x))


def test_auto_steer_head_functional_shapes():
    """JAX's test_auto_steer_head_functional shapes: a 10x20x256 context, a
    40x80x256 neck and a 10x20x64 previous feature -> a (1, 1) angle and
    a 10x20x64 feature; Linear(800) takes 64 * 10 * 20 = 12,800 inputs."""
    ctx = normal_input((1, 10, 20, 256), seed=11)
    neck = normal_input((1, 40, 80, 256), seed=12)
    prev = normal_input((1, 10, 20, 64), seed=13)
    jmod = jep.AutoSteerHead(precision=P)
    v = seeded_variables(jmod, ctx, neck, prev, seed=14)
    port = tep.AutoSteerHead(256, 10, 20)
    assert tuple(port.steering_decode_layer.weight.shape) == (800, 12_800)
    (angle, feat), (angle_j, feat_j) = run(port, jmod, v, ctx, neck, prev)
    assert tuple(angle.shape) == (1, 1) and tuple(feat.shape) == (1, 64, 10, 20)
    np.testing.assert_allclose(angle.numpy(), np.asarray(angle_j), atol=2e-4, rtol=1e-3)
    assert_close(feat, feat_j)
