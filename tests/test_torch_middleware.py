"""The port's middleware (middleware/nodes.py, transport.py, ros2_codec.py)
against the JAX package's, on the CPU in f32.

Weights and inputs are drawn with numpy from seeds; the JAX variables go to
both sides (the port loads them through convert/from_jax.py, strictly).
What is held, and why:
- the model nodes: the logits behind each message at atol 2e-4, rtol 1e-3
  (tests/test_models_parity.py's bar); the message itself exactly wherever
  those logits do not sit within DECIDED of a tie (a class margin for the
  seg ids, the threshold for the lane masks), at least 95 % of it (the
  masks are small: 16x32 ids, an 8x16x3 lane stack); the depth message is
  the logits themselves, at the bar;
- RunAutoSpeedNode: the pred at the bar; fed JAX's pred (a forward hook
  here, a stand-in model there) its (N, 6) rows equal JAX's node run op by
  op (jitted, XLA contracts the decode's box arithmetic: an ulp away,
  tests/test_torch_backend.py);
- the nodes that run no net: equal messages. PathFinder's noise is JAX's
  own draws (its node run op by op; the port's node draws from a
  torch.Generator, so the draws are handed over through process_noise); its
  lane fits sum f32 normal equations in another order, so the states they
  reach are held at tests/test_torch_lateral.py's PF_TOL, the rest exactly;
- the codec and the ROS2/Zenoh transports, over the fake rclpy, message and
  zenoh modules of tests/test_middleware.py: byte for byte.
"""
import builtins
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu import middleware as jmw
from autoware_vision_pilot_tpu.models.auto_speed import AutoSpeedNetwork as JSpeed
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JLanes
from autoware_vision_pilot_tpu.models.scene_3d import Scene3DNetwork as JScene3D
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.ops.preprocess import letterbox as j_letterbox
from autoware_vision_pilot_tpu.perception import path_finder as jpf

from autoware_vision_pilot_tpu_torch import middleware as tmw
from autoware_vision_pilot_tpu_torch.inference.infer import load_weights
from autoware_vision_pilot_tpu_torch.middleware import nodes as tnodes
from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
from autoware_vision_pilot_tpu_torch.models import (EgoLanesNetwork,
                                                    Scene3DNetwork, SceneSegNetwork)
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
from autoware_vision_pilot_tpu_torch.perception import path_finder as tpf

from test_middleware import FakeCapture, _install_fake_ros2
from test_torch_lateral import PF_TOL, assert_close_scaled
from test_torch_layers import P, seeded_variables
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

IN_HW, CTX = (32, 64), (1, 2)
FRAMES = [np.random.default_rng(s).integers(0, 256, (64, 128, 3), dtype=np.uint8)
          for s in range(2)]
DECIDED = 1e-3
ATOL, RTOL = 2e-4, 1e-3

# model_type -> (JAX network, port network)
NETS = {
    "segmentation": (lambda: JSceneSeg(ctx_hw=CTX, backbone_stages=J_DRYRUN, precision=P),
                     lambda: SceneSegNetwork(CTX, B0_DRYRUN_STAGES)),
    "depth": (lambda: JScene3D(ctx_hw=CTX, precision=P), lambda: Scene3DNetwork(CTX)),
    "egolanes": (lambda: JLanes(ctx_hw=CTX, backbone_stages=J_DRYRUN, precision=P),
                 lambda: EgoLanesNetwork(CTX, B0_DRYRUN_STAGES)),
}


def recorded(backend, outs):
    """``backend`` with each do_inference output appended to ``outs``."""
    run = backend.do_inference

    def do_inference(frame):
        outs.append(run(frame))
        return outs[-1]

    backend.do_inference = do_inference
    return backend


@pytest.mark.parametrize("model_type", list(NETS))
def test_run_model_node_matches_jax(model_type):
    """The same two frames through JAX's RunModelNode and the port's, each
    over its own backend on the same variables (JAX's geometry of
    tests/test_middleware.py: 64x128 frames, a 32x64 input)."""
    jnet, port_net = NETS[model_type]
    spec = jax.ShapeDtypeStruct((1, *IN_HW, 3), jnp.float32)
    v = seeded_variables(jnet(), spec, seed=70 + list(NETS).index(model_type))
    logits, msgs = {"jax": [], "port": []}, {"jax": [], "port": []}
    for side, mw, backend in [
            ("jax", jmw, jmw.JaxInferenceBackend(jnet(), v, input_hw=IN_HW, dtype=jnp.float32)),
            ("port", tmw, tmw.TorchInferenceBackend(
                load_weights(port_net(), v, device="cpu"), input_hw=IN_HW, dtype=torch.float32))]:
        t = mw.InProcTransport()
        mw.RunModelNode(t, recorded(backend, logits[side]), output_topic="/out",
                        model_type=model_type)
        t.subscribe("/out", msgs[side].append)
        assert mw.VideoPublisherNode(t, FakeCapture(FRAMES)).spin() == 2
    for lt, lj, mt, mj in zip(logits["port"], logits["jax"], msgs["port"], msgs["jax"]):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)
        assert mt.dtype == mj.dtype and mt.shape == mj.shape
        if model_type == "depth":
            np.testing.assert_array_equal(mt, lt[..., 0])
            np.testing.assert_allclose(mt, mj, atol=ATOL, rtol=RTOL)
            continue
        if model_type == "segmentation":
            top = np.sort(lt, axis=-1)
            where = top[..., -1] - top[..., -2] > DECIDED
        else:
            where = np.abs(lt) > DECIDED
        assert where.mean() > 0.95  # a 8x16x3 lane stack: 4 of 384 undecided
        np.testing.assert_array_equal(mt[where], mj[where])


def test_run_autospeed_node_matches_jax():
    """tests/test_torch_longitudinal.py's geometry (180x320 frames, a
    128x128 input: scale 0.4, pad_y 28) at the node's thresholds 0.5/0.5:
    the pred within the bar; fed JAX's pred, the published rows equal."""
    frame_hw, input_hw = (180, 320), (128, 128)
    frame = np.random.default_rng(72).integers(0, 256, (*frame_hw, 3), dtype=np.uint8)
    jnet = JSpeed(variant="n", num_classes=4, img_h=128, img_w=128, precision=P)
    x, _, _ = j_letterbox(jnp.asarray(frame)[None], input_hw, frame_hw)
    v = seeded_variables(jnet, x, seed=73)
    pred_j = np.array(jax.jit(jnet.apply)(v, x))
    got = {"jax": [], "port": []}
    tt = tmw.InProcTransport()
    node = tmw.RunAutoSpeedNode(tt, AutoSpeedNetwork("n", 4, *input_hw), v, frame_hw=frame_hw,
                                input_hw=input_hw, dtype=torch.float32, device="cpu")
    assert (node.infer.conf_thresh, node.infer.iou_thresh) == (0.5, 0.5)
    tt.subscribe("/autospeed/detections", got["port"].append)
    seen = []
    hook = node.infer.model.register_forward_hook(lambda m, a, y: seen.append(y))
    tt.publish("/image_raw", frame)
    hook.remove()
    np.testing.assert_allclose(seen[0].numpy(), pred_j, atol=ATOL, rtol=RTOL)
    node.infer.model.register_forward_hook(lambda m, a, y: torch.from_numpy(pred_j))
    tt.publish("/image_raw", frame)
    jt = jmw.InProcTransport()
    stand_in = types.SimpleNamespace(apply=lambda variables, x: jnp.asarray(pred_j))
    jmw.RunAutoSpeedNode(jt, stand_in, v, frame_hw=frame_hw, input_hw=input_hw,
                         dtype=jnp.float32)
    jt.subscribe("/autospeed/detections", got["jax"].append)
    with jax.disable_jit():
        jt.publish("/image_raw", frame)
    port, ref = got["port"][1], got["jax"][0]
    assert port.dtype == np.float32 and port.shape[1] == 6 and 0 < len(port) <= 64
    np.testing.assert_array_equal(port, ref)


def lane(offset, n, seed, curve=0.0):
    rng = np.random.default_rng(seed)
    ys = np.sort(rng.uniform(0.0, 25.0, n))
    return [(offset + curve * y * y + rng.normal(0, 0.05), y) for y in ys]


# the states no lane fit reaches (the path's cte, yaw and curvature, the
# curvature from the AutoSteer feed-forward, the width's aux): noise and
# filter arithmetic only, the same in both packages
UNFITTED = [0, 4, 8, 9, 10, 11, 13]


def test_path_finder_node_matches_jax_with_its_draws(monkeypatch):
    """Twelve ticks of lane paths (both lanes, one, none, more than MAX_PTS
    points) into both nodes, the port fed the draws of JAX's node (run op
    by op): every tracked_states message, the states no fit reaches
    exactly, the rest at tests/test_torch_lateral.py's PF_TOL (its f32
    normal equations sum in another order in each package)."""
    draws = []
    real_split = jax.random.split

    def split(key, *a, **k):  # the JAX node splits once a tick: k1 feeds the draw
        out = real_split(key, *a, **k)
        draws.append(np.asarray(jax.random.uniform(out[0], (jpf.STATE_DIM,),
                                                   minval=-1e-5, maxval=1e-5)))
        return out

    monkeypatch.setattr(jax.random, "split", split)
    jt, tt = jmw.InProcTransport(), tmw.InProcTransport()
    got = {"jax": [], "port": []}
    jmw.PathFinderNode(jt, seed=4)
    node = tmw.PathFinderNode(tt, seed=4, device="cpu")
    assert node.state.mean.device.type == "cpu"
    jt.subscribe("/pathfinder/tracked_states", got["jax"].append)
    tt.subscribe("/pathfinder/tracked_states", got["port"].append)
    monkeypatch.setattr(tpf, "process_noise",
                        lambda generator, device: torch.from_numpy(draws[len(got["port"])].copy()))
    ticks = ([(lane(1.8, 12, i), lane(-1.7, 12, 50 + i)) for i in range(5)]
             + [(lane(2.0, 40, 9, 0.002), lane(-1.5, 40, 10, 0.002))] * 2
             + [(lane(1.9, 8, 11), None), (None, None), (None, lane(-2.0, 3, 12))]
             + [(lane(1.8, 2, 13), lane(-1.8, 20, 14))] * 2)
    with jax.disable_jit():
        for left, right in ticks:
            for t in (jt, tt):
                t.publish("/egoLaneL", left)
                t.publish("/egoLaneR", right)
                t.publish("/egoPath", [(0.0, 1.0)])
    assert len(got["port"]) == len(got["jax"]) == len(ticks) == len(draws)
    for i, (a, b) in enumerate(zip(got["port"], got["jax"])):
        assert a.dtype == np.float32 and a.shape == (14,)
        b = np.asarray(b)
        np.testing.assert_array_equal(a[UNFITTED], b[UNFITTED], err_msg=f"tick {i}")
        assert_close_scaled(a, b, PF_TOL, f"tick {i}")
    assert abs(got["port"][4][12] - 3.5) < 0.2     # lane width
    assert node.generator.initial_seed() == 4


def test_path_finder_node_draws_from_its_generator():
    """Without a patch the port's node draws each tick's noise from its own
    generator: the same as path_finder_update with a generator of the same
    seed."""
    t = tmw.InProcTransport()
    node = tmw.PathFinderNode(t, seed=7, device="cpu")
    state = tpf.BayesState.init(device="cpu")
    generator = torch.Generator().manual_seed(7)
    left, right = lane(1.8, 10, 1), lane(-1.7, 10, 2)
    t.publish("/egoLaneL", left)
    t.publish("/egoLaneR", right)
    for _ in range(3):
        means = node._on_path(None)
        lp, lm = node._pack(left)
        rp, rm = node._pack(right)
        _, state = tpf.path_finder_update(state, lp, lm, rp, rm, torch.zeros(()),
                                          generator=generator)
        np.testing.assert_array_equal(means, state.mean.numpy())


def test_controller_nodes_match_jax():
    """The steering and longitudinal controller nodes of both packages on
    the same odometry, IMU and tracked_states messages: equal commands."""
    rng = np.random.default_rng(75)
    cmds = {}
    for side, mw in (("jax", jmw), ("port", tmw)):
        t = mw.InProcTransport()
        out = cmds[side] = {"steer": [], "throttle": [], "brake": []}
        for topic, key in (("/vehicle/steering_cmd", "steer"),
                           ("/vehicle/throttle_cmd", "throttle"),
                           ("/vehicle/brake_cmd", "brake")):
            t.subscribe(topic, out[key].append)
        mw.SteeringControllerNode(t)
        mw.LongitudinalControllerNode(t, target_vel=12.0)
        rng = np.random.default_rng(75)
        for i in range(30):
            states = rng.normal(0, 0.3, 14).astype(np.float32)
            states[11] = rng.uniform(-0.3, 0.3)
            t.publish("/pathfinder/tracked_states", states if i % 7 else states[:5])
            t.publish("/carla/hero/imu", {"linear_acceleration": {"x": rng.normal(0, 2)}}
                      if i % 2 else rng.normal(0, 2))
            t.publish("/hero/odom", {"twist": {"linear": {"x": rng.uniform(0, 20)}}}
                      if i % 3 else rng.uniform(0, 20))
    assert cmds["port"] == cmds["jax"]
    assert len(cmds["port"]["steer"]) == 25 and len(cmds["port"]["throttle"]) == 30
    assert any(b > 0 for b in cmds["port"]["brake"]) and any(cmds["port"]["throttle"])
    assert tmw.LongitudinalControllerNode.vel_to_throttle(5.0) == \
        jmw.LongitudinalControllerNode.vel_to_throttle(5.0)
    with pytest.raises(ValueError):
        tmw.LongitudinalControllerNode.vel_to_throttle(-1.0)


class FakeBackend:
    def __init__(self, p):
        self.p = p

    def do_inference(self, img):
        rng = np.random.default_rng(int(img[0, 0, 0]) + len(self.p.get("output_topic", "")))
        return rng.normal(size=(20, 40, 3)).astype(np.float32)


PARAMS = {
    "scene_seg_model": {"ros__parameters": {
        "model_type": "segmentation", "input_topic": "/sensors/video/image_raw",
        "output_topic": "/autoseg/scene_seg/mask"}},
    "scene_3d_model": {"ros__parameters": {
        "model_type": "depth", "input_topic": "/sensors/video/image_raw",
        "output_topic": "/autoseg/scene_3d/depth"}},
    "ego_lanes_model": {"model_type": "egolanes", "input_topic": "/sensors/video/image_raw"},
    "auto_speed_model": {"ros__parameters": {
        "model_type": "detection", "input_topic": "/sensors/video/image_raw",
        "output_topic": "/autospeed/detections"}},
}


def test_launch_pipeline_matches_jax():
    """The autoseg.yaml-style params of both packages' launch_pipeline, with
    the same fake backends: the same node names, kinds and topics, and the
    same messages from the model nodes; the port's default detector is
    AutoSpeed "n" 640x640 with seed-0 weights, as build_engine draws them,
    and its default backends come from backend_from_params on ``device``."""
    got = {"jax": {}, "port": {}}
    nodes = {}
    for side, mw in (("jax", jmw), ("port", tmw)):
        t = mw.InProcTransport()
        seg_params = {k: v for k, v in PARAMS.items() if k != "auto_speed_model"}
        nodes[side] = mw.launch_pipeline(t, seg_params, make_backend=FakeBackend)
        for topic in ("/autoseg/scene_seg/mask", "/autoseg/scene_3d/depth",
                      "/ego_lanes_model/mask"):
            t.subscribe(topic, lambda m, topic=topic, side=side: got[side].setdefault(topic, m))
        t.publish("/sensors/video/image_raw", FRAMES[0])
    assert {k: type(n).__name__ for k, n in nodes["port"].items()} == \
        {k: type(n).__name__ for k, n in nodes["jax"].items()}
    for k, n in nodes["port"].items():
        assert (n.output_topic, n.model_type) == (nodes["jax"][k].output_topic,
                                                  nodes["jax"][k].model_type)
    assert got["port"].keys() == got["jax"].keys() and len(got["port"]) == 3
    for topic, m in got["port"].items():
        assert m.dtype == got["jax"][topic].dtype
        np.testing.assert_array_equal(m, got["jax"][topic])
    t = tmw.InProcTransport()
    made = tmw.launch_pipeline(t, PARAMS, device="cpu")
    det = made["auto_speed_model"]
    assert isinstance(det, tnodes.RunAutoSpeedNode) and det.output_topic == "/autospeed/detections"
    assert (det.infer.frame_hw, det.infer.input_hw, det.infer.dtype) == \
        ((720, 1280), (640, 640), torch.bfloat16)
    ref = AutoSpeedNetwork("n", 4, 640, 640)
    init_seeded(ref, torch.Generator().manual_seed(0))
    for a, b in zip(det.infer.model.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a.float(), b.to(torch.bfloat16).float())
    assert type(made["scene_3d_model"].backend.model) is Scene3DNetwork
    assert made["scene_seg_model"].backend.device.type == "cpu"
    assert made["ego_lanes_model"].output_topic == "/ego_lanes_model/mask"
    assert type(made["ego_lanes_model"].backend.model) is EgoLanesNetwork
    detector = []
    tmw.launch_pipeline(t, {"d": {"model_type": "detection"}}, device="cpu",
                        make_detector=lambda p: detector.append(p) or (None, None))
    assert detector == [{"model_type": "detection"}]


def test_masks_and_depth_visualization_nodes_match_jax():
    """The two visualization nodes (cv2 on the host) of both packages on the
    same frame, seg ids, lane masks and depth: equal overlays."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(76)
    frame = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    msgs = [("/model/output", rng.integers(0, 3, (32, 64)).astype(np.uint8), "scene"),
            ("/lanes", rng.integers(0, 2, (16, 32, 3)).astype(np.uint8), "egolanes")]
    depth = rng.normal(size=(32, 64)).astype(np.float32)
    out = {}
    for side, mw in (("jax", jmw), ("port", tmw)):
        t = mw.InProcTransport()
        res = out[side] = []
        for topic, _, palette in msgs:
            mw.MasksVisualizationNode(t, mask_topic=topic, output_topic="/viz",
                                      palette=palette)
        mw.DepthVisualizationNode(t, output_topic="/viz")
        t.subscribe("/viz", res.append)
        for topic, m, _ in msgs:
            t.publish(topic, m)      # no image yet: nothing
        t.publish("/model/depth", depth)
        t.publish("/image_raw", frame)
        for topic, m, _ in msgs:
            t.publish(topic, m)
        t.publish("/model/depth", depth)
    assert len(out["port"]) == len(out["jax"]) == 4
    for a, b in zip(out["port"], out["jax"]):
        assert a.dtype == np.uint8 and a.shape[-1] == 3
        np.testing.assert_array_equal(a, b)


# ---------- ROS2 and Zenoh, over the fakes of tests/test_middleware.py ----------

def image_fields(msg):
    return (msg.height, msg.width, msg.encoding, msg.is_bigendian, msg.step, bytes(msg.data),
            msg.header.frame_id)


def test_ros2_codec_matches_jax(monkeypatch):
    _install_fake_ros2(monkeypatch)
    from autoware_vision_pilot_tpu.middleware import ros2_codec as jcodec
    from autoware_vision_pilot_tpu_torch.middleware import ros2_codec as tcodec
    rng = np.random.default_rng(77)
    arrays = [(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8), None),
              (rng.integers(0, 256, (12, 16, 3), dtype=np.uint8), "rgb8"),
              (rng.integers(0, 2, (8, 16, 3), dtype=np.uint8), "8UC3"),
              (rng.integers(0, 3, (12, 16), dtype=np.uint8), None),
              (rng.integers(0, 2, (12, 16), dtype=np.uint8), "8UC1"),
              (rng.normal(size=(12, 16)).astype(np.float32), None),
              (rng.normal(size=(12, 16, 1)).astype(np.float32), "32FC1")]
    for arr, enc in arrays:
        assert tcodec.encoding_for(arr) == jcodec.encoding_for(arr)
        tmsg = tcodec.np_to_image_msg(arr, enc, frame_id="cam")
        assert image_fields(tmsg) == image_fields(jcodec.np_to_image_msg(arr, enc, frame_id="cam"))
        back, ref = tcodec.image_msg_to_np(tmsg), jcodec.image_msg_to_np(tmsg)
        assert back.dtype == ref.dtype and back.tobytes() == ref.tobytes()
    for bad in (np.zeros((2, 2), np.int64), np.zeros((2, 2, 2), np.float32)):
        for codec in (tcodec, jcodec):
            with pytest.raises(ValueError, match="no Image encoding"):
                codec.encoding_for(bad)
    with pytest.raises(ValueError, match="expects 3 channels"):
        tcodec.np_to_image_msg(np.zeros((2, 2), np.uint8), "bgr8")
    dets = np.concatenate([rng.uniform(0, 600, (5, 4)).astype(np.float32),
                           rng.uniform(0, 1, (5, 1)).astype(np.float32),
                           rng.integers(0, 4, (5, 1)).astype(np.float32)], 1)
    tmsg = tcodec.dets_to_detection2d_array(dets, frame_id="cam")
    jmsg = jcodec.dets_to_detection2d_array(dets, frame_id="cam")

    def det_fields(m):
        return [(d.bbox.center.position.x, d.bbox.center.position.y, d.bbox.size_x,
                 d.bbox.size_y, d.results[0].hypothesis.class_id, d.results[0].hypothesis.score)
                for d in m.detections] + [m.header.frame_id]

    assert det_fields(tmsg) == det_fields(jmsg)
    back = tcodec.detection2d_array_to_dets(tmsg)
    assert back.tobytes() == jcodec.detection2d_array_to_dets(tmsg).tobytes()
    np.testing.assert_allclose(back, dets, atol=1e-4)
    empty = tcodec.detection2d_array_to_dets(tcodec.dets_to_detection2d_array(dets[:0]))
    assert empty.shape == (0, 6)


def test_ros2_transport_matches_jax(monkeypatch):
    """Frames, seg ids, lane stacks (8UC3 by topic_types), depth and
    detections through both packages' Ros2Transport over the fake DDS bus:
    the same arrays delivered, byte for byte, and RunModelNode's mono8 mask
    across it."""
    from autoware_vision_pilot_tpu.middleware.transport import Ros2Transport as JRos2
    from autoware_vision_pilot_tpu_torch.middleware.transport import Ros2Transport as TRos2
    rng = np.random.default_rng(78)
    payloads = [("/image_raw", rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)),
                ("/seg", rng.integers(0, 3, (10, 14), dtype=np.uint8)),
                ("/lanes", rng.integers(0, 2, (5, 7, 3), dtype=np.uint8)),
                ("/depth", rng.normal(size=(10, 14)).astype(np.float32)),
                ("/dets", np.array([[0, 0, 10, 10, 0.8, 1], [5, 6, 9, 9, 0.4, 3]],
                                   np.float32))]
    got = {}
    for cls in (JRos2, TRos2):
        _install_fake_ros2(monkeypatch)
        t = cls(node_name="n", topic_types={"/lanes": "mask3", "/dets": "detections"})
        got[cls] = {}
        for topic, _ in payloads:
            t.subscribe(topic, lambda m, topic=topic, d=got[cls]: d.setdefault(topic, m))
        for topic, arr in payloads:
            t.publish(topic, arr)
        t.close()
    for topic, arr in payloads:
        a, b = got[TRos2][topic], got[JRos2][topic]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), topic
    _install_fake_ros2(monkeypatch)
    t = TRos2()
    masks = []
    t.subscribe("/model/output", masks.append)

    class Backend:
        def do_inference(self, frame):
            out = np.zeros((*frame.shape[:2], 3), np.float32)
            out[..., 2] = 1.0
            return out

    tmw.RunModelNode(t, Backend(), output_topic="/model/output")
    t.publish("/image_raw", payloads[0][1])
    assert masks[0].dtype == np.uint8 and masks[0].shape == (10, 14) and (masks[0] == 2).all()
    t.spin_once(0.0)
    t.close()


def fake_zenoh(monkeypatch):
    zenoh = types.ModuleType("zenoh")

    class Session:
        def __init__(self):
            self.subs, self.closed = {}, False

        def put(self, key, value):
            for cb in self.subs.get(key, []):
                cb(types.SimpleNamespace(payload=value))

        def declare_subscriber(self, key, cb):
            self.subs.setdefault(key, []).append(cb)
            return ("sub", key)

        def close(self):
            self.closed = True

    zenoh.Config = dict
    zenoh.open = lambda cfg: Session()
    monkeypatch.setitem(sys.modules, "zenoh", zenoh)


def test_zenoh_transport_and_make_transport_match_jax(monkeypatch):
    from autoware_vision_pilot_tpu.middleware import transport as jtr
    from autoware_vision_pilot_tpu_torch.middleware import transport as ttr
    fake_zenoh(monkeypatch)
    got = {}
    for mod in (jtr, ttr):
        t = mod.make_transport("zenoh")
        assert type(t).__name__ == "ZenohTransport"
        got[mod] = []
        t.subscribe("vp/frames", got[mod].append)
        t.publish("vp/frames", b"\x01\x02\x03")
        t.publish("vp/other", b"zzz")
        t.close()
        assert t._session.closed
        assert type(mod.make_transport("inproc")).__name__ == "InProcTransport"
        with pytest.raises(ValueError, match="unknown transport"):
            mod.make_transport("carrier_pigeon")
    assert got[ttr] == got[jtr] == [b"\x01\x02\x03"]
    monkeypatch.delitem(sys.modules, "zenoh")
    real_import = builtins.__import__

    def no_clients(name, *a, **k):
        if name in ("zenoh", "rclpy"):
            raise ImportError(f"no {name}")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_clients)
    for kind in ("zenoh", "ros2"):
        with pytest.raises(ImportError):
            ttr.make_transport(kind)
    assert isinstance(tmw.Transport(), ttr.Transport)
    with pytest.raises(NotImplementedError):
        ttr.Transport().publish("/x", 1)
