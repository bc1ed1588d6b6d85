"""The port's SceneSeg, Scene3D and DomainSeg networks (models/scene_seg.py,
scene_3d.py, domain_seg.py), ``multitask.import_from_individual_checkpoints``
and the overlay ops ``colorize_mask`` and ``blend_overlay``
(ops/postprocess.py) against the JAX package's, on the CPU in f32.

Weights and inputs are drawn with numpy from seeds; the JAX variables load
into the port through convert/from_jax.py with strict=True. The networks
at 64x128 with ctx_hw=(2, 4), at full width and depth (SceneSeg also at
dryrun depth); atol 2e-4, rtol 1e-3 (tests/test_models_parity.py's bar).
Exact: the imported stack's state_dict, colorize_mask, and blend_overlay
(the same f32 products and sum, each rounded on its own, then a truncation
to uint8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.models import multitask as jmt
from autoware_vision_pilot_tpu.models.domain_seg import DomainSegNetwork as JDomain
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.scene_3d import Scene3DNetwork as JScene3D
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.ops import postprocess as jpost

from autoware_vision_pilot_tpu_torch import models as tmodels
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import (DomainSegNetwork, Scene3DNetwork,
                                                    SceneSegNetwork)
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.models.multitask import (
    SharedPerceptionStack, import_from_individual_checkpoints)
from autoware_vision_pilot_tpu_torch.ops import postprocess as tpost

from test_torch_layers import P, assert_close, normal_input, port_with, seeded_variables, to_port

IMAGE = (1, 64, 128, 3)
CTX = (2, 4)

# name -> (JAX network, port network, output channels)
NETS = {
    "scene_seg": (lambda: JSceneSeg(ctx_hw=CTX, precision=P), lambda: SceneSegNetwork(CTX), 3),
    "scene_seg_dryrun": (lambda: JSceneSeg(ctx_hw=CTX, backbone_stages=J_DRYRUN, precision=P),
                         lambda: SceneSegNetwork(CTX, B0_DRYRUN_STAGES), 3),
    "scene_3d": (lambda: JScene3D(ctx_hw=CTX, precision=P), lambda: Scene3DNetwork(CTX), 1),
    "domain_seg": (lambda: JDomain(ctx_hw=CTX, precision=P), lambda: DomainSegNetwork(CTX), 1),
}


@pytest.mark.parametrize("name", list(NETS))
def test_network(name):
    jfn, pfn, out_ch = NETS[name]
    x = normal_input(IMAGE, seed=1)
    jnet = jfn()
    v = seeded_variables(jnet, x, seed=10 + list(NETS).index(name))
    port = port_with(pfn(), v)
    with torch.no_grad():
        y = port(to_port(x))
    assert tuple(y.shape) == (1, out_ch, *IMAGE[1:3])
    assert_close(y, jax.jit(jnet.apply)(v, x))


def test_models_exports():
    assert {"EfficientNetB0Features", "SceneSegNetwork", "Scene3DNetwork", "DomainSegNetwork",
            "EgoLanesNetwork"} <= set(dir(tmodels))


def stack_subtrees(v, names, prefix=None):
    """{collection: {name: subtree}} of the stack's tree ``v``, each name
    mapped to (new name, nested path) by ``names``."""
    out = {}
    for col, tree in v.items():
        dst = out.setdefault(col, {})
        for src, path in names.items():
            if src not in tree:
                continue
            node = dst
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = tree[src]
    return out


def test_import_from_individual_checkpoints():
    """The port's function on the separate networks' state_dicts gives,
    bit for bit, the state_dict that JAX's function on their variables
    converts to, and the stack loads it strictly. The separate networks'
    trees are cut from seeded stacks (SceneSeg's names are the stack's;
    Scene3D's backbone sits under PreTrainedBackbone.pretrainedBackBone,
    DomainSeg's upstream under DomainSegUpstream), and each loads strictly
    into its port network."""
    spec = jax.ShapeDtypeStruct(IMAGE, jnp.float32)
    base = seeded_variables(jmt.SharedPerceptionStack(ctx_hw=CTX, with_domain=True), spec,
                            seed=20)
    other = jax.tree.map(lambda a: a * np.float32(1.5) + np.float32(0.25), base)
    third = jax.tree.map(lambda a: a * np.float32(0.5) - np.float32(0.125), base)
    seg = stack_subtrees(other, {k: (k,) for k in
                                 ("Backbone", "SceneContext", "SceneNeck", "SceneSegHead")})
    s3d = stack_subtrees(third, {"Backbone": ("PreTrainedBackbone", "pretrainedBackBone"),
                                 "DepthContext": ("DepthContext",),
                                 "DepthNeck": ("DepthNeck",),
                                 "SuperDepthHead": ("SuperDepthHead",)})
    dom = stack_subtrees(third, {"Backbone": ("DomainSegUpstream", "pretrainedBackBone"),
                                 "SceneContext": ("DomainSegUpstream", "pretrainedContext"),
                                 "SceneNeck": ("DomainSegUpstream", "pretrainedNeck"),
                                 "DomainSegHead": ("DomainSegHead",)})
    stack = SharedPerceptionStack(CTX, True)
    sds = {"stack": variables_to_state_dict(base, stack),
           "seg": variables_to_state_dict(seg, SceneSegNetwork(CTX)),
           "3d": variables_to_state_dict(s3d, Scene3DNetwork(CTX)),
           "domain": variables_to_state_dict(dom, DomainSegNetwork(CTX))}
    want = variables_to_state_dict(
        jmt.import_from_individual_checkpoints(base, seg, s3d, dom), stack)
    got = import_from_individual_checkpoints(sds["stack"], sds["seg"], sds["3d"], sds["domain"])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for key, src in (("SceneSegHead.decode_layer_10.weight", "seg"),
                     ("Backbone.encoder.8.0.weight", "seg"),
                     ("DepthNeck.decode_layer_0.weight", "3d"),
                     ("DomainSegHead.decode_layer_10.bias", "domain")):
        assert torch.equal(got[key], sds[src][key]), key
    stack.load_state_dict(got, strict=True)
    # without the optional trees only the SceneSeg subtrees move
    only = import_from_individual_checkpoints(sds["stack"], sds["seg"])
    want = variables_to_state_dict(jmt.import_from_individual_checkpoints(base, seg), stack)
    assert set(only) == set(want) and all(torch.equal(only[k], want[k]) for k in want)
    assert torch.equal(only["DepthContext.context_layer_0.weight"],
                       sds["stack"]["DepthContext.context_layer_0.weight"])


def test_colorize_mask():
    rng = np.random.default_rng(80)
    mask = rng.integers(0, 5, (2, 7, 9)).astype(np.int32)
    palette = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    got = tpost.colorize_mask(torch.from_numpy(mask), palette)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 7, 9, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpost.colorize_mask(jnp.asarray(mask), palette)))


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.7, 0.25, 0.1])
def test_blend_overlay(alpha):
    """Every (image, colour) byte pair, so every tie of the truncation:
    at alpha 0.5, odd sums land on x.5 and truncate down; at 0.3 and 0.7
    the f32 products round to just below or above an integer. JAX op by
    op, as its function runs when called (under jit XLA may contract the
    product and the sum)."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    img, col = a.reshape(1, 256, 256, 1).repeat(3, -1), b.reshape(1, 256, 256, 1).repeat(3, -1)
    got = tpost.blend_overlay(torch.from_numpy(img), torch.from_numpy(col), alpha)
    want = np.asarray(jpost.blend_overlay(jnp.asarray(img), jnp.asarray(col), alpha))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    exact = (img.astype(np.float64) * (1 - alpha) + col.astype(np.float64) * alpha)
    assert np.abs(got.numpy() - np.floor(exact)).max() <= 1  # a truncation of the blend
