"""The port's int8 conv with JAX's whole rule (strided, dilated and grouped
convs, a padding a dimension) against the int8 branch of the JAX package's
Conv2d (autoware_vision_pilot_tpu/nn/layers.py:73-79, :81-113), the
selection of export/quantize.py::quantize_for_int8_conv and
train/qat.py::int8_variables_from_qat against JAX's on the four YOLO-family
nets, and the "strided" route's plan and tiling. On the CPU, where the
wrappers run the kernels' plain versions.

Inputs are drawn with numpy from seeds. The int32 accumulators are
bit-exact (JAX's lax.conv_general_dilated with preferred_element_type
int32 against the port's int8_conv with out_dtype int32); the dequantized
outputs within atol 2e-4, rtol 1e-3 of JAX's layer run op by op; the
quantized weights, w_scale and x_scale bit-equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from autoware_vision_pilot_tpu.export.quantize import (
    quantize_variables_for_int8_conv as jax_quantize)
from autoware_vision_pilot_tpu.models import auto_drive as jad
from autoware_vision_pilot_tpu.models import auto_speed as jas
from autoware_vision_pilot_tpu.models import auto_steer as jast
from autoware_vision_pilot_tpu.models import auto_steer_temporal as jtmp
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.train import qat as jqat
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export.quantize import quantize_for_int8_conv
from autoware_vision_pilot_tpu_torch.models import auto_drive as tad
from autoware_vision_pilot_tpu_torch.models import auto_speed as tas
from autoware_vision_pilot_tpu_torch.models import auto_steer as tast
from autoware_vision_pilot_tpu_torch.models import auto_steer_temporal as ttmp
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
    HALO_WIDTHS, MAX_BOX, MAX_CLUSTER, MAX_TRAVERSAL, ST_SMEM, ST_STEP, ST_TILE,
    clusters_at_once, dynamic_input_scale, geometry, int8_conv, int8_conv_plan, int8_quantize,
    out_size, strided_dim, strided_layout, strided_units)
from autoware_vision_pilot_tpu_torch.train import qat as tqat

from test_torch_layers import from_port, normal_input, port_with, seeded_variables, to_port
from test_torch_qat import jax_qat, name_map, rnd
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

CL = torch.channels_last
ATOL, RTOL = 2e-4, 1e-3

# name -> (cin, cout, kernel, stride, padding, dilation, groups, input hw):
# the strided convs JAX's rule selects on the YOLO-family nets (3x3 stride
# 2 at 64 -> 64, 128 -> 128 and 128 -> 256; AutoSteer's 2x1 convs at stride
# (2, 1); AutoSteer-temporal's 32 -> 64 and 64 -> 128), a dilated and a
# grouped conv that no net has but the rule would quantize, and a padding
# of its own a dimension
SHAPES = {
    "3x3 s2 64->64": (64, 64, 3, 2, 1, 1, 1, (12, 20)),
    "3x3 s2 128->128": (128, 128, 3, 2, 1, 1, 1, (10, 14)),
    "3x3 s2 128->256": (128, 256, 3, 2, 1, 1, 1, (8, 12)),
    "2x1 s(2,1) 64->32": (64, 32, (2, 1), (2, 1), 0, 1, 1, (16, 6)),
    "temporal 3x3 s2 32->64": (32, 64, 3, 2, 1, 1, 1, (20, 40)),
    "temporal 3x3 s2 64->128": (64, 128, 3, 2, 1, 1, 1, (10, 20)),
    "dilated 3x3 d2 48->40": (48, 40, 3, 1, 2, 2, 1, (9, 13)),
    "grouped 3x3 s2 g4 128->64": (128, 64, 3, 2, 1, 1, 4, (9, 11)),
    "pad (1, 0) 3x3 s(1, 2) 48->24": (48, 24, 3, (1, 2), (1, 0), 1, 1, (7, 12)),
}
# a per-input-channel scale is folded into the weights (cin of them), which
# a grouped conv's kernel (cin / groups inputs) cannot take, in either package
CASES = [(name, scale) for name, shape in SHAPES.items()
         for scale in ("dynamic", "scalar", "vector") if shape[6] == 1 or scale != "vector"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def scale_for(kind, x):
    """A calibration-like static scale (times 0.9 for the scalar, so that
    some values clip)."""
    if kind == "scalar":
        return np.float32(float(np.abs(x).max()) * 0.9 / 127.0)
    if kind == "vector":
        return (np.abs(x).max(axis=(0, 1, 2)).astype(np.float64) / 127.0).astype(np.float32)
    return None


def jax_accumulators(xq, w, stride, padding, dilation, groups):
    """The int32 accumulators of JAX's int8 branch (nn/layers.py:73-79,
    :110-111) on the int8 NHWC input."""
    (ph, pw), (sh, sw), (dh, dw) = _pair(padding), _pair(stride), _pair(dilation)
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(w), window_strides=(sh, sw),
        padding=[(ph, ph), (pw, pw)], rhs_dilation=(dh, dw),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("name,scale", CASES, ids=[f"{n} {s}" for n, s in CASES])
def test_strided_int8_conv_matches_jax(name, scale):
    cin, cout, k, stride, pad, dil, groups, hw = SHAPES[name]
    seed = sum(map(ord, name)) + len(scale)
    x = normal_input((2, *hw, cin), seed=seed) * np.linspace(0.5, 2.0, cin, dtype=np.float32)
    jmod = jl.Conv2d(cout, k, stride, pad, groups=groups, dilation=dil)
    sx = scale_for(scale, x)
    qv = jax_quantize(seeded_variables(jmod, x, seed=seed + 1), 32,
                      act_scales=None if sx is None else {(): sx})
    assert qv["params"]["w"].dtype == jnp.int8  # the rule selects it
    m = tl.Int8Conv2d(cin, cout, k, pad, stride=stride, dilation=dil, groups=groups,
                      input_scale_shape=None if sx is None else sx.shape)
    m.load_state_dict(variables_to_state_dict(qv, m), strict=True)
    xt = to_port(x)
    got = from_port(m(xt))
    want = np.asarray(jmod.apply(qv, x))  # op by op: the layer's own two roundings
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    # the quantized input and the int32 accumulators, bit for bit
    s = torch.from_numpy(np.asarray(sx)) if sx is not None else dynamic_input_scale(xt)[0]
    xq = int8_quantize(xt, s)
    sj = np.asarray(s.numpy() if s.dim() else s.item(), np.float32)
    want_q = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / sj), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(from_port(xq), want_q)
    acc = int8_conv(xq, m.weight, m.weight_scale, s, None, pad, torch.int32, stride=stride,
                    dilation=dil, groups=groups)
    np.testing.assert_array_equal(
        from_port(acc), jax_accumulators(want_q, qv["params"]["w"], stride, pad, dil, groups))


# (JAX net, port net, input NHWC) at full width; the CTX blocks of the
# YOLO nets are built for their input size
NETS = {
    "AutoSpeed n": (lambda: jas.AutoSpeedNetwork("n", 4, 128, 128),
                    lambda: tas.AutoSpeedNetwork("n", 4, 128, 128), (1, 128, 128, 3)),
    "AutoSteer": (lambda: jast.AutoSteerNetwork("n", 128, 1024),
                  lambda: tast.AutoSteerNetwork("n", 128, 1024), (1, 128, 1024, 3)),
    "AutoDrive": (lambda: jad.AutoDriveNetwork(128, 256),
                  lambda: tad.AutoDriveNetwork(128, 256), (1, 128, 256, 3)),
    "AutoSteer-temporal": (lambda: jtmp.AutoSteerTemporalNet(),
                           lambda: ttmp.AutoSteerTemporalNet(), (1, 80, 160, 6)),
}
# the strided convs each net's rule selects at min_channels 32 and 128
STRIDED = {"AutoSpeed n": (5, 3), "AutoSteer": (5, 2), "AutoDrive": (3, 2),
           "AutoSteer-temporal": (3, 1)}


@pytest.fixture(scope="module")
def net_variables():
    cache = {}

    def get(name):
        if name not in cache:
            jnet, _, shape = NETS[name]
            inputs = (jnp.zeros(shape),) * (2 if name == "AutoDrive" else 1)
            cache[name] = seeded_variables(jnet(), *inputs, seed=sum(map(ord, name)))
        return cache[name]
    return get


@pytest.mark.parametrize("min_channels", [16, 32, 128])
@pytest.mark.parametrize("net", list(NETS))
def test_quantize_selects_as_jax_on_the_yolo_nets(net, min_channels, net_variables):
    v = net_variables(net)
    qv = jax_quantize(v, min_channels)
    port = port_with(NETS[net][1](), v)
    quantize_for_int8_conv(port, min_channels)
    got = port.state_dict()
    want = variables_to_state_dict(qv, port)  # strict: the same convs selected
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k].to(want[k].dtype), want[k]), k
    int8 = [m for m in port.modules() if isinstance(m, tl.Int8Conv2d)]
    assert len(int8) == sum(leaf.dtype == jnp.int8 for leaf in jax.tree.leaves(qv))
    strided = sum(m.stride != (1, 1) for m in int8)
    if min_channels in (32, 128):
        assert strided == STRIDED[net][min_channels == 128]


def test_qat_export_of_autosteer_temporal_matches_jax():
    """JAX's int8_variables_from_qat and the port's on AutoSteer-temporal at
    min_channels 32 (four convs, three of them strided): the same convs,
    bit-equal int8 weights, w_scale and static x_scale, and each int8 conv,
    fed JAX's input, equal to JAX's branch within the stated bar."""
    jmod, port = jtmp.AutoSteerTemporalNet(), ttmp.AutoSteerTemporalNet()
    v = seeded_variables(jmod, jnp.zeros((1, 80, 160, 6)), seed=61)
    x = rnd((1, 80, 160, 6), 62)
    _, inputs, jscales, _ = jax_qat(jmod, v, x)
    qv = jqat.int8_variables_from_qat(v, jscales, 32)
    port = port_with(port, v)
    names = name_map(port)
    # the QAT selection and the export's: the same convs
    assert set(tqat.selected_convs(port, 32)) == {names[p] for p in jscales}
    int8 = tqat.int8_variables_from_qat(port, {names[p]: s for p, s in jscales.items()}, 32)
    want = variables_to_state_dict(qv, int8)
    for k, t in int8.state_dict().items():
        assert torch.equal(t, want[k]), k
    convs = {n: m for n, m in int8.named_modules() if isinstance(m, tl.Int8Conv2d)}
    assert len(convs) == 4
    assert sum(m.stride == (2, 2) for m in convs.values()) == 3
    for path, jx in inputs.items():
        name = names[path]
        if name not in convs:
            continue
        leaf = qv["params"]
        for p in path:
            leaf = leaf[p]
        m = convs[name]
        kh, kw, _, cout = leaf["w"].shape
        jconv = jl.Conv2d(cout, (kh, kw), m.stride, m.padding)
        want_y = np.asarray(jconv.apply({"params": dict(leaf)}, jnp.asarray(jx)))
        with torch.no_grad():
            got_y = from_port(m(to_port(jx).contiguous(memory_format=CL)))
        np.testing.assert_allclose(got_y, want_y, atol=ATOL, rtol=RTOL, err_msg=name)


PLAN_SHAPES = [  # (B, H, W, C, N, KH, KW, pad, stride, dilation)
    (1, 160, 160, 64, 64, 3, 3, 1, 2, 1),      # AutoSpeed p3_0 at 640x640
    (1, 80, 80, 128, 128, 3, 3, 1, 2, 1),      # p4_0
    (1, 40, 40, 128, 256, 3, 3, 1, 2, 1),      # p5_0
    (1, 80, 80, 64, 64, 3, 3, 1, 2, 1),        # fpn.h3
    (1, 40, 40, 128, 128, 3, 3, 1, 2, 1),      # fpn.h5
    (1, 128, 256, 64, 32, 2, 1, 0, (2, 1), 1),  # AutoSteer's head.v1 at 512x1024
    (1, 16, 32, 64, 32, 2, 1, 0, (2, 1), 1),   # and at a small size
    (1, 40, 80, 32, 64, 3, 3, 1, 2, 1),        # AutoSteer-temporal c2
    (1, 20, 40, 64, 128, 3, 3, 1, 2, 1),       # c3
    (1, 10, 20, 128, 128, 3, 3, 1, 2, 1),      # c4
    (2, 9, 13, 48, 40, 3, 3, 2, 1, 2),         # dilated
    (1, 7, 12, 48, 24, 3, 3, (1, 0), (1, 2), 1),  # a padding a dimension
    (1, 40, 60, 32, 16, 3, 3, 1, 12, 1),       # a stride above TMA's traversal limit
    (1, 300, 300, 16, 16, 1, 1, 0, (9, 3), 1),
    (1, 48, 48, 32, 64, 11, 11, 5, 2, 1),      # a step's phase groups in two units
    (1, 20, 150, 16, 8, 1, 3, 0, 1, (1, 70)),  # a phase halo too long: a box a tap
]


def replay(xq, w, plan, geo):
    """The strided route's arithmetic on the CPU, as csrc/int8_conv_strided.cu
    runs it: for each (tile, N tile) and each rank of the cluster, the
    rank's K steps of 32 channels, a step's groups in units of the plan's;
    each group's halo as the block gathers it (ext_h x hw positions, element
    (y, x) the input at the group's base plus (y, x) strides, zeros outside
    the image and past C) in a slab whose positions past the halo hold
    garbage; each tap's A the ST_TILE positions from its line offset
    on; the ranks' int32 tiles summed, and the positions that are outputs
    stored."""
    B, C, H, W = xq.shape
    N, _, KH, KW = w.shape
    ph, pw, sh, sw, dil_h, dil_w = geo
    OH, OW = out_size(H, W, KH, KW, geo)
    th, tw, bn = plan.th, plan.tw, plan.bn
    phase_h, phase_w, gu = plan.phases
    dh = strided_dim(KH, sh, dil_h, ph, th, phase_h)
    dw = strided_dim(KW, sw, dil_w, pw, tw, phase_w)
    hw, G = dw.ext, dh.groups * dw.groups
    layout = strided_layout(dh, dw, gu, bn, plan.per_split * math.ceil(G / gu), plan.grid[2])
    rows = layout.slab_pitch // 16  # the positions a slab holds
    m_tiles, n_tiles, cs = plan.grid
    steps = plan.iters
    x = F.pad(xq.long(), (0, 0, 0, 0, 0, steps * ST_STEP - C)).permute(0, 2, 3, 1)  # NHWC
    wl = F.pad(w.long(), (0, 0, 0, 0, 0, steps * ST_STEP - C)).permute(0, 2, 3, 1)
    wl = F.pad(wl, (0, 0, 0, 0, 0, 0, 0, n_tiles * bn - N))  # (n_tiles bn, KH, KW, C)
    units = strided_units(dh, dw, gu)
    g = torch.Generator().manual_seed(7)
    out = torch.full((B, OH, OW, N), -1, dtype=torch.long)
    tiles_h, tiles_w = math.ceil(OH / th), math.ceil(OW / tw)
    ys, xs = torch.arange(dh.ext), torch.arange(dw.ext)
    for m in range(m_tiles):
        b, rem = divmod(m, tiles_h * tiles_w)
        oh0, ow0 = rem // tiles_w * th, rem % tiles_w * tw
        halos = []  # each group's halo of every channel step, in a slab of `rows` positions
        for gi in range(G):
            gh, gw = divmod(gi, dw.groups)
            rr = oh0 * sh + dh.base[gh] + ys * dh.estride
            cc = ow0 * sw + dw.base[gw] + xs * dw.estride
            ok = ((rr >= 0) & (rr < H))[:, None] & ((cc >= 0) & (cc < W))[None, :]
            box = x[b][rr.clamp(0, H - 1)][:, cc.clamp(0, W - 1)] * ok[:, :, None]
            slab = torch.randint(-127, 128, (rows, steps * ST_STEP), generator=g)
            slab[:dh.ext * hw] = box.reshape(dh.ext * hw, -1)
            halos.append(slab)
        for n in range(n_tiles):
            total = torch.zeros((ST_TILE, bn), dtype=torch.long)
            for z in range(cs):
                for step in range(z * plan.per_split, min(steps, (z + 1) * plan.per_split)):
                    c = slice(step * ST_STEP, (step + 1) * ST_STEP)
                    for u, taps in enumerate(units):
                        for r, q in taps:
                            gi = dh.tap_group[r] * dw.groups + dw.tap_group[q]
                            assert gi // gu == u
                            lo = dh.tap_line[r] * hw + dw.tap_line[q]
                            a = halos[gi][lo:lo + ST_TILE, c]
                            total += a @ wl[n * bn:(n + 1) * bn, r, q, c].T
            for pos in range(ST_TILE):
                y, xx = divmod(pos, hw)
                if y < th and xx < tw and oh0 + y < OH and ow0 + xx < OW:
                    ncols = min(bn, N - n * bn)
                    out[b, oh0 + y, ow0 + xx, n * bn:n * bn + ncols] = total[pos, :ncols]
    return out.permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[str(s) for s in PLAN_SHAPES])
def test_strided_plan_is_valid_and_its_tiling_computes_the_conv(shape):
    B, H, W, C, N, KH, KW, pad, stride, dil = shape
    geo = geometry(pad, stride, dil)
    plan = int8_conv_plan(B, H, W, C, N, KH, KW, pad, 132, stride, dil)
    assert plan.route == "strided"
    OH, OW = out_size(H, W, KH, KW, geo)
    ph, pw, sh, sw, dil_h, dil_w = geo
    phase_h, phase_w, gu = plan.phases
    dh = strided_dim(KH, sh, dil_h, ph, plan.th, phase_h)
    dw = strided_dim(KW, sw, dil_w, pw, plan.tw, phase_w)
    # the tiles cover the output: th x tw outputs in th hw <= ST_TILE positions
    assert plan.th * dw.ext <= ST_TILE and plan.th <= OH and plan.tw <= OW
    m_tiles, n_tiles, cs = plan.grid
    assert m_tiles == B * math.ceil(OH / plan.th) * math.ceil(OW / plan.tw)
    assert plan.bn in HALO_WIDTHS and n_tiles == math.ceil(N / plan.bn)
    assert plan.bn >= N or plan.bn == HALO_WIDTHS[-1]
    # each halo within the route's limits: at most MAX_BOX input elements, its
    # lines at most MAX_TRAVERSAL apart
    for d, t in ((dh, plan.th), (dw, plan.tw)):
        assert d.fits and d.box <= MAX_BOX and (d.box == 1 or d.estride <= MAX_TRAVERSAL)
        assert d.ext == t + d.span and len(d.base) == d.groups
        if d.phase:  # a halo a phase: each input line of the tile loaded once
            assert d.groups <= d.estride and len(set(d.base)) == d.groups
    if max(sh, sw) <= MAX_TRAVERSAL and KH * KW > 1 and max(dil_h, dil_w) < 8:
        assert phase_h and phase_w  # the YOLO nets' shapes, dilated or not
    # the cluster: at most 8 ranks whose K ranges of 32-channel steps cover K exactly
    assert plan.iters == math.ceil(C / ST_STEP) and 1 <= cs <= MAX_CLUSTER
    ranges = [range(z * plan.per_split, min(plan.iters, (z + 1) * plan.per_split))
              for z in range(cs)]
    assert all(len(r) > 0 for r in ranges) and sum(map(list, ranges), []) == list(
        range(plan.iters))
    assert plan.blocks == m_tiles * n_tiles * cs
    assert cs == 1 or m_tiles * n_tiles <= clusters_at_once(cs, 132)
    layout = strided_layout(dh, dw, gu, plan.bn, plan.per_split * math.ceil(
        dh.groups * dw.groups / gu), cs)
    assert layout.smem <= ST_SMEM and layout.stages == plan.stages >= 1
    if B * OH * OW * N <= 200_000:  # the replay at the smaller shapes
        g = torch.Generator().manual_seed(B * H + W + C)
        xq = torch.randint(-127, 128, (B, C, H, W), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (N, C, KH, KW), generator=g, dtype=torch.int8)
        want = F.conv2d(xq.double(), w.double(), None, geo[2:4], geo[:2], geo[4:]).round().long()
        assert torch.equal(replay(xq, w, plan, geo), want)
        got = int8_conv(xq.contiguous(memory_format=CL), w.contiguous(memory_format=CL),
                        torch.ones(N), torch.tensor(1.0), None, geo[:2], torch.int32,
                        stride=geo[2:4], dilation=geo[4:])
        assert torch.equal(got.long(), want)


def test_stride_one_convs_keep_their_routes():
    """A stride-1 conv with one padding takes the routes it took before;
    the same window at stride 2, a dilation or a padding a dimension takes
    "strided"."""
    assert int8_conv_plan(1, 80, 160, 256, 256, 3, 3, 1).route == "wgmma"
    assert int8_conv_plan(1, 80, 160, 256, 256, 3, 3, (1, 1), 132, 1, 1).route == "wgmma"
    assert int8_conv_plan(1, 80, 160, 64, 64, 3, 3, 1).route == "halo"
    assert int8_conv_plan(1, 80, 160, 64, 64, 1, 1, 0).route == "pointwise"
    for kw in (dict(stride=2), dict(dilation=2), dict(stride=(1, 2))):
        assert int8_conv_plan(1, 80, 160, 256, 256, 3, 3, 1, 132, **kw).route == "strided"
    assert int8_conv_plan(1, 80, 160, 256, 256, 3, 3, (1, 0), 132).route == "strided"
    assert int8_conv_plan(1, 80, 160, 64, 64, 1, 1, 0, 132, 2).route == "strided"
