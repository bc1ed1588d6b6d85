"""Reference ONNX artifacts -> the port's modules, the port of
autoware_vision_pilot_tpu/convert/onnx_import.py.

Released VisionPilot weights ship as ``.onnx`` graphs produced by
``Models/exports/convert_pytorch_to_onnx.py`` (torch.onnx.export,
export_params=True, opset 18). Every learned parameter is a graph
initializer, named after its ``state_dict`` key unless constant folding
rewrote it. Two import paths, as in the JAX package:

1. **Named path**: the initializers are a torch state_dict, handed to
   ``torch_import.import_state_dict`` (the ``.pth`` path's importer).
2. **Folded path** (``do_constant_folding=True`` exports, BatchNorm fused
   into the preceding conv): the BN initializers are gone and the convs
   carry the fused values. ``recover_mangled_names`` renames fused
   ``onnx::Conv_<idx>`` initializers back to state_dict keys from the
   graph's node names, ``_route_folded_biases`` puts a fused bias of a
   bias-free conv into the BN after it, and ``fold_missing_bn`` sets every
   BN the file did not fill to the identity, so the module computes the
   folded graph's function.

``import_onnx`` returns a full state_dict for the module, which
``load_state_dict`` takes. No ``onnx`` or ``onnxruntime``: ``onnx_proto``
is a pure-Python wire codec. Held to the JAX importer key by key
(tests/test_torch_convert_import.py), including its behaviour with
``strict=False``: the stripped-prefix candidate is then never tried.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from . import onnx_proto
from .torch_import import Targets, as_tensor, import_state_dict, targets_of


def load_onnx_state_dict(path, recover: bool = False) -> Dict[str, np.ndarray]:
    """Read a .onnx file -> {initializer name: numpy array}, every
    initializer (the exporter's shape constants too). With ``recover=True``
    mangled names are rewritten to state_dict keys (recover_mangled_names)."""
    model = onnx_proto.load_model(path)
    sd = {name: t.to_numpy() for name, t in model.graph.initializers.items()}
    return recover_mangled_names(model, sd) if recover else sd


# Ops whose inputs carry learned parameters: input index -> state_dict leaf.
_WEIGHTED_OPS = {
    "Conv": {1: "weight", 2: "bias"},
    "ConvTranspose": {1: "weight", 2: "bias"},
    "Gemm": {1: "weight", 2: "bias"},
    "MatMul": {1: "weight"},
    "BatchNormalization": {1: "weight", 2: "bias", 3: "running_mean",
                           4: "running_var"},
}


def _is_mangled(name: str) -> bool:
    """True for exporter-generated names that no longer look like state_dict
    keys ('onnx::Conv_347', '/head/conv/Conv_output_0', bare numbers)."""
    if name.startswith("onnx::") or name.startswith("/"):
        return True
    return "." not in name and name not in ("weight", "bias")


def _qual_from_node_name(name: str) -> "str | None":
    """The torch module path of a TorchScript-exporter node name: one
    component a scope level, a Sequential's scope repeating its parent's
    qualified form: '/Backbone/encoder/encoder.0/encoder.0.0/Conv' ->
    'Backbone.encoder.0.0'. None for a name without scopes."""
    if not name or not name.startswith("/"):
        return None
    comps = [c for c in name.split("/") if c]
    if not comps:
        return None
    comps = comps[:-1]  # the last component is the op label ('Conv', 'Gemm_3')
    qual = ""
    prev = ""
    for c in comps:
        if prev and c.startswith(prev + "."):
            # nested Sequential scope: 'encoder' -> 'encoder.0' replaces it
            qual = qual[: len(qual) - len(prev)] + c
        else:
            qual = f"{qual}.{c}" if qual else c
        prev = c
    return qual


def recover_mangled_names(model, sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename constant-folded initializers back to state_dict keys: the Conv
    nodes keep their module-scope names, so walking the weighted ops in
    graph order gives each mangled parameter its key: node
    '/Backbone/encoder/encoder.0/encoder.0.0/Conv' input 1 'onnx::Conv_347'
    -> 'Backbone.encoder.0.0.weight'."""
    out = dict(sd)
    for node in model.graph.nodes:
        leaves = _WEIGHTED_OPS.get(node.op_type)
        if leaves is None:
            continue
        qual = _qual_from_node_name(node.name)
        if qual is None:
            continue
        for idx, leaf in leaves.items():
            if idx >= len(node.inputs):
                continue
            iname = node.inputs[idx]
            if iname not in out or not _is_mangled(iname):
                continue
            key = f"{qual}.{leaf}" if qual else leaf
            if key in out:
                continue
            v = out.pop(iname)
            if leaf == "weight":
                if node.op_type == "MatMul" and v.ndim == 2:
                    v = v.T  # MatMul B is (in, out); state_dict is (out, in)
                elif (node.op_type == "Gemm" and v.ndim == 2
                      and not node.attr("transB", 0)):
                    v = v.T  # pre-transposed Gemm B
            out[key] = v
    return out


def _strip_wrapper_prefix(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torch.onnx.export on a wrapped module can prefix every initializer
    with the wrapper attribute (e.g. 'model.'); strip a uniform prefix."""
    keys = [k for k in sd if "." in k]
    if not keys:
        return dict(sd)
    first = keys[0].split(".", 1)[0]
    if all(k.split(".", 1)[0] == first for k in keys) and len(keys) > 1:
        # only a wrapper: the rest of every key is still a module path
        if all("." in k.split(".", 1)[1] for k in keys):
            return {k.split(".", 1)[1] if "." in k else k: v for k, v in sd.items()}
    return dict(sd)


def _drop_constants(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop exporter-made constants (Resize scales, Reshape shapes): integer
    values, and 'onnx::'/'/'-mangled or dotless names."""
    out = {}
    for k, v in sd.items():
        if k.startswith("onnx::") or k.startswith("/") or "." not in k:
            continue
        if v.dtype.kind in "iub" and not k.endswith(
                ("running_mean", "running_var", "num_batches_tracked")):
            continue
        out[k] = v
    return out


def _bn_module(targets: Mapping[str, torch.Tensor], mod: str) -> bool:
    return f"{mod}.running_mean" in targets or f"{mod}.running_var" in targets


def fold_missing_bn(targets: Mapping[str, torch.Tensor],
                    imported: Mapping[str, torch.Tensor],
                    eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Every BatchNorm value that the import left untouched (still the
    target's own tensor: the file had none, BN was folded) set to the
    identity: running_mean 0, running_var 1 - eps, weight 1 and bias 0,
    so the module computes the folded graph's function."""
    out = dict(imported)
    for key, v in imported.items():
        if v is not targets.get(key):
            continue
        mod, _, leaf = key.rpartition(".")
        if leaf == "running_mean":
            out[key] = torch.zeros_like(v)
        elif leaf == "running_var":
            out[key] = torch.full_like(v, 1.0 - eps)
        elif leaf in ("weight", "bias") and _bn_module(targets, mod):
            out[key] = torch.ones_like(v) if leaf == "weight" else torch.zeros_like(v)
    return out


def _route_folded_biases(targets: Mapping[str, torch.Tensor],
                         imported: Mapping[str, torch.Tensor],
                         sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A fused bias of a conv that has no bias goes to the BatchNorm after
    it (torch Sequential convention: the BN's index is the conv's + 1),
    whose identity fill then makes BN(x) = x + bias."""
    out = dict(imported)
    for k, v in sd.items():
        if not k.endswith(".bias"):
            continue
        mod = k[: -len(".bias")]
        if f"{mod}.bias" in targets:
            continue  # the named path already placed it
        parts = mod.split(".")
        if not parts[-1].isdigit():
            continue
        sib = ".".join(parts[:-1] + [str(int(parts[-1]) + 1)])
        for tgt in (f"{sib}.bias", f"{sib}.bn.bias"):
            if tgt in targets and tuple(targets[tgt].shape) == np.asarray(v).shape:
                out[tgt] = as_tensor(v).to(dtype=targets[tgt].dtype)
                break
    return out


def _unmatched_core_leaves(targets: Mapping[str, torch.Tensor],
                           imported: Mapping[str, torch.Tensor]) -> list:
    """The weights and biases outside BatchNorm that the import left
    untouched."""
    out = []
    for key, v in targets.items():
        mod, _, leaf = key.rpartition(".")
        if leaf in ("weight", "bias") and not _bn_module(targets, mod) \
                and imported.get(key) is v:
            out.append(key)
    return out


def import_onnx(module: Targets, path, prefix_map: Mapping[str, str] | None = None,
                strict: bool = True) -> Dict[str, torch.Tensor]:
    """Fill ``module`` (a module or its state_dict) from an ONNX file -> a
    full state_dict for it (load it with ``module.load_state_dict``).

    Tries the named path strictly; if initializers are missing (a
    constant-folded export), imports what matches, routes folded conv
    biases into the BatchNorm after them and fills identity BatchNorm;
    with ``strict`` it then raises if a weight or bias outside BatchNorm
    is still unmatched. The initializer names are tried as they are first,
    then with a uniform root component stripped (torch.onnx.export of a
    wrapped module), never the other way round. With ``strict=False`` the
    first candidate always returns, so the stripped one is never tried:
    the JAX importer does the same (onnx_import.py:280)."""
    targets = targets_of(module)
    sd_raw = _drop_constants(load_onnx_state_dict(path, recover=True))
    candidates = [sd_raw]
    stripped = _strip_wrapper_prefix(sd_raw)
    if set(stripped) != set(sd_raw):
        candidates.append(stripped)

    def attempt(sd):
        try:
            return import_state_dict(targets, sd, prefix_map=prefix_map, strict=strict)
        except KeyError as e:
            if "missing torch weights" not in str(e):
                raise
            imported = import_state_dict(targets, sd, prefix_map=prefix_map, strict=False)
            imported = _route_folded_biases(targets, imported, sd)
            imported = fold_missing_bn(targets, imported)
            missing_core = _unmatched_core_leaves(targets, imported)
            if strict and missing_core:
                raise KeyError(
                    f"ONNX import could not match core weights: {missing_core[:10]}"
                    f"{' ...' if len(missing_core) > 10 else ''}") from e
            return imported

    last_err = None
    for sd in candidates:
        try:
            return attempt(sd)
        except (KeyError, ValueError) as e:
            last_err = e
    raise last_err


# The export direction: a parameter set as a real .onnx artifact (the
# interchange format the reference's C++ runtime consumes), with named
# initializers as torch.onnx.export(export_params=True,
# do_constant_folding=False) writes them and the reference exporter's graph
# I/O (input 'input' [batch, 3, H, W] -> named outputs,
# convert_pytorch_to_onnx.py:144-155).

REFERENCE_IO = {
    # model name -> (input names/shapes, output names/shapes); 'batch_size'
    # is the symbolic batch dim the reference exporter declares.
    "SceneSeg": ((("input", ("batch_size", 3, 320, 640)),),
                 (("output", ("batch_size", 3, 320, 640)),)),
    "Scene3D": ((("input", ("batch_size", 3, 320, 640)),),
                (("output", ("batch_size", 1, 320, 640)),)),
    "DomainSeg": ((("input", ("batch_size", 3, 320, 640)),),
                  (("output", ("batch_size", 1, 320, 640)),)),
    "EgoLanes": ((("input", ("batch_size", 3, 320, 640)),),
                 (("output", ("batch_size", 3, 80, 160)),)),
}


def save_state_dict_as_onnx(state_dict: Mapping[str, object], path,
                            model_name: str = "SceneSeg",
                            io: Tuple | None = None,
                            producer: str = "autoware_vision_pilot_tpu_torch") -> None:
    """Write a torch-layout state_dict (numpy arrays or tensors) as an ONNX
    model file: the values as graph initializers under their names, the
    graph I/O of the reference exporter, and one Identity node from the
    input to the output (the onnx checker wants every output made by a
    node; the file carries weights, not a runnable graph)."""
    ins, outs = io if io is not None else REFERENCE_IO.get(
        model_name, ((("input", ("batch_size", 3, 320, 640)),),
                     (("output", ("batch_size", 3, 320, 640)),)))
    g = onnx_proto.Graph(name=f"{model_name}_graph")
    for k, v in state_dict.items():
        t = as_tensor(v)
        t = t.float() if t.dtype == torch.bfloat16 else t  # ONNX has no bf16 here
        g.initializers[k] = onnx_proto.Tensor.from_numpy(k, t.numpy())
    for name, shape in ins:
        g.inputs.append(onnx_proto.ValueInfo(name=name, shape=list(shape)))
    for name, shape in outs:
        g.outputs.append(onnx_proto.ValueInfo(name=name, shape=list(shape)))
    g.nodes.append(onnx_proto.Node(
        op_type="Identity", name="weights_carrier",
        inputs=[ins[0][0]], outputs=[outs[0][0]]))
    m = onnx_proto.Model(producer_name=producer, producer_version="1.0", graph=g)
    onnx_proto.save_model(m, path)
