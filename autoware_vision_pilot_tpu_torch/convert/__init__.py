"""Weight import for the port: flax variables (from_jax.py), a reference
PyTorch state_dict (torch_import.py) and a reference ONNX artifact
(onnx_import.py, over the pure-Python codec onnx_proto.py), each into the
port's modules."""
from .torch_import import import_state_dict
from .onnx_import import import_onnx, load_onnx_state_dict, save_state_dict_as_onnx
