from .backend import InferenceBackend, TorchInferenceBackend, backend_from_params
