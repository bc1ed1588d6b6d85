"""PyTorch and CUDA port of autoware_vision_pilot_tpu for NVIDIA Hopper.

Each module sits at the relative path of the JAX module it ports and is
tested against it. Nothing here imports JAX.
"""
