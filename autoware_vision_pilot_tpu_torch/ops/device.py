"""Constant tables copied to the card without a host synchronisation."""
from __future__ import annotations

import torch


def constant_on(t: torch.Tensor, device) -> torch.Tensor:
    """``t``, a CPU tensor, on ``device``. To a CUDA device it is copied from
    pinned memory with ``non_blocking=True``: a copy from pageable memory
    waits for the stream (and raises under
    ``torch.cuda.set_sync_debug_mode("error")``), this one does not, and
    PyTorch keeps the pinned buffer until the copy has run. For tables that
    a caller makes once per device and keeps."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
