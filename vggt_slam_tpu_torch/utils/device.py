"""Device selection for the port's entry points: the card by default, the
CPU only when asked for."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The requested device; a CUDA request without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to run on the CPU")
    return device
