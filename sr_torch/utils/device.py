"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device
