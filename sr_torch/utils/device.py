"""The device an entry point runs on."""

from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


@contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside, as it was after.
    The training entry points run under it (also as a decorator), so a run
    resumed from a checkpoint ends with the uninterrupted run's weights bit
    for bit on the card, as XLA's are on the TPU; the default algorithms
    may accumulate a weight gradient in another order from run to run."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before
