"""Serving-output quantization (``sr/quant.py:to_u8``).

The int8 static and dynamic modes of ``sr/quant.py``, with the int8 conv
kernel under them, land in the next port slice.
"""

from __future__ import annotations

import torch


def to_u8(y: torch.Tensor) -> torch.Tensor:
    """[0,1]-float → uint8 image, bit-equal to the host-side
    ``np.clip(np.round(sr*255), 0, 255).astype(uint8)``: the same float32
    math and the same half-to-even rounding (``torch.round`` like
    ``jnp.round``). Quantizing on the device quarters the bytes copied to
    the host against float32."""
    return torch.clamp(torch.round(y.to(torch.float32) * 255.0),
                       0, 255).to(torch.uint8)
