"""Pixel shuffle (depth_to_space): plain PyTorch version + CUDA kernel.

Port of ``sr/kernels/depth_to_space.py``. NHWC layout, the sub-pixel
upsampling of EDSR's ``PSBlock``s and of the fused affine tail, with the
preceding conv's bias and an optional ReLU fused in:

    out[b, h*r + i, w*r + j, c] = act(x[b, h, w, k] + bias[k]),
    k = c*r*r + i*r + j

:func:`depth_to_space` calls the operator ``sr_torch::depth_to_space``
(``sr_torch/kernels/ops.py``), whose implementation the tensor's device
picks: a CPU tensor goes through :func:`depth_to_space_plain`; a CUDA
tensor launches the hand-written kernel in ``csrc/depth_to_space.cu``
(float32, bfloat16, or uint8 for the fused-quant tail's u8 output) or
raises. Nothing falls back from the kernel to the plain version.

Training differentiates through the shuffle: the operator's backward is
the ReLU mask, then :func:`space_to_depth` of the gradient for x, and its
sum over B·H·W for the bias — how XLA transposes the JAX shuffle, which has
no backward kernel (``sr/kernels/depth_to_space.py`` defines no VJP). So
the backward is the plain reshape-permute on either device. Without grad
the call is the bare forward: no saved tensors, no extra copy.
"""

from sr_torch.kernels.ops import (  # noqa: F401 — the module's interface
    depth_to_space, depth_to_space_plain, space_to_depth)
