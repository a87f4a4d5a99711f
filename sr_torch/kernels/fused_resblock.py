"""Fused EDSR residual block: plain PyTorch version + CUDA kernel.

Port of ``sr/kernels/fused_resblock.py``. One call computes an
inference-mode EDSR body block on NHWC activations,

    x + res_scale * (conv2(relu(conv1(x) + b1)) + b2)

with 3×3 SAME convs, float32 accumulation, float32 biases added before the
cast, and the intermediate cast to x's dtype — the TPU kernel's arithmetic.
Weights are packed as (9·C, C) matmul operands whose row ``(a*3 + b)*C + ci``
holds tap (a, b) of input channel ci, the order of the TPU kernel's im2col.

:func:`fused_resblock` calls the operator ``sr_torch::fused_resblock``
(``sr_torch/kernels/ops.py``), whose implementation the tensor's device
picks: a CPU tensor goes through :func:`fused_resblock_plain`; a CUDA
tensor launches the hand-written kernel in ``csrc/fused_resblock.cu`` or
raises. bf16 runs one launch per block with ``wgmma`` products and takes
its weights in the layout :func:`pack_wgmma_weights` makes (callers pack
once), on the CPU too, which unpacks them; float32 runs two launches on
the CUDA cores with a scratch intermediate and takes the (9·C, C)
operands, as the plain version does. Inference only: the TPU kernel has no
VJP either. The TPU kernel's ``row_tile`` was a VMEM tiling knob and is
gone; any H and W work.
"""

from __future__ import annotations

import torch

from sr_torch.kernels import _build
from sr_torch.kernels.ops import (  # noqa: F401 — the module's interface
    WGMMA_DIM, fused_resblock, fused_resblock_plain, resblock_lib,
    swizzle_k_major, unpack_wgmma_weights)


def pack_weights(weight1, bias1, weight2, bias2):
    """Torch OIHW (C, C, 3, 3) conv weights → ((9·C, C) operands, f32 biases).

    ``w.permute(2, 3, 1, 0)`` is the flax HWIO kernel, so the reshape gives
    the TPU kernel's ``pack_weights`` layout. The operands keep the weights'
    dtype; the caller casts them to the activation dtype.
    """
    c = weight1.shape[0]

    def pack(w):
        return w.permute(2, 3, 1, 0).reshape(9 * c, c).contiguous()

    return (pack(weight1), bias1.to(torch.float32).contiguous(),
            pack(weight2), bias2.to(torch.float32).contiguous())


def pack_wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """A (9·C, C) bf16 operand → the bf16 kernel's (9, 64, 64) layout: per
    tap a K-major matrix (row n = output channel, its C input channels),
    zero-padded to 64 × 64 and swizzled for ``wgmma``
    (:func:`unpack_wgmma_weights` inverts it)."""
    c = w.shape[1]
    out = w.new_zeros((9, WGMMA_DIM, WGMMA_DIM))
    out[:, :c, :c] = w.reshape(9, c, c).transpose(1, 2)
    return swizzle_k_major(out)


def wgmma_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(64, 64) bf16 @ (64, 64) bf16 → float32 through the resblock
    kernel's ``ldmatrix`` / descriptor / ``wgmma`` helpers: one product, to
    hold them against a plain matmul on the card. CUDA tensors only."""
    if a.device.type != "cuda":
        raise ValueError(f"wgmma_matmul runs on cuda, not {a.device}")
    shape = (WGMMA_DIM, WGMMA_DIM)
    if (a.shape != shape or b.shape != shape or a.dtype != torch.bfloat16
            or b.dtype != torch.bfloat16 or b.device != a.device):
        raise ValueError("wgmma_matmul takes two (64, 64) bf16 tensors on "
                         "one card")
    a = a.contiguous()
    packed = swizzle_k_major(b.t())  # row n holds column n of b
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    lib, _ = resblock_lib()
    with torch.cuda.device(a.device):
        err = lib.sr_wgmma_matmul(a.data_ptr(), packed.data_ptr(),
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "wgmma_matmul")
    return out
