"""k×k SAME stride-1 int8 conv: plain versions + CUDA kernel.

Port of ``sr/kernels/int8_conv.py``. NHWC activations, HWIO ``(k, k, C, N)``
weights, odd ``k`` up to 17 where a chunk of the weights fits in shared
memory (:func:`conv_fits`; every conv of the port does; the TPU kernel was
the ``k=3`` case, the fused-quant tail's composite conv is 7×7):

* :func:`conv_int8_im2col`: int8 × int8 → int32, the exact accumulator that
  ``sr/quant.py:int8_conv`` dequantizes — the TPU kernel's function;
* :func:`conv_bf16_im2col`: bf16 × bf16 → float32, the same kernel's bf16
  instantiation (``conv3x3_bf16_im2col``);
* :func:`conv_int8_fused`: float32 in, float32 out — the quantize before
  the conv and the dequantize and bias after it (``sr/quant.py:int8_conv``)
  run inside the kernel, with the same roundings in the same order. The int8
  serving path calls this entry.

Each entry calls its operator (``sr_torch::conv_int8_im2col``,
``conv_bf16_im2col``, ``conv_int8_fused``; ``sr_torch/kernels/ops.py``),
whose implementation the tensor's device picks: CPU tensors go through the
plain versions; CUDA tensors launch the hand-written implicit GEMM in
``csrc/int8_conv.cu`` or raise. Nothing falls back from the kernel to the
plain version. The kernel takes its weights packed by :func:`pack_weights`
in the layout it keeps resident (:func:`conv_layout`: per tap, or with a
whole tap row in K for few channels, :func:`conv_class`): the raw entries
pack them per call, and the fused entry takes the packing from its caller,
who packs once (``packed=``). :func:`conv_plan` reports the plan the kernel
takes for a shape (on the card).
"""

from sr_torch.kernels.ops import (  # noqa: F401 — the module's interface
    conv_bf16_im2col, conv_bf16_plain, conv_class, conv_fits,
    conv_int8_fused, conv_int8_fused_plain, conv_int8_im2col, conv_int8_plain,
    conv_layout, conv_plan)
from sr_torch.kernels.ops import pack_conv_weights as pack_weights  # noqa: F401
