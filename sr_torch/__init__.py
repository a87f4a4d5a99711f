"""sr_torch — the PyTorch/CUDA port of ``sr``, for one NVIDIA H100.

It mirrors ``sr/``'s layout and names, so each module's counterpart sits at
the same path. It imports torch, numpy and the standard library, never JAX
or ``sr``. Entry points run on ``device="cuda"`` unless the caller asks for
the CPU. Every Pallas kernel of ``sr`` on a ported path becomes a CUDA
kernel under ``sr_torch/kernels/csrc/``, built at first use; a CPU tensor
takes the kernel's plain PyTorch version instead.

Slices 1 and 2 serve EDSR ×4 in float and int8: ``sr_torch.infer.upscale``
(``quantize=...``) and ``python -m sr_torch.serve`` (``--quantize``).
"""
