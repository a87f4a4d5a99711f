"""Float32 precision switches for reference computations on the card.

On CUDA, PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32``), which keeps about three decimal
digits. Reference arithmetic (the kernels' plain versions, the affine-tail
impulse probe) needs full float32, so it runs inside :func:`no_tf32`, which
lives with the kernels' plain versions in ``sr_torch/kernels/ops.py``.
"""

from sr_torch.kernels.ops import no_tf32  # noqa: F401 — the interface
