"""Float32 precision switches for reference computations on the card.

On CUDA, PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32``), which keeps about three decimal
digits. Reference arithmetic (the kernels' plain versions, the affine-tail
impulse probe) needs full float32, so it runs inside :func:`no_tf32`.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Turn TF32 off for cuDNN and matmul; restore the old values on exit.

    The switches are process-wide, so a caller that serves other threads
    at the same time holds them off for those threads too.
    """
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
