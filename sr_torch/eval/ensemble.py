"""Geometric self-ensemble (the EDSR paper's "+" eval mode).

Port of ``sr/eval/ensemble.py``. Averages the model's predictions over the
8 elements of the dihedral group D4 (4 rotations × an optional flip): each
variant of the input is forwarded, the output is mapped back through the
inverse transform, and the 8 aligned outputs are averaged in float32. Lim
et al. (CVPRW'17) report about +0.1–0.3 dB from this at test time, with no
retraining; the cost is 8 forwards.

* The transforms are layout ops (``torch.flip`` / ``torch.rot90``), made
  contiguous: the models treat ``x.permute(0, 3, 1, 2)`` of an NHWC
  tensor as a channels-last view, and the CUDA kernels take contiguous
  tensors only.
* The wrapper composes below halo tiling (``sr_torch/eval/tiling.py``): a
  rotated conv net is a conv net with the same receptive field, so
  ``tiled_predict(ensemble(fn), ...)`` stays exact.
* Every transform maps the pixel grid onto itself and SR scales both axes
  by the same integer r, so ``inverse(model(t(x)))`` aligns bit for bit
  with ``model(x)``'s grid for any r (pre-upsample models run at r = 1).
"""

from __future__ import annotations

import torch

# (flip, k): flip along W first, then rotate k·90° in the (H, W) plane.
TRANSFORMS: tuple[tuple[bool, int], ...] = tuple(
    (flip, k) for flip in (False, True) for k in range(4)
)


def transform(x: torch.Tensor, flip: bool, k: int) -> torch.Tensor:
    """Apply one D4 element to an NHWC batch; contiguous."""
    if flip:
        x = torch.flip(x, dims=(2,))
    return torch.rot90(x, k=k, dims=(1, 2)).contiguous()


def inverse(y: torch.Tensor, flip: bool, k: int) -> torch.Tensor:
    """Invert :func:`transform` on an NHWC batch."""
    y = torch.rot90(y, k=-k, dims=(1, 2))
    if flip:
        y = torch.flip(y, dims=(2,))
    return y


def make_self_ensemble_predict(fn, output_u8: bool = False,
                               fuse: bool = False):
    """Wrap ``fn(x)`` (NHWC batch → NHWC batch) as its D4 self-ensemble.

    ``fn`` may emit float [0, 1] or uint8 (``sr_torch.quant.to_u8``
    programs): u8 members are de-quantized by ``/255``, the members are
    summed in float32 in :data:`TRANSFORMS` order and multiplied by 1/8,
    and ``output_u8`` picks the wrapper's own output encoding (``to_u8``,
    once). Prefer a base ``fn`` without u8 output: averaging already
    rounded members loses up to half a level per member.

    ``fuse``: PyTorch has no ``jit`` to select here; the wrapper always
    calls ``fn`` 8 times, and ``sr_torch.export`` traces all 8 members into
    one program. Kept for the JAX package's signature.
    """
    del fuse

    def forward_all(x: torch.Tensor) -> torch.Tensor:
        acc = None
        for flip, k in TRANSFORMS:
            y = fn(transform(x, flip, k))
            if y.dtype == torch.uint8:
                # a tensor divisor: with a Python number, CUDA multiplies
                # by 1/255, one ulp off the CPU's and JAX's division
                y = y.to(torch.float32)
                y = y / torch.full_like(y, 255.0)
            else:
                y = y.to(torch.float32)
            y = inverse(y, flip, k)
            acc = y if acc is None else acc + y
        out = acc * (1.0 / 8.0)
        if output_u8:
            from sr_torch.quant import to_u8

            return to_u8(out)
        return out

    return forward_all
