"""Fold a conv through a preceding pixel shuffle (phase decomposition).

Port of the float half of ``sr/kernels/shuffle_fold.py``. It rewrites

    conv2d(depth_to_space(x, r), W)  =  depth_to_space(conv2d(x, W_f), r)

exactly, borders included: the folded conv runs before the shuffle, at r²×
fewer pixels and r²× the channels. With output phase (α, β), post-conv tap
(dy, dx) and the post-conv's padding p,

    ay = α + dy - p  →  δy = floor(ay / r) (pre-pixel offset),
                         iy = ay mod r    (phase row inside that pre-pixel)

    out_pre[y, x, n·r² + α·r + β] = Σ W[dy,dx,c,n] · x[y+δy, x+δx, c·r² + iy·r + ix]

so W_f has spatial taps δ ∈ [floor(-p/r), floor((r-1+k-1-p)/r)] and the
channel map (c, iy, ix) → c·r² + iy·r + ix of the shuffle.

* :func:`fold_shuffle_conv_kernel` and :func:`fold_bias`: numpy, for
  weights that are fixed (serving).
* :func:`fold_shuffle_conv_kernel_torch`: the same kernel built from a
  torch tensor with slices, a stack, a permute and a reshape, so it sits
  under autograd and the gradients land in the unfolded weights (the
  pre-shuffle training losses of ``sr_torch/models/edsr.py``).
* :func:`make_folded_tail_predict`: EDSR's forward with the output conv
  folded through the last shuffle; its shuffles run the shuffle kernel.

Kernels are flax's HWIO, as in the JAX package. The int8 folded tail and
``d2s_conv`` come with SRResNet. No Pallas kernel lives here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sr_torch.kernels.depth_to_space import depth_to_space


def _fold_geometry(k: int, r: int, padding: int | None) -> tuple[int, int, int]:
    p = k // 2 if padding is None else padding
    dmin = (0 - p) // r  # floor division, negatives included
    dmax = (r - 1 + k - 1 - p) // r
    return p, dmin, dmax - dmin + 1


def fold_shuffle_conv_kernel(kernel, r: int, padding: int | None = None):
    """(k,k,C,N) post-shuffle conv kernel → (T,T,C·r²,N·r²) pre-shuffle.

    ``padding``: the post-conv's symmetric padding (default k//2, torch's
    ``Conv2d(padding=k//2)``). Returns ``(folded_kernel, delta_min)``; the
    folded conv needs zero padding of ``-delta_min`` before and
    ``T-1+delta_min`` after each spatial dim.
    """
    kernel = np.asarray(kernel)
    k, k2, c, n = kernel.shape
    if k != k2:
        raise ValueError("square kernels only")
    p, dmin, t = _fold_geometry(k, r, padding)
    wf = np.zeros((t, t, c * r * r, n * r * r), kernel.dtype)
    for alpha in range(r):
        for dy in range(k):
            ay = alpha + dy - p
            delta_y, iy = ay // r, ay % r
            for beta in range(r):
                for dx in range(k):
                    ax = beta + dx - p
                    delta_x, ix = ax // r, ax % r
                    wf[
                        delta_y - dmin,
                        delta_x - dmin,
                        iy * r + ix :: r * r,  # c·r² + iy·r + ix over c
                        alpha * r + beta :: r * r,  # n·r² + α·r + β over n
                    ] += kernel[dy, dx]
    return wf, dmin


def fold_bias(bias, r: int):
    """(N,) post-conv bias → (N·r²,) folded-conv bias (replicated)."""
    return np.repeat(np.asarray(bias), r * r)


def fold_shuffle_conv_kernel_torch(kernel: torch.Tensor, r: int,
                                   padding: int | None = None):
    """Differentiable twin of :func:`fold_shuffle_conv_kernel` on a torch
    (k,k,C,N) kernel; returns ``(folded_kernel, delta_min)``.

    For a fixed output phase α the (Δ, i) taps of the fold are one
    contiguous window of the zero-padded kernel, dy = r·Δ + i + (p − α +
    r·dmin), so the folded kernel is r slices per spatial axis, stacked,
    and one permute and reshape: its backward is slice gradients, and
    every folded tap reads exactly one original tap or a zero.
    """
    k, k2, c, n = kernel.shape
    if k != k2:
        raise ValueError("square kernels only")
    p, dmin, t = _fold_geometry(k, r, padding)
    # per-phase window offsets into the dy axis; pad so every window
    # [off, off + r·t) is in range, with out-of-kernel taps zero
    offs = [p - a + r * dmin for a in range(r)]
    pb = max(0, -min(offs))
    pa = max(0, max(offs) + r * t - 1 - (k - 1))
    kp = F.pad(kernel, (0, 0, 0, 0, pb, pa, pb, pa))
    ky = kp.shape[0]
    # y axis: stack the r windows → (α, Δy, iy, dx_padded, c, n)
    w = torch.stack([kp[o + pb:o + pb + r * t] for o in offs])
    w = w.reshape(r, t, r, ky, c, n)
    # x axis likewise → (β, α, Δy, iy, Δx, ix, c, n)
    w = torch.stack([w[:, :, :, o + pb:o + pb + r * t] for o in offs])
    w = w.reshape(r, r, t, r, t, r, c, n)
    # → (Δy, Δx, c, iy, ix, n, α, β): in-channel c·r²+iy·r+ix, out-channel
    # n·r²+α·r+β (the shuffle's order)
    w = w.permute(2, 4, 6, 3, 5, 7, 1, 0)
    return w.reshape(t, t, c * r * r, n * r * r), dmin


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor | None, padding: tuple[int, int]
              ) -> torch.Tensor:
    """2-D conv of an NHWC tensor with an HWIO kernel and (lo, hi) zero
    padding on both spatial dims; NHWC out, in x's dtype."""
    lo, hi = padding
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC memory
    if lo != hi:
        xc, lo = F.pad(xc, (lo, hi, lo, hi)), 0
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), bias, padding=lo)
    return y.permute(0, 2, 3, 1)


def make_folded_tail_predict(model):
    """EDSR's eval forward with the output conv folded through the last
    pixel shuffle: ``fn(x_nhwc) -> sr_nhwc``, without grad.

    Exactly the exact graph's function, borders included (the fold is
    exact; EDSR's PS stages are activation-free). The body and the stages
    read the model's live weights; the folded output conv is built from
    the weights at this call, so build the function again after training.
    Every shuffle runs through :func:`depth_to_space` (the kernel on the
    card), the last one with the folded conv's bias.
    """
    stages = list(model.upsample)
    r_last = stages[-1].scale_factor
    oc = model.out_conv.Conv_0
    with torch.no_grad():
        wf, dmin = fold_shuffle_conv_kernel(
            oc.weight.permute(2, 3, 1, 0).cpu().numpy(), r_last)
        bf = fold_bias(oc.bias.cpu().numpy(), r_last)
    wf_t = torch.from_numpy(wf).to(oc.weight.device, model.dtype)
    bf_t = torch.from_numpy(bf).to(oc.weight.device, model.dtype)
    pad = (-dmin, wf.shape[0] - 1 + dmin)

    @torch.no_grad()
    def predict(x: torch.Tensor) -> torch.Tensor:
        h = model.body(x).permute(0, 3, 1, 2)
        for up in stages[:-1]:
            h = up(h)
        # the last stage stays before its shuffle; the output conv is
        # folded through it
        a = stages[-1](h, shuffle=False).permute(0, 2, 3, 1)
        z = conv_nhwc(a, wf_t, None, pad).contiguous()
        return depth_to_space(z, r_last, None, bf_t)

    return predict
