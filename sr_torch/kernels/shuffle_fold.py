"""Fold a conv through a preceding pixel shuffle (phase decomposition).

Port of ``sr/kernels/shuffle_fold.py``. It rewrites

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
* :func:`make_folded_tail_predict`: the forward of a model with a
  pixel-shuffle tail (EDSR's act-free stages, SRResNet's and SRGAN's PReLU
  stages) with the output conv folded through the last shuffle; its
  shuffles run the shuffle kernel. The activations between the shuffle
  and the conv commute with the shuffle (one shared PReLU slope), so the
  last stage's PReLU runs before it.
* :func:`make_folded_tail_predict_quant`: the same composite with every
  conv int8 (``sr_torch/quant.py``): the body's sites, the stage convs and
  the folded output conv through ``conv_int8_fused``, the int8 kernel on
  the card; the folded conv's 5×5 over C·r² channels (SRResNet's 9×9
  folded through r = 2) is SAME like every int8 site.
* :func:`d2s_conv`: ``conv2d(depth_to_space(x, r), W)`` in pre-shuffle
  layout.

Kernels are flax's HWIO, as in the JAX package. No Pallas kernel lives
here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.utils.profiling import span


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


def _tail_parts(model):
    """``(stages, r_last, out_conv, out_conv_site)`` of a model with a
    pixel-shuffle tail: its PSBlocks and its output conv, bare (SRResNet)
    or wrapped in a ConvBlock (EDSR)."""
    stages = list(getattr(model, "upsample", ()))
    if not stages:
        raise ValueError("model has no pixel-shuffle stages to fold")
    oc, site = model.out_conv, "out_conv"
    if not isinstance(oc, torch.nn.Conv2d):  # EDSR's ConvBlock
        oc, site = oc.Conv_0, "out_conv/Conv_0"
    return stages, stages[-1].scale_factor, oc, site


def _folded_out_conv(oc: torch.nn.Conv2d, r: int):
    """The output conv folded through a ×r shuffle: (HWIO kernel, bias,
    (pad_lo, pad_hi)), numpy float32."""
    with torch.no_grad():
        wf, dmin = fold_shuffle_conv_kernel(
            oc.weight.permute(2, 3, 1, 0).float().cpu().numpy(), r)
        bf = fold_bias(oc.bias.float().cpu().numpy(), r)
    return wf, bf, (-dmin, wf.shape[0] - 1 + dmin)


def make_folded_tail_predict(model):
    """The model's eval forward with the output conv folded through the
    last pixel shuffle: ``fn(x_nhwc) -> sr_nhwc``, without grad, in the
    model's own mode (:func:`sr_torch.infer.make_serving_predict` puts it
    in eval mode, batch norms on their running statistics).

    Exactly the exact graph's function, borders included: the fold is
    exact, and the last stage's activation, none (EDSR) or one shared
    PReLU slope (SRResNet, SRGAN), commutes with the shuffle, so it runs
    before it. The body and the stages read the model's live weights; the
    folded output conv is built from the weights at this call, so build
    the function again after training. Every shuffle runs through
    :func:`depth_to_space` (the kernel on the card), the last one with the
    folded conv's bias.
    """
    stages, r_last, oc, _ = _tail_parts(model)
    wf, bf, pad = _folded_out_conv(oc, r_last)
    wf_t = torch.from_numpy(wf).to(oc.weight.device, model.dtype)
    bf_t = torch.from_numpy(bf).to(oc.weight.device, model.dtype)

    @torch.no_grad()
    def predict(x: torch.Tensor) -> torch.Tensor:
        h = model.body(x).permute(0, 3, 1, 2)
        for up in stages[:-1]:
            h = up(h)
        # the last stage stays before its shuffle; the output conv is
        # folded through it
        a = stages[-1].preshuffle(h).permute(0, 2, 3, 1)
        z = conv_nhwc(a, wf_t, None, pad).contiguous()
        return depth_to_space(z, r_last, None, bf_t)

    return predict


def make_folded_tail_predict_quant(model, calib_headroom: float = 1.0,
                                   output_u8: bool = False,
                                   calib_batches=None):
    """The folded tail with every conv int8
    (``sr/kernels/shuffle_fold.py:make_folded_tail_predict_quant``): the
    fast int8 serving composite for PReLU-stage tails (SRResNet, SRGAN),
    whose activations rule out the affine collapse of
    ``sr_torch/kernels/fused_tail.py``. ``fn(x_nhwc) -> sr_nhwc`` (uint8
    with ``output_u8``), in the model's own mode, as
    :func:`make_folded_tail_predict`.

    The body's convs run through their static int8 sites
    (``quantized_apply(method="body")``), the stage convs through theirs,
    and the folded output conv through one more, all ``conv_int8_fused``.
    Scales are calibrated once, lazily on the first batch (or on
    ``calib_batches``; ``predict.calibrate(batches)`` eagerly), behind a
    lock, by one float forward of the exact graph. The folded conv's input
    is the pre-shuffle activation, a permutation of the out conv's input,
    so the out-conv site's scale carries over: a per-channel scale of
    post-shuffle channel c bounds its whole phase group c·r² … c·r² + r² −
    1 and is repeated r² times; folded into the weights with the rest
    (``prep`` in the JAX package). With ``output_u8`` the uint8 rounding
    runs before the last shuffle, which then moves uint8.
    """
    from sr_torch.quant import (
        SITE_SPAN, _Int8Site, _sites, calibrate_scales_batches,
        calibrated_once, int8_sites, to_u8)

    stages, r_last, oc, oc_site = _tail_parts(model)
    wf, bf, pad = _folded_out_conv(oc, r_last)
    if pad != (wf.shape[0] // 2,) * 2:
        raise ValueError(f"the folded output conv pads {pad}; the int8 conv "
                         "takes SAME padding")
    dev = oc.weight.device
    wf_t, bf_t = torch.from_numpy(wf).to(dev), torch.from_numpy(bf).to(dev)

    def build(batches):
        scales = calibrate_scales_batches(model, batches,
                                          headroom=calib_headroom)
        sites = _sites(model, scales)
        s_oc = scales.get(oc_site)
        if s_oc is not None and np.ndim(s_oc) == 1:
            s_oc = np.repeat(np.asarray(s_oc, np.float32), r_last * r_last)
        folded = _Int8Site(wf_t, bf_t, s_oc)

        def fn(x):
            with torch.inference_mode(), int8_sites(sites):
                h = model.body(x).permute(0, 3, 1, 2)
                for up in stages[:-1]:
                    h = up(h)
                # the last stage stays before its shuffle (its PReLU
                # commutes with it); the output conv is folded through it
                a = stages[-1].preshuffle(h).permute(0, 2, 3, 1)
            with span(SITE_SPAN):
                z = folded.nhwc(a.to(torch.float32).contiguous())
            # to_u8 is elementwise and the shuffle a permutation: round
            # before it, so the shuffle moves uint8
            return depth_to_space(to_u8(z) if output_u8 else z, r_last)

        return fn

    predict = calibrated_once(build)
    if calib_batches is not None:
        predict.calibrate(calib_batches)
    return predict


def d2s_conv(x: torch.Tensor, kernel, r: int, bias=None,
             padding: int | None = None) -> torch.Tensor:
    """``conv2d(depth_to_space(x, r), kernel) [+ bias]`` computed before the
    shuffle (``sr/kernels/shuffle_fold.py:d2s_conv``). Exact, borders
    included: zero-padding pre-shuffle pixels is zero-padding post-shuffle
    pixels under the shuffle.

    ``x``: NHWC (B, H, W, C·r²); ``kernel``: HWIO (k, k, C, N), numpy or a
    tensor, with torch's k//2 padding by default. Returns (B, H·r, W·r,
    N); the shuffle runs the kernel on the card.
    """
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().cpu().numpy()
    wf, dmin = fold_shuffle_conv_kernel(kernel, r, padding)
    pad = (-dmin, wf.shape[0] - 1 + dmin)
    z = conv_nhwc(x, torch.from_numpy(wf).to(x.device, x.dtype), None, pad)
    if bias is not None:
        if isinstance(bias, torch.Tensor):
            bias = bias.detach().cpu().numpy()
        z = z + torch.from_numpy(fold_bias(bias, r)).to(x.device, z.dtype)
    return depth_to_space(z.contiguous(), r)
