"""Collapse an affine upsampling tail into one conv + one pixel shuffle.

Port of ``sr/kernels/fused_tail.py``: the float path and the static-int8
path (:func:`make_fused_tail_predict_quant`). EDSR's tail —
[conv64→256, d2s₂, conv64→256, d2s₂, conv64→3] — has no activations, so it
is affine and translation-equivariant and factors as

    tail(y) = d2s_r( conv_SAME(y, K) + b )

with a small composite kernel K (S×S×C_in×C_out·r²), found numerically by
impulse probing. The composite equals the original wherever the receptive
field stays inside the image; a border band of ≤ S//2 · r output pixels
differs, because each stage's SAME padding injects zeros after the earlier
biases. Serving runs it through ``tiled_predict``'s halos or accepts the
band; parity evals keep the exact graph.

The probe runs in float32 with TF32 off for cuDNN and matmul: otherwise the
affineness checks trip on TF32 rounding. All C_in impulses go through the
tail as one batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sr_torch.kernels.depth_to_space import depth_to_space, space_to_depth
from sr_torch.kernels.int8_conv import conv_int8_fused, pack_weights
from sr_torch.nn.intercept import intercept_convs, site_keys
from sr_torch.quant import (
    _EPS, SITE_SPAN, _run_sites, _sites, calibrate_scales_batches,
    calibrated_once, to_u8)
from sr_torch.utils.precision import no_tf32
from sr_torch.utils.profiling import span


def extract_affine_conv(tail_fn, in_channels: int, scale_factor: int,
                        support: int = 7, tol: float = 1e-5
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Impulse-probe an affine ×r upsampler into (K, b).

    ``tail_fn``: (N, P, P, in_channels) float32 NHWC → (N, rP, rP, C_out),
    CPU tensors in and out; it may run the tail on another device.
    Returns ``K`` (S, S, in_channels, C_out·r²) float32 (HWIO) and ``b``
    (C_out·r²,) such that ``d2s_r(conv_SAME(y, K) + b) == tail_fn(y)`` in
    the interior. Raises ``ValueError`` if the bias varies, if energy
    leaks outside the S×S support, or if the composite misses the tail on a
    dense input (an activation or norm inside).
    """
    with no_tf32(), torch.no_grad():
        return _extract_affine_conv(tail_fn, in_channels, scale_factor,
                                    support, tol)


def _extract_affine_conv(tail_fn, in_channels, scale_factor, support, tol):
    r = scale_factor
    S = support
    c0 = S // 2
    P = 4 * S  # probe canvas: comfortably larger than the support
    p0 = P // 2

    zeros = torch.zeros((1, P, P, in_channels), dtype=torch.float32)
    bias_phases = space_to_depth(tail_fn(zeros), r)[0]  # (P, P, C_out·r²)
    b = bias_phases[p0, p0]
    interior = bias_phases[c0:P - c0, c0:P - c0]
    if not torch.allclose(interior, b.expand_as(interior), rtol=1e-5,
                          atol=1e-4):
        raise ValueError("tail is not translation-invariant affine (bias varies)")

    # impulse ci sits at (p0, p0) of batch item ci
    y = torch.zeros((in_channels, P, P, in_channels), dtype=torch.float32)
    ci = torch.arange(in_channels)
    y[ci, p0, p0, ci] = 1.0
    resp = space_to_depth(tail_fn(y), r) - bias_phases  # remove affine offset
    # conv_SAME: z[p,q] = Σ K[dy,dx] y[p+dy-c0, q+dx-c0], so with y = δ at
    # p0: z[p,q] = K[p0-p+c0, p0-q+c0] — the support window read backwards
    lo, hi = p0 + c0 - (S - 1), p0 + c0 + 1
    window = resp[:, lo:hi, lo:hi, :]
    K = window.flip(1, 2).permute(1, 2, 0, 3).contiguous()
    outside = resp.clone()
    outside[:, lo:hi, lo:hi, :] = 0
    leak = outside.abs().amax(dim=(1, 2, 3))
    if (leak > tol).any():
        ch = int(torch.nonzero(leak > tol)[0])
        raise ValueError(
            f"impulse response leaks {float(leak[ch]):.2e} outside support "
            f"{S} (channel {ch}) — increase `support`")

    # superposition check: impulse probing alone cannot certify affineness
    # (e.g. a ReLU inactive at zero/impulse inputs); hold the composite to
    # the tail on a random dense input.
    gen = torch.Generator(device="cpu").manual_seed(0)
    y = torch.rand((1, P, P, in_channels), generator=gen)
    want = tail_fn(y)
    z = F.conv2d(y.permute(0, 3, 1, 2), K.permute(3, 2, 0, 1),
                 padding=c0).permute(0, 2, 3, 1) + b
    got = depth_to_space(z.contiguous(), r)
    m = c0 * r  # border band where per-stage padding legitimately differs
    err = float((got[:, m:-m, m:-m] - want[:, m:-m, m:-m]).abs().max())
    if err > 1e-3:
        raise ValueError(
            f"composite deviates {err:.2e} from the tail on a dense input — "
            "the tail is not affine (activation or norm inside?)")
    return K.numpy(), b.numpy()


def _composite(model, support: int):
    """(K, b) of ``model``'s tail, probed on a float32 clone (bf16 rounding
    would fail the superposition check) that runs on the model's device."""
    device = next(model.parameters()).device
    model_f32 = model.clone(torch.float32)

    def tail_f32(y):
        return model_f32.tail(y.to(device)).to("cpu", torch.float32)

    return extract_affine_conv(tail_f32, model.base_filter,
                               model.scale_factor, support)


def make_fused_tail_predict(model, support: int = 7):
    """NHWC forward of an EDSR-style ``model`` with its tail collapsed.

    ``model`` exposes ``body``/``tail`` (``sr_torch/models/edsr.py``) and
    holds its weights. Interior-exact against ``model(x)``; see the module
    docstring for the border band. The tail runs on the model's device;
    the probes and the composite's arithmetic stay on the CPU.
    """
    r = model.scale_factor
    device = next(model.parameters()).device
    K, b = _composite(model, support)
    dtype = model.dtype
    # contiguous OIHW: an exported program saves its constants densely
    weight = torch.from_numpy(K).permute(3, 2, 0, 1).to(device, dtype)
    weight = weight.contiguous()
    bias = torch.from_numpy(b).to(device, dtype)
    pad = support // 2

    def predict(x: torch.Tensor) -> torch.Tensor:
        h = model.body(x)  # NHWC in the model's dtype
        # the shuffle adds the composite bias as it loads the conv's output
        # (cuDNN's conv would add it in a pass of its own)
        z = F.conv2d(h.permute(0, 3, 1, 2).to(dtype), weight, padding=pad)
        return depth_to_space(z.permute(0, 2, 3, 1).contiguous(), r,
                              bias=bias)

    return predict


class _Found(Exception):
    pass


def _first_tail_conv_site(model) -> str | None:
    """Site key of the tail's first conv: its calibrated input scale is the
    body output's. The probe stops the tail at its first conv, before any
    arithmetic."""
    keys = site_keys(model)
    found: list[str] = []

    def probe(conv, x):
        found.append(keys[conv])
        raise _Found

    device = next(model.parameters()).device
    try:
        with torch.inference_mode(), intercept_convs(probe):
            model.tail(torch.zeros((1, 1, 1, model.base_filter),
                                   device=device))
    except _Found:
        pass
    return found[0] if found else None


def make_fused_tail_predict_quant(model, support: int = 7,
                                  calib_headroom: float = 1.0,
                                  output_u8: bool = False,
                                  calib_batches=None):
    """Fused affine tail + static-int8 body, NHWC in and out
    (``sr/kernels/fused_tail.py:make_fused_tail_predict_quant``).

    The body's convs run int8 with calibrated scales (per input channel);
    the collapsed tail conv runs int8 too, with a per-output-channel
    composite kernel and the calibrated body-output scale. Calibration
    happens on the first batch, or up front on ``calib_batches``;
    ``.calibrate(batches)`` calibrates eagerly (no-op once calibrated).
    Interior-exact up to the int8 grid; the border band of
    :func:`make_fused_tail_predict` applies. With ``output_u8`` the output
    is quantized to u8 before the shuffle, so the shuffle moves u8.
    """
    r = model.scale_factor
    device = next(model.parameters()).device
    K, b = _composite(model, support)
    b_t = torch.from_numpy(b).to(device)

    def build(calib):
        scales = calibrate_scales_batches(model, calib,
                                          headroom=calib_headroom)
        site = _first_tail_conv_site(model)
        if site is not None and site in scales:
            s_h = scales[site]  # body output == first tail conv input
        else:  # one extra float body forward per calibration batch
            with torch.inference_mode():
                amax = max(float(model.body(z).to(torch.float32).abs().max())
                           for z in calib)
            s_h = max(amax / 127.0, _EPS)
        if np.ndim(s_h) == 1:  # per channel: fold into K (see int8_conv)
            s_h = np.maximum(s_h, _EPS)
            Kf = K * np.asarray(s_h)[None, None, :, None]
        else:
            Kf = K * float(s_h)
        s_K = np.maximum(np.abs(Kf).max(axis=(0, 1, 2)) / 127.0, _EPS)
        qK = torch.from_numpy(np.clip(np.round(Kf / s_K), -127, 127)
                              .astype(np.int8)).to(device)
        packed = pack_weights(qK)
        s_out = torch.from_numpy(np.asarray(s_K, np.float32)).to(device)
        inv_s_h = torch.from_numpy(
            np.asarray(1.0 / np.asarray(s_h, np.float32), np.float32)
        ).to(device)
        sites = _sites(model, scales)

        def fn(x):
            h = _run_sites(model, sites, x, "body")
            with torch.inference_mode():
                with span(SITE_SPAN):
                    # the JAX package multiplies by 1/s_h here, not divides
                    z = conv_int8_fused(h.to(torch.float32).contiguous(),
                                        qK, inv_s_h, s_out, b_t,
                                        reciprocal=True, packed=packed)
                if output_u8:
                    return depth_to_space(to_u8(z), r)
                return depth_to_space(z.to(h.dtype), r)

        return fn

    predict = calibrated_once(build)
    if calib_batches is not None:  # corpus calibration, up front
        predict.calibrate(calib_batches)
    return predict
