"""Collapse an affine upsampling tail into one conv + one pixel shuffle.

Port of ``sr/kernels/fused_tail.py`` (float path). EDSR's tail —
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
from sr_torch.utils.precision import no_tf32


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


def make_fused_tail_predict(model, support: int = 7):
    """NHWC forward of an EDSR-style ``model`` with its tail collapsed.

    ``model`` exposes ``body``/``tail`` (``sr_torch/models/edsr.py``) and
    holds its weights. Interior-exact against ``model(x)``; see the module
    docstring for the border band. The tail runs on the model's device;
    the probes and the composite's arithmetic stay on the CPU.
    """
    r = model.scale_factor
    device = next(model.parameters()).device
    # probe a float32 clone: bf16 rounding would fail the superposition check
    model_f32 = model.clone(torch.float32)

    def tail_f32(y):
        return model_f32.tail(y.to(device)).to("cpu", torch.float32)

    K, b = extract_affine_conv(tail_f32, model.base_filter, r, support)
    dtype = model.dtype
    weight = torch.from_numpy(K).permute(3, 2, 0, 1).to(device, dtype)
    bias = torch.from_numpy(b).to(device, dtype)
    pad = support // 2

    def predict(x: torch.Tensor) -> torch.Tensor:
        h = model.body(x)  # NHWC in the model's dtype
        z = F.conv2d(h.permute(0, 3, 1, 2).to(dtype), weight, bias,
                     padding=pad)
        return depth_to_space(z.permute(0, 2, 3, 1).contiguous(), r)

    return predict
