"""Int8 post-training quantization for serving, and ``to_u8``.

Port of ``sr/quant.py`` for the port's models (convs only). Every conv of a
model runs as s8 × s8 → s32, then one float32 rescale and the bias, all
through :func:`conv_int8_fused`: on the card one kernel launch that
quantizes as it loads and dequantizes as it stores, on the CPU its plain
version, which runs the JAX package's passes one by one:

* **Weights**: per-output-channel symmetric int8 (:func:`quantize_kernel`).
* **Activations**: per-sample symmetric int8 with a dynamic scale
  (:func:`quantize_activation`), or a static scale calibrated on real
  inputs (:func:`calibrate_scales`): per input channel by default, folded
  into the weights so that the dequantize stays one per-output-channel
  multiply, or one per-tensor float.
* **Accumulation**: exact int32, then ``acc.float() * (s_x * s_w)``, then
  ``+ bias``, then the cast to the conv input's dtype, each its own
  rounding, in the JAX package's order. Given the same scales, the port's
  output equals ``sr.quant.quantized_apply`` bit for bit.

The int8 graph keeps the input's dtype: the image enters as float32, so
every activation of an int8 forward is float32 whatever the model's dtype,
as in the JAX package. Calibration runs the float graph in the model's
dtype and records each conv's input before the conv casts it.

Everything between the sites stays float, as in the JAX package: the
activations, and a batch-norm model's norms (SRResNet, SRGAN), which
serving runs in eval mode with their running statistics and in the
model's dtype, so in a bfloat16 model the tensor after a norm is bfloat16
and the next site returns bfloat16.

Transposed convs (FSRCNN's 9×9 stride-4 tail, LapSRN's 4×4 stride-2
pyramid) run in the compute dtype by default, as in the JAX package;
``quantize_deconv=True`` runs each as int8 too (:func:`int8_deconv`, the
contract of ``sr/quant.py:int8_deconv``). A stride-s transposed conv whose
output is exactly s·H × s·W equals one stride-1 SAME conv with s²·N
outputs followed by the pixel shuffle, ``out[s·q+i] = Σ_d x[q+d] ·
w[i+p−s·d]``: the deconv's already-quantized kernel is repacked into those
sub-pixel phases (:func:`phase_pack`, a 3×3 conv for both zoo geometries),
its per-output-channel scales and bias repeated over the s² phases, and it
runs through the same fused int8 conv and then the shuffle kernel
(``sr_torch/kernels/depth_to_space.py``). The int32 accumulator is exact
either way, so the result equals ``sr.quant.int8_deconv`` bit for bit.
Calibration records a deconv's input as it records a conv's, so the scale
dicts carry the JAX package's keys.

Mechanism: ``sr_torch.nn.intercept`` offers each conv and deconv of the
blocks to an interceptor, the counterpart of
``flax.linen.intercept_methods``. Grouped, strided, dilated or even-sized
convs, and deconvs of another geometry than ``DeconvBlock``'s, belong to no
port model yet and raise ``NotImplementedError``; nothing falls back to a
float conv.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch
from torch import nn

from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.kernels.int8_conv import conv_int8_fused, pack_weights
from sr_torch.nn.blocks import deconv_padding
from sr_torch.nn.intercept import intercept_convs, recurrent_convs, site_keys

_EPS = 1e-12
_LATER = "lands in a later port slice"


def to_u8(y: torch.Tensor) -> torch.Tensor:
    """[0,1]-float → uint8 image, bit-equal to the host-side
    ``np.clip(np.round(sr*255), 0, 255).astype(uint8)``: the same float32
    math and the same half-to-even rounding (``torch.round`` like
    ``jnp.round``). Quantizing on the device quarters the bytes copied to
    the host against float32."""
    return torch.clamp(torch.round(y.to(torch.float32) * 255.0),
                       0, 255).to(torch.uint8)


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` rounded once, as the CPU and the JAX package divide. With
    a Python number as the divisor, PyTorch's CUDA kernel multiplies by
    1/127 instead, which lands one ulp off for some values."""
    return t / torch.full_like(t, 127.0)


def quantize_kernel(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: HWIO (k, k, cin, cout) →
    (int8 kernel, float32 scale[cout])."""
    k32 = kernel.to(torch.float32)
    s = torch.clamp_min(_div127(k32.abs().amax(dim=(0, 1, 2))), _EPS)
    q = torch.clamp(torch.round(k32 / s), -127, 127).to(torch.int8)
    return q, s


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample symmetric int8 with a dynamic scale, reduced over every
    axis but the batch (shape (B, 1, …, 1)): one image's range never
    coarsens another's grid under micro-batching."""
    x32 = x.to(torch.float32)
    s = activation_scale(x32)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s


def activation_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic per-sample scale of :func:`quantize_activation`, shape
    (B, 1, …, 1): a plain reduction, as the JAX package leaves it to XLA."""
    x32 = x.to(torch.float32)
    s = _div127(x32.abs().amax(dim=tuple(range(1, x32.dim())), keepdim=True))
    return torch.clamp_min(s, _EPS)


def quantize_activation_static(x: torch.Tensor, scale
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with a static (calibrated) scale: a per-tensor float
    or a per-channel ``(C,)`` vector over the last axis (NHWC), as numbers
    or as a float32 tensor on ``x``'s device. Values out of range saturate
    at ±127."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.as_tensor(np.asarray(scale, np.float32),
                                device=x.device)
    s = torch.clamp_min(scale, _EPS)
    q = torch.clamp(torch.round(x.to(torch.float32) / s),
                    -127, 127).to(torch.int8)
    return q, s


def _check_deconv(deconv: nn.Module) -> None:
    """Refuse a transposed conv the phase route cannot run: anything but a
    square kernel k ≥ s, stride (s, s) and ``DeconvBlock``'s exact ×s
    padding, no dilation or groups."""
    if not isinstance(deconv, nn.ConvTranspose2d):
        raise TypeError(f"int8_deconv takes an nn.ConvTranspose2d, got "
                        f"{type(deconv).__name__}")
    k, s = deconv.kernel_size, deconv.stride
    if (k[0] != k[1] or s[0] != s[1] or k[0] < s[0]
            or (deconv.padding, deconv.output_padding) != tuple(
                (v, v) for v in deconv_padding(k[0], s[0]))
            or deconv.dilation != (1, 1) or deconv.groups != 1):
        raise NotImplementedError(
            f"int8 deconv with kernel {k}, stride {s}, padding "
            f"{deconv.padding}, output padding {deconv.output_padding}, "
            f"dilation {deconv.dilation}, groups {deconv.groups} {_LATER}; "
            "the port's int8 deconv takes DeconvBlock's exact ×stride "
            "geometry")


def _check_site(conv: nn.Module) -> None:
    if isinstance(conv, nn.ConvTranspose2d):
        raise TypeError("a transposed conv is int8_deconv's site, not "
                        "int8_conv's")
    if not isinstance(conv, nn.Conv2d):
        raise TypeError(f"int8_conv takes an nn.Conv2d, got "
                        f"{type(conv).__name__}")
    k = conv.kernel_size
    if (k[0] != k[1] or k[0] % 2 == 0 or conv.stride != (1, 1)
            or conv.dilation != (1, 1) or conv.groups != 1
            or conv.padding != (k[0] // 2, k[0] // 2)
            or conv.padding_mode != "zeros"):
        raise NotImplementedError(
            f"int8 conv with kernel {k}, stride {conv.stride}, dilation "
            f"{conv.dilation}, groups {conv.groups}, padding "
            f"{conv.padding} {_LATER}; the port's int8 conv takes odd square "
            "kernels, SAME padding, stride 1, no groups")


def phase_radius(k: int, s: int) -> int:
    """R of the (2R+1)² SAME conv that computes a k×k stride-s transposed
    conv of ``DeconvBlock``'s geometry as s² sub-pixel phases: output
    phase i reads the input at offsets d with 0 ≤ i + p − s·d < k."""
    p, _ = deconv_padding(k, s)
    return max((s - 1 + p) // s, (k - 1 - p) // s)


def phase_pack(kernel: torch.Tensor, s: int) -> torch.Tensor:
    """A transposed conv's kernel ``(k, k, C, N)``, in torch's orientation
    (``weight.permute(2, 3, 0, 1)`` of an ``nn.ConvTranspose2d``), →
    the ``(2R+1, 2R+1, C, N·s²)`` HWIO kernel of the stride-1 SAME conv
    whose output, shuffled by :func:`depth_to_space` at r=s, is the
    deconv's: output channel ``n·s² + i·s + j`` (the shuffle's order) holds
    phase (i, j) of channel n, ``w[R+dy, R+dx] = kernel[i+p−s·dy,
    j+p−s·dx]``, zero where that tap lies outside the kernel. Works on any
    dtype (the int8 kernel after quantization)."""
    k, _, c, n = kernel.shape
    p, _ = deconv_padding(k, s)
    r = phase_radius(k, s)
    out = kernel.new_zeros((2 * r + 1, 2 * r + 1, c, n, s, s))
    for i in range(s):
        for dy in range(-r, r + 1):
            a = i + p - s * dy
            if not 0 <= a < k:
                continue
            for j in range(s):
                for dx in range(-r, r + 1):
                    b = j + p - s * dx
                    if 0 <= b < k:
                        out[r + dy, r + dx, :, :, i, j] = kernel[a, b]
    return out.reshape(2 * r + 1, 2 * r + 1, c, n * s * s)


class _Int8Site:
    """One conv's int8 operands, quantized once on the weights' device (the
    JAX package folds them into the executable at trace time): the int8
    HWIO kernel and its kernel packing, its per-output-channel
    scales, the float32 bias, and for a static site the activation scale
    and the dequantize multiplier. Built from a float HWIO ``kernel`` (k
    odd, SAME padding) and its ``bias``, or from a conv with :meth:`of`.
    ``phases`` (a deconv's stride s): quantize ``kernel``, a transposed
    conv's in torch's orientation, per output channel, then repack it
    with :func:`phase_pack` and repeat its scales and bias over the s²
    phases (:class:`_Int8DeconvSite`)."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor | None,
                 static_scale=None, phases: int | None = None):
        with torch.no_grad():
            kernel = kernel.detach()
            dev = kernel.device
            self.s_act = None  # dynamic
            if static_scale is not None and np.ndim(static_scale) == 1:
                # q_x[c] ≈ x[c]/s_c against W[.., c, ..]·s_c keeps the
                # product, so the dequantize stays per output channel
                s_c = torch.from_numpy(np.maximum(static_scale, _EPS)
                                       .astype(np.float32)).to(dev)
                kernel = kernel.to(torch.float32) * s_c[None, None, :, None]
                self.s_act = torch.clamp_min(s_c, _EPS)
            elif static_scale is not None:
                self.s_act = torch.clamp_min(torch.tensor(
                    static_scale, dtype=torch.float32, device=dev), _EPS)
            q_w, self.s_w = quantize_kernel(kernel)
            if phases is not None:
                # scales of the deconv's own output channels, taken before
                # the repack (scales of the phase kernel would differ)
                q_w = phase_pack(q_w, phases)
                self.s_w = self.s_w.repeat_interleave(phases * phases)
                if bias is not None:
                    bias = bias.detach().repeat_interleave(phases * phases)
            self.q_w = q_w.contiguous()
            # on either device, so a program traced on one runs on the
            # other; the CPU's plain version ignores it
            self.packed = pack_weights(self.q_w)
            if self.s_act is not None:
                # s_x * s_w; a folded per-channel scale leaves s_x = 1
                self.dequant = (self.s_w if self.s_act.dim()
                                else self.s_act * self.s_w)
            self.bias = (None if bias is None
                         else bias.detach().to(torch.float32))

    @classmethod
    def of(cls, conv: nn.Module, static_scale=None) -> "_Int8Site":
        _check_site(conv)
        return cls(conv.weight.permute(2, 3, 1, 0), conv.bias, static_scale)

    def nhwc(self, xh: torch.Tensor) -> torch.Tensor:
        """Contiguous float32 NHWC ``xh`` → the conv's float32 NHWC
        output."""
        if self.s_act is not None:
            scale, dequant = self.s_act, self.dequant
        else:
            scale = activation_scale(xh)
            dequant = scale * self.s_w
        return conv_int8_fused(xh, self.q_w, scale, dequant, self.bias,
                               packed=self.packed)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW-logical ``x`` (channels_last memory) → the conv's output
        in ``x``'s dtype, laid out the same way."""
        xh = x.permute(0, 2, 3, 1).to(torch.float32).contiguous()  # NHWC
        return self.nhwc(xh).to(x.dtype).permute(0, 3, 1, 2)


class _Int8DeconvSite:
    """One transposed conv's int8 operands as the phase-packed
    :class:`_Int8Site` of stride s; a call runs the fused int8 conv, then
    the shuffle at r=s."""

    def __init__(self, deconv: nn.ConvTranspose2d, static_scale=None):
        _check_deconv(deconv)
        self.stride = deconv.stride[0]
        self.site = _Int8Site(deconv.weight.permute(2, 3, 0, 1), deconv.bias,
                              static_scale, phases=self.stride)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1).to(torch.float32).contiguous()  # NHWC
        y = depth_to_space(self.site.nhwc(xh), self.stride)
        return y.to(x.dtype).permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, conv: nn.Conv2d,
              static_scale=None) -> torch.Tensor:
    """Run ``conv`` on NCHW-logical ``x`` as s8 × s8 → s32 with a float32
    rescale (``sr/quant.py:int8_conv``). ``static_scale``: a calibrated
    per-tensor float, or a per-input-channel ``(C,)`` vector folded into
    the weight quantization; ``None`` = dynamic per-sample scale."""
    return _Int8Site.of(conv, static_scale)(x)


def int8_deconv(x: torch.Tensor, deconv: nn.ConvTranspose2d,
                static_scale=None) -> torch.Tensor:
    """Run ``deconv`` (``DeconvBlock``'s exact ×stride geometry) on
    NCHW-logical ``x`` as s8 × s8 → s32 with a float32 rescale, the bias
    and the cast to ``x``'s dtype (``sr/quant.py:int8_deconv``), computed
    as the phase-packed fused int8 conv and the shuffle. ``static_scale``
    as :func:`int8_conv`'s."""
    return _Int8DeconvSite(deconv, static_scale)(x)


def _sites(model: nn.Module, scales: dict | None,
           quantize_deconv: bool = False) -> dict[nn.Module, Any]:
    """Every conv's int8 operands, and with ``quantize_deconv`` every
    transposed conv's; a site missing from ``scales`` (or all, for
    ``None``) runs with dynamic scales. A deconv without a site runs in
    the compute dtype."""
    scales = scales or {}
    sites: dict[nn.Module, Any] = {}
    for conv, key in site_keys(model).items():
        if isinstance(conv, nn.ConvTranspose2d):
            if quantize_deconv:
                sites[conv] = _Int8DeconvSite(conv, scales.get(key))
        else:
            sites[conv] = _Int8Site.of(conv, scales.get(key))
    return sites


def _run_sites(model, sites, x, method=None):
    """``model(x)`` or ``getattr(model, method)(x)`` with each conv
    running through its int8 site."""
    fn = model if method is None else getattr(model, method)
    with torch.inference_mode(), int8_sites(sites):
        return fn(x)


def int8_sites(sites: dict):
    """Inside ``with``, every conv of the blocks with a site in ``sites``
    runs through it; the others (a deconv left float) run as they are."""

    def fn(conv, inp):
        site = sites.get(conv)
        return None if site is None else site(inp)

    return intercept_convs(fn)


def quantized_apply(model: nn.Module, x: torch.Tensor,
                    scales: dict | None = None, method: str | None = None,
                    quantize_deconv: bool = False):
    """``model(x)`` (or ``getattr(model, method)(x)``) with every conv
    running int8, and every transposed conv too with ``quantize_deconv``.
    ``scales``: per-site static activation scales from
    :func:`calibrate_scales`; sites absent from the dict use the dynamic
    per-sample scale (``None`` = fully dynamic)."""
    return _run_sites(model, _sites(model, scales, quantize_deconv), x,
                      method)


def calibrate_scales(model: nn.Module, x: torch.Tensor,
                     headroom: float = 1.0,
                     per_channel: bool = True) -> dict[str, Any]:
    """One float forward (in the model's dtype) that records each conv's
    and deconv's input amax (deconvs whether or not they will run int8,
    as the JAX package's capture does); returns ``{flax path: scale}`` for
    the static int8 path.
    A site visited twice keeps the max. ``headroom`` multiplies every
    scale. ``per_channel`` (default): a per-input-channel ``(C,)`` float32
    vector, else one float. The convs of a recurrent block (DRCN's
    recursion) are not recorded, as the JAX package's calibration cannot
    see into its scan: they keep dynamic per-sample scales."""
    keys = site_keys(model)
    skip = recurrent_convs(model)
    captured: dict[str, torch.Tensor] = {}

    def record(conv, inp):
        if conv in skip:
            return None
        a32 = inp.detach().to(torch.float32).abs()
        amax = a32.amax(dim=(0, 2, 3)) if per_channel else a32.amax()
        k = keys[conv]
        captured[k] = (torch.maximum(captured[k], amax) if k in captured
                       else amax)
        return None  # the float conv runs

    # a fresh row-major copy: the stride of a size-1 dimension (0 in
    # numpy's ``x[None]``) can steer a float conv to another algorithm, and
    # the scales must not depend on how the caller laid out the batch
    x = x.clone(memory_format=torch.contiguous_format)
    with torch.inference_mode(), intercept_convs(record):
        model(x)
    if not captured:
        return {}
    # one device → host copy for every site
    names = list(captured)
    flat = torch.cat([captured[k].reshape(-1) for k in names]).cpu().numpy()
    scales: dict[str, Any] = {}
    pos = 0
    for k in names:
        n = captured[k].numel()
        v = flat[pos:pos + n] * (headroom / 127.0)
        pos += n
        scales[k] = (np.maximum(v, _EPS) if per_channel
                     else max(float(v[0]), _EPS))
    return scales


def calibrate_scales_batches(model: nn.Module, batches,
                             headroom: float = 1.0) -> dict[str, Any]:
    """:func:`calibrate_scales` over an iterable of batches, keeping each
    site's max."""
    out: dict[str, Any] = {}
    for x in batches:
        s = calibrate_scales(model, x, headroom)
        for k, v in s.items():
            out[k] = np.maximum(out[k], v) if k in out else v
    if not out:
        raise ValueError("calibrate_scales_batches: empty batch iterable")
    return out


def make_quantized_predict(model: nn.Module, mode: str = "dynamic",
                           calib_headroom: float = 1.0,
                           output_u8: bool = False, calib_batches=None,
                           quantize_deconv: bool = False):
    """Serving forward (NHWC in, NHWC out) with int8 convs; the weights are
    quantized once, when the function is built (dynamic) or calibrated
    (static). ``quantize_deconv`` runs the transposed convs as int8 too
    (:func:`int8_deconv`); by default they run in the compute dtype.

    ``mode``: ``"dynamic"`` — per-sample activation scales computed on the
    device each call; ``"static"`` — scales calibrated once, on the first
    batch the function sees (one extra float forward) or up front on
    ``calib_batches``; ``.calibrate(batches)`` calibrates eagerly (no-op
    once calibrated). Inputs hotter than the calibration saturate at the
    int8 grid's edge.
    """
    if mode not in ("dynamic", "static"):
        raise ValueError(f"unknown quantization mode: {mode!r}")

    def post(y):
        return to_u8(y) if output_u8 else y

    def _make(scales):
        sites = _sites(model, scales, quantize_deconv)
        return lambda x: post(_run_sites(model, sites, x))

    if mode == "dynamic":
        return _make(None)
    predict = calibrated_once(lambda batches: _make(calibrate_scales_batches(
        model, batches, headroom=calib_headroom)))
    if calib_batches is not None:
        predict.calibrate(calib_batches)
    return predict


def calibrated_once(build):
    """``predict(x)`` that builds its function from calibration batches
    once: from the first batch it sees, or eagerly through
    ``predict.calibrate(batches)`` (a no-op once built). ``build(batches)``
    returns the function. A lock covers the build, since the server calls
    from handler threads."""
    state: dict[str, Any] = {}
    lock = threading.Lock()

    def predict(x):
        if "fn" not in state:
            with lock:
                if "fn" not in state:
                    state["fn"] = build([x])
        return state["fn"](x)

    def calibrate(batches) -> None:
        with lock:
            if "fn" not in state:
                state["fn"] = build(list(batches))

    predict.calibrate = calibrate
    return predict
