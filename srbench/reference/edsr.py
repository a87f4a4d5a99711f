"""EDSR (Lim et al., CVPRW 2017), plain float32 reference.

RGB in, RGB out at ×r. Head 3×3 conv → ``num_resblocks`` blocks of
conv-ReLU-conv with an identity skip (the baseline: no residual scaling
when ``res_scale`` is 1) → 3×3 conv + the global skip from the head →
one sub-pixel stage a factor of ``upsample_factors`` (3×3 conv to C·r²,
pixel shuffle) → 3×3 output conv. Departure from the paper's code: no
mean shift at the input and output (the served model has none).

``fused`` serving collapses the activation-free tail into one conv and
one shuffle; the reference derives that composite from its own weights
(:func:`collapsed_tail`) and serves it the same way, so its border band
is the composite's and not the exact graph's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from srbench.reference.common import FLOAT, Convs, collapse_affine_tail

#: the composite's support in LR pixels (covers the tail's receptive field)
SUPPORT = 7


def params(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(path, shape, init)`` of every weight, in a fixed order."""
    f, c, k = cfg["base_filter"], cfg["num_channels"], cfg["kernel_size"]
    out = []

    def conv(path, cin, cout, ks, init):
        out.append((f"{path}/kernel", (ks, ks, cin, cout), init))
        out.append((f"{path}/bias", (cout,), "bias"))

    conv("head/Conv_0", c, f, cfg["head_kernel_size"], "lecun")
    for i in range(cfg["num_resblocks"]):
        conv(f"blocks_{i}/Conv_0", f, f, k, "he")
        conv(f"blocks_{i}/Conv_1", f, f, k, "branch")
    conv("body_conv/Conv_0", f, f, k, "lecun")
    for j, r in enumerate(cfg["upsample_factors"]):
        conv(f"upsample_{j}/Conv_0", f, f * r * r, k, "lecun")
    conv("out_conv/Conv_0", f, c, cfg["out_kernel_size"], "out")
    return out


def stats(cfg: dict) -> list[tuple[str, tuple]]:
    """No batch norms."""
    return []


def _conv(p, convs, path, x):
    return convs(path, x, p[f"{path}/kernel"], p[f"{path}/bias"])


def body(p: dict, x: torch.Tensor, cfg: dict, convs: Convs = FLOAT):
    """NCHW LR image → NCHW features."""
    h = _conv(p, convs, "head/Conv_0", x)
    skip = h
    for i in range(cfg["num_resblocks"]):
        t = torch.relu(_conv(p, convs, f"blocks_{i}/Conv_0", h))
        t = _conv(p, convs, f"blocks_{i}/Conv_1", t)
        h = h + (t if cfg["res_scale"] == 1.0 else t * cfg["res_scale"])
    return _conv(p, convs, "body_conv/Conv_0", h) + skip


def stages(p: dict, h: torch.Tensor, cfg: dict, convs: Convs = FLOAT):
    """The sub-pixel stages: features before the output conv."""
    for j, r in enumerate(cfg["upsample_factors"]):
        h = F.pixel_shuffle(_conv(p, convs, f"upsample_{j}/Conv_0", h), r)
    return h


def collapsed_tail(p: dict, cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The tail's composite ``(K, b)`` in float32 on the weights' device,
    probed in float64 on the CPU."""
    p64 = {k: v.detach().to("cpu", torch.float64) for k, v in p.items()
           if k.startswith(("upsample_", "out_conv/"))}

    def tail(y):
        return _conv(p64, FLOAT, "out_conv/Conv_0", stages(p64, y, cfg))

    r = 1
    for f in cfg["upsample_factors"]:
        r *= f
    k, b = collapse_affine_tail(tail, cfg["base_filter"], r, SUPPORT)
    dev = p["out_conv/Conv_0/kernel"].device
    return k.to(dev, torch.float32), b.to(dev, torch.float32)


def forward(p: dict, st: dict, x: torch.Tensor, cfg: dict,
            convs: Convs = FLOAT, tail: tuple | None = None) -> torch.Tensor:
    """NHWC image in [0, 1] → NHWC output, unclamped. ``tail``: the
    composite of :func:`collapsed_tail` (the fused route) or None (the
    exact graph)."""
    h = body(p, x.permute(0, 3, 1, 2), cfg, convs)
    if tail is None:
        y = _conv(p, convs, "out_conv/Conv_0", stages(p, h, cfg, convs))
    else:
        k, b = tail
        r = int(round((k.shape[-1] // cfg["num_channels"]) ** 0.5))
        y = F.pixel_shuffle(convs("tail/composite", h, k, b), r)
    return y.permute(0, 2, 3, 1)


def features(p: dict, st: dict, x: torch.Tensor, cfg: dict, estimate=None):
    """NCHW features that enter the output conv (weights set-up)."""
    del st, estimate
    return stages(p, body(p, x.permute(0, 3, 1, 2), cfg), cfg)


OUT_CONV = "out_conv/Conv_0"
