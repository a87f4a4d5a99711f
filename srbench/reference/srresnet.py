"""SRResNet (Ledig et al., CVPR 2017), plain float32 reference.

RGB in, RGB out at ×r. 9×9 conv + PReLU → ``num_resblocks`` blocks of
conv-BN-PReLU-conv-BN with an identity skip → 3×3 conv-BN + the global
skip from the head → one sub-pixel stage a factor of ``upsample_factors``
(3×3 conv to C·r², pixel shuffle, PReLU) → 9×9 output conv. Served in
inference mode: each batch norm applies its running statistics,
``(x − mean) · rsqrt(var + 1e-5) · scale + bias``. Each PReLU has one
shared slope, as in the served model.

The served ``fused`` route folds the output conv through the last shuffle,
which is exact, borders included; so the reference is the exact graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from srbench.reference.common import FLOAT, Convs, prelu

_BN_EPS = 1e-5


def params(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(path, shape, init)`` of every weight, in a fixed order."""
    f, c, k = cfg["base_filter"], cfg["num_channels"], cfg["kernel_size"]
    out = []

    def conv(path, cin, cout, ks, init):
        out.append((f"{path}/kernel", (ks, ks, cin, cout), init))
        out.append((f"{path}/bias", (cout,), "bias"))

    def bn(path, branch=False):
        out.append((f"{path}/scale", (f,),
                    "bn_branch_scale" if branch else "bn_scale"))
        out.append((f"{path}/bias", (f,), "bn_bias"))

    conv("head", c, f, cfg["head_kernel_size"], "he")
    out.append(("head_act/slope", (), "slope"))
    for i in range(cfg["num_resblocks"]):
        conv(f"blocks_{i}/Conv_0", f, f, k, "he")
        bn(f"blocks_{i}/_NormAct_0/BatchNorm_0")
        out.append((f"blocks_{i}/_NormAct_0/PReLU_0/slope", (), "slope"))
        conv(f"blocks_{i}/Conv_1", f, f, k, "lecun")
        bn(f"blocks_{i}/BatchNorm_0", branch=True)
    conv("body_conv", f, f, k, "lecun")
    bn("body_bn")
    for j, r in enumerate(cfg["upsample_factors"]):
        conv(f"upsample_{j}/Conv_0", f, f * r * r, k, "he")
        out.append((f"upsample_{j}/_NormAct_0/PReLU_0/slope", (), "slope"))
    conv("out_conv", f, c, cfg["out_kernel_size"], "out")
    return out


def stats(cfg: dict) -> list[tuple[str, tuple]]:
    """``(path, shape)`` of every running statistic."""
    f = cfg["base_filter"]
    out = []
    names = [n for i in range(cfg["num_resblocks"])
             for n in (f"blocks_{i}/_NormAct_0/BatchNorm_0",
                       f"blocks_{i}/BatchNorm_0")] + ["body_bn"]
    for n in names:
        out += [(f"{n}/mean", (f,)), (f"{n}/var", (f,))]
    return out


def _conv(p, convs, path, x):
    return convs(path, x, p[f"{path}/kernel"], p[f"{path}/bias"])


def _bn(p, st, path, x, estimate):
    if estimate is not None:
        estimate(path, x)
    mul = torch.rsqrt(st[f"{path}/var"] + _BN_EPS) * p[f"{path}/scale"]
    return ((x - st[f"{path}/mean"].view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
            + p[f"{path}/bias"].view(1, -1, 1, 1))


def _features(p, st, x, cfg, convs, estimate):
    h = prelu(_conv(p, convs, "head", x), p["head_act/slope"])
    skip = h
    for i in range(cfg["num_resblocks"]):
        pre = f"blocks_{i}/"
        t = _bn(p, st, pre + "_NormAct_0/BatchNorm_0",
                _conv(p, convs, pre + "Conv_0", h), estimate)
        t = prelu(t, p[pre + "_NormAct_0/PReLU_0/slope"])
        t = _bn(p, st, pre + "BatchNorm_0", _conv(p, convs, pre + "Conv_1", t),
                estimate)
        h = h + t
    h = _bn(p, st, "body_bn", _conv(p, convs, "body_conv", h), estimate) + skip
    for j, r in enumerate(cfg["upsample_factors"]):
        h = F.pixel_shuffle(_conv(p, convs, f"upsample_{j}/Conv_0", h), r)
        h = prelu(h, p[f"upsample_{j}/_NormAct_0/PReLU_0/slope"])
    return h


def forward(p: dict, st: dict, x: torch.Tensor, cfg: dict,
            convs: Convs = FLOAT, tail: tuple | None = None) -> torch.Tensor:
    """NHWC image in [0, 1] → NHWC output, unclamped (``tail`` unused:
    the folded tail is the exact graph)."""
    del tail
    h = _features(p, st, x.permute(0, 3, 1, 2), cfg, convs, None)
    return _conv(p, convs, "out_conv", h).permute(0, 2, 3, 1)


def collapsed_tail(p: dict, cfg: dict):
    """The served fused tail is the exact fold: nothing to derive."""
    return None


def features(p: dict, st: dict, x: torch.Tensor, cfg: dict, estimate=None):
    """NCHW features that enter the output conv (weights set-up);
    ``estimate(path, x)`` sees each batch norm's input first."""
    return _features(p, st, x.permute(0, 3, 1, 2), cfg, FLOAT, estimate)


OUT_CONV = "out_conv"
