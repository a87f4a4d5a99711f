"""What decides ``correct``: the program's answers against the reference.

An answer is one batch of input images (uint8 NHWC) and the program's
uint8 output for it, taken from the timed path at the timed sizes. The
reference (``srbench/reference/<name>.py``, float32, TF32 off) runs on the
same input with the same weights, after the program's state is freed, a
few images at a time; its output, times 255 and clamped to [0, 255] but
not rounded, is what the u8 output should round to. The numbers read of
each image, of which the worst image's are kept:

* ``worst_rmse_u8``: the root mean square gap in u8 levels;
* ``worst_over3n_pct``: the share of output values more than 3 noise units
  off, a unit being the RMS gap of the plain reference computed in bf16
  (weights and input cast, served as u8) on that image. The unit carries
  the seed's own noise gain: with random weights, how much bf16 rounding
  reaches the output differs by about twofold from seed to seed.

``srbench/limits/<cell>.json`` says which of them the cell compares, each
with its limit: one that separates the program's sound runs from its
control by threefold or more.

:func:`reference_predict` puts the reference in the program's place at a
lower precision (``bits``): the control of a cell whose route is int8.
"""

from __future__ import annotations

import statistics

import torch

from srbench import reference
from srbench.reference.common import Convs, full_fp32

#: images the reference runs at once (memory, not speed)
REF_CHUNK = 2

#: the gap, in noise units, whose share of an image's values is read
UNITS = 3


def _levels(ref, config, params, stats, tail, x_u8, dtype=torch.float32):
    x = x_u8.to(dtype) / 255.0
    y = ref.forward(params, stats, x, config, Convs(), tail)
    return (y.to(torch.float32) * 255.0).clamp(0.0, 255.0)


def _cast(tree, dtype):
    return None if tree is None else (
        {k: v.to(dtype) for k, v in tree.items()} if isinstance(tree, dict)
        else tuple(v.to(dtype) for v in tree))


def compare(config: dict, params: dict, stats: dict, answers, device
            ) -> dict:
    """Readings of the answers ``[(x_u8, y_u8), ...]`` against the
    reference (see the module's docstring), and for the record the median
    image's RMSE and noise unit, the largest gap of any value and the
    count of images."""
    ref = reference.load(config["reference"])
    rmse, over, noise, worst_abs = [], [], [], 0.0
    with torch.no_grad(), full_fp32():
        tail = (ref.collapsed_tail(params, config)
                if config["serving"]["fused"] else None)
        bf16 = [_cast(t, torch.bfloat16) for t in (params, stats, tail)]
        for x_u8, y_u8 in answers:
            x_u8 = torch.as_tensor(x_u8).to(device)
            y_u8 = torch.as_tensor(y_u8).to(device)
            if x_u8.dim() == 3:
                x_u8, y_u8 = x_u8[None], y_u8[None]
            for i in range(0, x_u8.shape[0], REF_CHUNK):
                x = x_u8[i:i + REF_CHUNK]
                want = _levels(ref, config, params, stats, tail, x)
                got = y_u8[i:i + REF_CHUNK].to(torch.float32)
                if got.shape != want.shape:
                    rmse += [float("inf")] * got.shape[0]
                    over += [100.0] * got.shape[0]
                    continue
                # the noise unit: the plain bf16 reference, served as u8
                unit = (torch.round(_levels(ref, config, *bf16[:2],
                                            bf16[2], x, torch.bfloat16))
                        - want).square().mean(dim=(1, 2, 3)).sqrt()
                noise += unit.tolist()
                d = got - want
                rmse += d.square().mean(dim=(1, 2, 3)).sqrt().tolist()
                unit = unit.clamp_min(1e-3).view(-1, 1, 1, 1)
                over += (100.0 * (d.abs() > UNITS * unit).float()
                         .mean(dim=(1, 2, 3))).tolist()
                worst_abs = max(worst_abs, float(d.abs().max()))
    if not rmse:
        return {"images": 0}
    readings = {"worst_rmse_u8": max(rmse),
                f"worst_over{UNITS}n_pct": max(over),
                "median_rmse_u8": statistics.median(rmse),
                "worst_abs_u8": worst_abs, "images": len(rmse)}
    if noise:
        readings["median_bf16_rmse_u8"] = statistics.median(noise)
    return readings


def judge(readings: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """``(correct, checks)``: every limited reading at or under its limit,
    no answer missing or failed, and at least one answer compared."""
    checks = {"failed": {"value": failed, "limit": 0}}
    for name, limit in limits.items():
        checks[name] = {"value": readings.get(name, float("inf")),
                        "limit": limit}
    ok = readings.get("images", 0) > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def reference_predict(config: dict, params: dict, stats: dict, bits: int,
                      calib_x: torch.Tensor):
    """The reference in the program's place, every conv fake-quantized to
    ``bits`` with scales calibrated on ``calib_x`` (NHWC float in [0, 1])
    at the route's headroom: ``x → uint8 NHWC``, as the served route."""
    ref = reference.load(config["reference"])
    convs = Convs(bits, config["serving"]["calib_headroom"])
    with torch.no_grad(), full_fp32():
        tail = (ref.collapsed_tail(params, config)
                if config["serving"]["fused"] else None)
        convs.calibrating = True
        for i in range(0, calib_x.shape[0], REF_CHUNK):
            ref.forward(params, stats, calib_x[i:i + REF_CHUNK], config,
                        convs, tail)
        convs.calibrating = False

    def predict(x):
        with torch.no_grad(), full_fp32():
            outs = [ref.forward(params, stats, x[i:i + REF_CHUNK], config,
                                convs, tail)
                    for i in range(0, x.shape[0], REF_CHUNK)]
        y = torch.cat(outs)
        return torch.round(y * 255.0).clamp(0, 255).to(torch.uint8)

    return predict
