"""Image-like content made on the device from a generator.

A scene is a smooth colour gradient, low-frequency blobs, a dozen or more
hard-edged rectangles and ellipses of random colour and opacity, two
oriented gratings (texture) under a smooth mask, and a little sensor
noise, in [0, 1]. Not noise: int8 calibration and the weights' set-up see
the ranges and edges of pictures. :func:`clips` pans a camera over larger
scenes for consecutive video frames; :func:`scenes` makes stills.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _u(g, shape, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def scenes(n: int, h: int, w: int, g: torch.Generator, device,
           shapes: int = 16) -> torch.Tensor:
    """``(n, h, w, 3)`` float32 scenes in [0, 1]."""
    yy = torch.linspace(0.0, 1.0, h, device=device).view(1, h, 1, 1)
    xx = torch.linspace(0.0, 1.0, w, device=device).view(1, 1, w, 1)
    aspect = w / h
    img = (_u(g, (n, 1, 1, 3), device, 0.2, 0.8)
           + _u(g, (n, 1, 1, 3), device, -0.4, 0.4) * xx
           + _u(g, (n, 1, 1, 3), device, -0.4, 0.4) * yy)
    low = torch.randn((n, 3, h // 32 + 2, w // 32 + 2), generator=g,
                      device=device) * 0.12
    img = img + F.interpolate(low, size=(h, w), mode="bicubic",
                              align_corners=False).permute(0, 2, 3, 1)
    for i in range(shapes):
        cy, cx = _u(g, (n, 1, 1, 1), device), _u(g, (n, 1, 1, 1), device)
        ry = _u(g, (n, 1, 1, 1), device, 0.03, 0.25)
        rx = ry / aspect * _u(g, (n, 1, 1, 1), device, 0.5, 2.0)
        if i % 2:
            mask = ((yy - cy).abs() < ry) & ((xx - cx).abs() < rx)
        else:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        alpha = _u(g, (n, 1, 1, 1), device, 0.5, 1.0) * mask
        img = img * (1 - alpha) + _u(g, (n, 1, 1, 3), device) * alpha
    for _ in range(2):
        theta = _u(g, (n, 1, 1, 1), device, 0.0, math.pi)
        freq = _u(g, (n, 1, 1, 1), device, 20.0, 120.0) * 2 * math.pi
        phase = (xx * aspect * torch.cos(theta) + yy * torch.sin(theta)) * freq
        blob = torch.randn((n, 1, 4, 4), generator=g, device=device)
        blob = F.interpolate(blob, size=(h, w), mode="bicubic",
                             align_corners=False).permute(0, 2, 3, 1)
        img = img + 0.08 * torch.sin(phase) * torch.sigmoid(3 * blob)
    img = img + 0.01 * torch.randn(img.shape, generator=g, device=device)
    return img.clamp(0.0, 1.0)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    return torch.round(img * 255.0).clamp(0, 255).to(torch.uint8)


def clips(n_clips: int, frames: int, h: int, w: int, g: torch.Generator,
          device, max_speed: int = 3) -> torch.Tensor:
    """``(n_clips·frames, h, w, 3)`` uint8: each clip a camera panning at a
    whole number of pixels a frame (up to ``max_speed`` each way, drawn
    from ``g``) over a larger scene, its frames consecutive."""
    m = max_speed * frames
    canvas = to_u8(scenes(n_clips, h + 2 * m, w + 2 * m, g, device))
    speed = torch.randint(-max_speed, max_speed + 1, (n_clips, 2),
                          generator=g, device=device).tolist()
    out = torch.empty((n_clips, frames, h, w, 3), dtype=torch.uint8,
                      device=device)
    for c, (vy, vx) in enumerate(speed):
        y0 = m - vy * (frames // 2)
        x0 = m - vx * (frames // 2)
        for t in range(frames):
            y, x = y0 + vy * t, x0 + vx * t
            out[c, t] = canvas[c, y:y + h, x:x + w]
    return out.view(n_clips * frames, h, w, 3)
