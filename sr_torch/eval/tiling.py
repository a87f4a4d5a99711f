"""Tiled large-image inference (port of ``sr/eval/tiling.py:tiled_predict``).

Split the LR image into overlapping tiles (halo = the network's receptive
field), run the tiles in batches of at most ``max_tiles_per_call``, crop the
halos from the outputs and stitch. Activation memory is bounded by the
batch, whatever the image's area, and the result equals the full-image
forward when ``halo ≥`` the receptive field. ``fixed_chunk`` pads every
call to exactly ``max_tiles_per_call`` tiles, so the eval harness's
shape-bucketed route runs a mixed-size set at one batch shape.
``sharded_predict`` (rows across devices) lands with the multi-GPU slice.
"""

from __future__ import annotations

import math

import torch

#: conservative per-model LR-space receptive-field half-widths
RECEPTIVE_FIELD = {
    "srcnn": 8,       # (9+5+5-3)//2
    "espcn": 5,       # (5+3+3-3)//2
    "fsrcnn": 12,
    "vdsr": 20,       # 20 3×3 convs
    "drcn": 22,
    "edsr": 40,       # 16 resblocks ×2 convs + head/tail
    "srresnet": 44,
    "srgan": 44,
    "lapsrn": 32,
}


def tiled_predict(predict_fn, x: torch.Tensor, scale_factor: int,
                  tile: int = 128, halo: int = 32,
                  max_tiles_per_call: int = 16,
                  fixed_chunk: bool = False) -> torch.Tensor:
    """Run ``predict_fn`` over overlapping tiles of NHWC ``x`` and stitch.

    ``x``: (1, H, W, C) LR input. All tiles share one window shape; every
    call carries at most ``max_tiles_per_call`` tiles, the last chunk
    padded by repeating its final tile. Windows are clamped to the image,
    never padded, so an output pixel's receptive field either lies inside
    the window or meets the true image edge where the window does — the
    network's own SAME padding then applies as in the full forward.

    ``fixed_chunk``: pad EVERY call to exactly ``max_tiles_per_call``
    tiles, so images with different tile counts share one batch shape. An
    image that fits one window still runs whole, at batch 1, as in the JAX
    package.
    """
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"tiled_predict takes batch 1 NHWC, got {tuple(x.shape)}")
    _, h, w, _ = x.shape
    r = scale_factor
    win_h = min(tile + 2 * halo, h)
    win_w = min(tile + 2 * halo, w)
    if h <= win_h and w <= win_w:
        return predict_fn(x)

    ny, nx = math.ceil(h / tile), math.ceil(w / tile)
    slices, crops = [], []
    for iy in range(ny):
        y0 = iy * tile
        y1 = min(y0 + tile, h)
        sy = min(max(y0 - halo, 0), h - win_h)
        for ix in range(nx):
            x0 = ix * tile
            x1 = min(x0 + tile, w)
            sx = min(max(x0 - halo, 0), w - win_w)
            slices.append((sy, sx))
            crops.append((y0 - sy, x0 - sx, y1 - y0, x1 - x0))

    n = len(slices)
    chunk = (max_tiles_per_call if fixed_chunk
             else max(1, min(max_tiles_per_call, n)))
    outs = []
    for start in range(0, n, chunk):
        group = slices[start:start + chunk]
        tiles = [x[:, sy:sy + win_h, sx:sx + win_w] for sy, sx in group]
        tiles.extend([tiles[-1]] * (chunk - len(group)))
        out = predict_fn(torch.cat(tiles, dim=0))
        outs.extend(out[i] for i in range(len(group)))

    rows = []
    for iy in range(ny):
        row = []
        for ix in range(nx):
            oy, ox, th, tw = crops[iy * nx + ix]
            row.append(outs[iy * nx + ix][oy * r:(oy + th) * r,
                                          ox * r:(ox + tw) * r, :])
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)[None]
