"""Tiled and sharded large-image inference (port of ``sr/eval/tiling.py``).

* :func:`tiled_predict`: split the LR image into overlapping tiles (halo =
  the network's receptive field), run the tiles in batches of at most
  ``max_tiles_per_call``, crop the halos from the outputs and stitch.
  Activation memory is bounded by the batch, whatever the image's area,
  and the result equals the full-image forward when ``halo ≥`` the
  receptive field. ``fixed_chunk`` pads every call to exactly
  ``max_tiles_per_call`` tiles, so the eval harness's shape-bucketed route
  runs a mixed-size set at one batch shape.
* :func:`sharded_predict`: the image's rows split over the processes of
  the mesh's ``spatial`` axis, one band each with a halo, assembled on
  every process by one ``all_reduce``: the whole-image forward, as GSPMD's
  halo exchange gives it in the JAX package. The port runs no jit, so
  nothing is cached per function.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

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


def row_bands(h: int, n: int, halo: int) -> list[tuple[int, int, int, int]]:
    """``n`` bands of an ``h``-row image: ``(y0, y1, sy, ey)``, the band's
    rows ``[y0, y1)`` (sizes within one of each other) and its window
    ``[sy, ey)``, the band with ``halo`` rows each side, clamped to the
    image as :func:`tiled_predict`'s windows are."""
    if h < n:
        raise ValueError(f"{h} rows cannot split into {n} bands")
    out = []
    for i in range(n):
        y0, y1 = i * h // n, (i + 1) * h // n
        out.append((y0, y1, max(y0 - halo, 0), min(y1 + halo, h)))
    return out


def sharded_predict(predict_fn, x: torch.Tensor, mesh=None,
                    axis: str = "spatial",
                    halo: int = max(RECEPTIVE_FIELD.values())
                    ) -> torch.Tensor:
    """Whole-image forward with the rows of NHWC ``x`` split over ``axis``
    of ``mesh`` (default: the process group as a 1-D mesh, whose every
    process then takes a band).

    Every process holds ``x`` and runs ``predict_fn`` on its band's window
    (:func:`row_bands`), crops the halo's output rows, and writes its band
    into a zeroed full-size output; one ``all_reduce`` sums the bands on
    every process. Processes off the mesh's first ``data`` row (a ``(D,
    S)`` mesh repeats the bands D times) add zeros. With ``halo ≥`` the
    model's receptive field (``RECEPTIVE_FIELD``, in the input's pixels)
    every output row sees what the whole-image forward's does. Without a
    process group, or with one band, it is ``predict_fn(x)``."""
    from sr_torch.parallel.mesh import make_mesh

    mesh = mesh if mesh is not None else make_mesh()
    if axis in mesh.axes:
        n, band = mesh.axis_size(axis), mesh.axis_index(axis)
        writer = all(mesh.axis_index(a) == 0 for a in mesh.axes if a != axis)
    else:
        n, band, writer = mesh.world, mesh.rank, True
    if not mesh.distributed or n == 1:
        return predict_fn(x)
    h = x.shape[1]
    y0, y1, sy, ey = row_bands(h, n, halo)[band]
    out = predict_fn(x[:, sy:ey])
    r = out.shape[1] // (ey - sy)
    if out.shape[1] != r * (ey - sy):
        raise ValueError(f"predict_fn maps {ey - sy} rows to {out.shape[1]}, "
                         "not a whole multiple")
    # summed in a type every backend adds (bf16 and u8 widen exactly)
    wide = (out.dtype if out.dtype in (torch.float32, torch.float64,
                                       torch.int32, torch.int64)
            else torch.float32 if out.is_floating_point() else torch.int32)
    full = out.new_zeros((out.shape[0], h * r, *out.shape[2:]), dtype=wide)
    if writer:
        full[:, y0 * r:y1 * r] = out[:, (y0 - sy) * r:(y1 - sy) * r]
    dist.all_reduce(full)
    return full.to(out.dtype)
