"""Operations and bytes from shapes, and the chip's published peaks.

The benchmark's own copy of the arithmetic; nothing here reads the
program. Peaks are one NVIDIA H100 SXM's data sheet, dense, at its full
700 W: 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM. A roofline
bound is the larger of operations over the peak and bytes over the
bandwidth, each input byte read once and each output byte written once.
"""

from __future__ import annotations

PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12


def conv_ops(b: int, h: int, w: int, k: int, c: int, n: int) -> int:
    """Multiply-adds ×2 of a k×k SAME conv, C → N channels, B·H·W
    outputs."""
    return 2 * b * h * w * k * k * c * n


def model_convs(cfg: dict) -> list[tuple[str, int, int, int, int]]:
    """``(site, k, C, N, resolution factor)`` of every conv of the model's
    exact graph (the published architecture): head, two a residual block,
    body, one a sub-pixel stage, output."""
    f, c, k = cfg["base_filter"], cfg["num_channels"], cfg["kernel_size"]
    out = [("head", cfg["head_kernel_size"], c, f, 1)]
    out += [(f"block{i}.conv{j}", k, f, f, 1)
            for i in range(cfg["num_resblocks"]) for j in (0, 1)]
    out.append(("body", k, f, f, 1))
    res = 1
    for j, r in enumerate(cfg["upsample_factors"]):
        out.append((f"upsample{j}", k, f, f * r * r, res))
        res *= r
    out.append(("out", cfg["out_kernel_size"], f, c, res))
    return out


def model_ops(cfg: dict, b: int, h: int, w: int) -> int:
    """Conv operations of one exact-graph forward on a (b, h, w) LR
    input."""
    return sum(conv_ops(b, h * s, w * s, k, c, n)
               for _, k, c, n, s in model_convs(cfg))


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the chip could take."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES_PER_S)


def resblock_bound_s(shape, es: int = 2) -> float:
    """One fused residual block launch on NHWC ``shape`` (conv 3×3 → ReLU
    → conv 3×3 + skip, C → C, bf16): two convs' operations; the input read
    and the output written once, two 3×3 weights, two f32 biases."""
    b, h, w, c = shape
    ops = 2 * conv_ops(b, h, w, 3, c, c)
    nbytes = 2 * b * h * w * c * es + 2 * 9 * c * c * es + 2 * c * 4
    return bound_s(ops, nbytes, PEAK_OPS["bfloat16"])


def int8_conv_bound_s(x_shape, w_shape, in_es: int = 4,
                      out_es: int = 4) -> float:
    """One fused int8 conv launch: float32 NHWC in (quantized on load),
    int8 HWIO weights, float32 out with per-channel dequantize and bias;
    2·B·H·W·k²·C·N operations at the int8 peak."""
    b, h, w, c = x_shape
    k, _, _, n = w_shape
    ops = conv_ops(b, h, w, k, c, n)
    nbytes = (b * h * w * c * in_es + k * k * c * n + b * h * w * n * out_es
              + 3 * n * 4)
    return bound_s(ops, nbytes, PEAK_OPS["int8"])


def d2s_bound_s(x_shape, es: int, bias: bool) -> float:
    """One pixel-shuffle launch: the input read, the output (the same
    count of elements) written, and the bias read."""
    numel = 1
    for d in x_shape:
        numel *= d
    nbytes = 2 * numel * es + (x_shape[-1] * es if bias else 0)
    return nbytes / PEAK_BYTES_PER_S


def mfu_pct(ctx) -> float | None:
    """The model's exact-graph conv operations of every LR shape served in
    the window (``ctx.window["lr_shapes"]``), over the window's length,
    over the dense peak of the route's compute type, in percent."""
    shapes = ctx.window.get("lr_shapes")
    route = ctx.config["serving"]
    peak = PEAK_OPS.get("int8" if route["quantize"] else route["dtype"])
    if not shapes or peak is None or ctx.window["window_s"] <= 0:
        return None
    ops = sum(model_ops(ctx.config, *s) for s in shapes)
    return 100.0 * ops / ctx.window["window_s"] / peak
