"""Output megapixels of every batch whose uint8 frames landed on the host
in the window, over the window's length (first dispatch to last
landing), by the host's clock."""


def read(ctx):
    w = ctx.window
    if not w.get("out_pixels") or w["window_s"] <= 0:
        return None
    return w["out_pixels"] / 1e6 / w["window_s"]
