"""The system under test: the port's models and serving entry points,
built from a configuration's ``model`` and ``serving`` route.

This is the only module of the benchmark that imports the program
(``sr_torch``), and it imports it inside the functions, so the rest of the
harness, its tests and the reference load without it.
"""

from __future__ import annotations

from srbench import weights


def route(config: dict, variant: str | None = None) -> dict:
    """The serving route: the configuration's ``serving``, with its
    ``control.serving`` overrides for the ``control`` variant."""
    r = dict(config["serving"])
    if variant == "control":
        r.update(config["control"].get("serving", {}))
    return r


def build_model(config: dict, params: dict, stats: dict, device,
                dtype: str):
    """The port's model at ``config`` with the benchmark's weights,
    through the registry and the serving format's loader, in eval mode on
    ``device``."""
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.interop import from_jax_params

    cfg = SRConfig(model_name=config["model"],
                   scale_factor=config["scale_factor"],
                   num_channels=config["num_channels"], dtype=dtype,
                   base_filter=config["base_filter"],
                   num_resblocks=config["num_resblocks"],
                   res_scale=config.get("res_scale", 1.0))
    model = get_spec(config["model"]).make_model(cfg)
    from_jax_params(model, weights.nested(params),
                    weights.nested(stats) if stats else None)
    return model.to(device).eval()


def serving_predict(config: dict, params: dict, stats: dict, device,
                    variant: str | None = None):
    """``sr_torch.infer.make_serving_predict`` on the configured model:
    NHWC float32 in [0, 1] on the device → NHWC output."""
    from sr_torch.infer import make_serving_predict

    r = route(config, variant)
    model = build_model(config, params, stats, device, r["dtype"])
    return make_serving_predict(model, fused=r["fused"],
                                quantize=r["quantize"],
                                calib_headroom=r["calib_headroom"],
                                output_u8=r["output_u8"])


def upscale_call(config: dict, params_path: str, tile: int, device,
                 variant: str | None = None):
    """``img_u8 → sr_u8`` through ``sr_torch.infer.upscale``, the library
    call a user makes, with the configured route."""
    from sr_torch.infer import upscale

    r = route(config, variant)

    def call(img):
        return upscale(img, config["model"], params_path,
                       scale_factor=config["scale_factor"], dtype=r["dtype"],
                       tile=tile, fused=r["fused"], quantize=r["quantize"],
                       output_u8=r["output_u8"],
                       calib_headroom=r["calib_headroom"], device=device)

    return call


def build_kernels() -> float | None:
    """Build the program's CUDA kernels ahead of the rest of set-up, where
    the program offers that step (``sr_torch.kernels._build.build``), and
    time the build alone: tens of seconds on a checkout's first run, next
    to none once ``build/sr_torch_kernels/`` holds the libraries. None
    where the program has no such step."""
    import importlib
    import time

    try:
        build = importlib.import_module("sr_torch.kernels._build").build
    except (ImportError, AttributeError):
        return None
    t0 = time.perf_counter()
    build()
    return time.perf_counter() - t0


def release() -> None:
    """Drop what the program caches between calls (``upscale``'s loaded
    models), so the reference runs on a card the program has left."""
    import sys

    clear = getattr(getattr(sys.modules.get("sr_torch.infer"), "_load", None),
                    "cache_clear", None)
    if clear is not None:
        clear()
