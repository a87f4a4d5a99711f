"""Ahead-of-time serving export: ``torch.export`` artifacts.

Port of ``sr/export.py``. A trained model's serving predict (any route of
``sr_torch.infer.make_serving_predict``: exact or fused tail, float or int8,
the u8 output, a pyramid level, the D4 self-ensemble) is traced once by
``torch.export`` into an ``ExportedProgram`` and saved. The program reloads
WITHOUT the model code: loading imports ``torch`` and the operator library
``sr_torch/kernels/ops.py``, whose ``torch.ops.sr_torch.*`` operators the
program calls, and nothing of ``sr_torch.models`` or ``sr_torch.nn``.

* The batch dimension is symbolic by default (``torch.export.Dim``): one
  program serves any batch. The trace runs at batch 2, since PyTorch
  specializes a dimension of size 1. ``symbolic_batch=False`` exports batch
  1 and the program refuses any other.
* Spatial sizes are static by design: a server picks the smallest of a few
  bucket sizes that holds a request, pads and crops (a multi-bucket
  *bundle*, :func:`export_bundle`).
* The JAX package's ``platforms`` is ``device`` here. Each operator carries
  a CPU and a CUDA implementation, so :func:`load_bundle` moves a program to
  the device it is asked for (``torch.export.passes.move_to_device_pass``):
  a program exported on the CPU serves on the card.
* Weights, the resblock kernel's packed ``wgmma`` operands, the int8 sites'
  quantized and packed weights and scales and a fused tail's composite are
  constants of the program: they are built before the trace (a warm-up
  call, and the static-int8 calibration on concrete batches), so no
  repacking runs per call.

    from sr_torch.export import export_predict, save_artifact, load_artifact
    ep = export_predict("EDSR", "EDSR_params.npz", lr_size=128, fused=True)
    save_artifact("edsr_x4.pt2", ep)
    ...
    fn = load_artifact("edsr_x4.pt2")    # no sr_torch.models import needed
    sr_batch = fn(lr_batch)              # (b, 128, 128, 3) -> (b, 512, ...)

A bundle keeps the JAX package's layout and header keys (magic, an 8-byte
big-endian header length, a JSON header, the concatenated payloads, each a
``torch.export.save`` of one bucket's program) under a magic of its own, so
neither package takes the other's file for a legacy single artifact.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from sr_torch.utils.device import resolve_device

_BUNDLE_MAGIC = b"SRTORCHBUNDLE1\n"
_JAX_BUNDLE_MAGIC = b"SRBUNDLE1\n"  # sr/export.py's bundles


def _build_predict(model_name: str, params_path: str, scale_factor: int,
                   num_channels: int | None, dtype: str, fused: bool,
                   cfg_overrides: dict | None = None,
                   quantize: bool | str = False,
                   calib_headroom: float = 1.0,
                   output_u8: bool = False,
                   calib_batches=None,
                   trained_scale: int | None = None,
                   device: torch.device = torch.device("cpu")):
    from sr_torch.infer import make_pyramid_level_predict, make_serving_predict
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.checkpoint import load_params
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.interop import from_jax_params

    spec = get_spec(model_name)
    channels = num_channels or spec.default_channels
    # a pyramid checkpoint trained at trained_scale serves scale_factor
    # from its intermediate level: the topology builds at the trained scale
    build_scale = (trained_scale
                   if trained_scale and trained_scale != scale_factor
                   else scale_factor)
    cfg = SRConfig(model_name=model_name, scale_factor=build_scale,
                   num_channels=channels, dtype=dtype,
                   **(cfg_overrides or {}))
    model = spec.make_model(cfg)
    params, batch_stats = load_params(params_path)
    from_jax_params(model, params, batch_stats)
    # serving needs no gradients: the weights enter the program as
    # constants that track none
    model = model.to(device).eval().requires_grad_(False)
    if build_scale != scale_factor:
        if quantize:
            raise ValueError(
                "net_scale serves the exact pyramid graph; it does not "
                "compose with --quantize (the int8 rewrites target the "
                "final single-output tail)")
        # fused is a hint: a pyramid level exports its exact graph
        return (make_pyramid_level_predict(model, spec, build_scale,
                                           scale_factor,
                                           output_u8=output_u8),
                channels)
    return (make_serving_predict(model, fused, quantize,
                                 calib_headroom=calib_headroom,
                                 output_u8=output_u8,
                                 calib_batches=calib_batches),
            channels)


def _expand_calib_d4(calib_list):
    """All 8 D4 variants of every calibration batch: an ensemble program
    runs the base net on transformed inputs, so its static calibration has
    to cover the transformed ranges."""
    from sr_torch.eval.ensemble import TRANSFORMS, transform

    return [transform(b, f, k) for b in calib_list for f, k in TRANSFORMS]


def _warm_static(predict, calib_list, h, w, channels, self_ensemble,
                 device):
    """Run the lazy static-int8 calibration on concrete batches before the
    trace, so the scales are constants of the program.

    With a calibration corpus the predict was built calibrated (or
    calibrates on its stored corpus), and ``calib_list`` is only the
    trigger. Without one: seeded uniform noise at the smallest bucket with
    the 1.25× headroom, D4-expanded for an ensemble program."""
    if calib_list is None:
        gen = torch.Generator().manual_seed(0)
        calib_list = [torch.rand((1, h, w, channels), generator=gen)
                      .to(device)]
        if self_ensemble:
            calib_list = _expand_calib_d4(calib_list)
    if hasattr(predict, "calibrate"):
        predict.calibrate(calib_list)
    else:
        predict(calib_list[0])


def _prep_export(model_name, params_path, scale_factor, num_channels,
                 dtype, fused, cfg_overrides, quantize, calib_input,
                 output_u8, self_ensemble, trained_scale, device):
    """Shared preamble of :func:`export_predict` and :func:`export_bundle`:
    the calibration batches and their D4 expansion, the headroom rule and
    the predict, in one place so the two paths cannot drift."""
    calib_list = None
    if calib_input is not None:
        batches = (calib_input if isinstance(calib_input, (list, tuple))
                   else [calib_input])
        calib_list = [torch.as_tensor(np.asarray(b, np.float32),
                                      device=device) for b in batches]
    if self_ensemble and calib_list is not None:
        calib_list = _expand_calib_d4(calib_list)
    predict, channels = _build_predict(
        model_name, params_path, scale_factor, num_channels, dtype, fused,
        cfg_overrides, quantize,
        calib_headroom=1.0 if calib_input is not None else 1.25,
        # ensemble members stay float: the wrapper averages in f32 and
        # quantizes once at the end (sr_torch.infer does the same)
        output_u8=output_u8 and not self_ensemble,
        calib_batches=calib_list, trained_scale=trained_scale,
        device=device)
    return predict, channels, calib_list


class _Predict(torch.nn.Module):
    """``torch.export`` takes a module: this one calls ``fn``, kept out of
    the module's attributes (``fn`` may be the model itself). So the
    model's weights and what it caches from them enter the program as
    constants; as the module's parameters they would be fake while
    traced, and the packing cached from them would be traced anew."""

    def __init__(self, fn):
        super().__init__()
        self._call = (fn,)

    def forward(self, x):
        return self._call[0](x)


def _lower(predict, h, w, channels, symbolic_batch, device):
    """Trace a predict at one spatial size into an ``ExportedProgram``
    (shared by :func:`export_predict` and every bundle bucket). A warm-up
    call at batch 1 first builds whatever the predict caches (the
    resblock's packed operands), so the trace finds them as constants."""
    with torch.no_grad():
        predict(torch.zeros((1, h, w, channels), device=device))
        example = torch.zeros((2 if symbolic_batch else 1, h, w, channels),
                              device=device)
        dims = (({0: torch.export.Dim("b", min=1)},) if symbolic_batch
                else None)
        return torch.export.export(_Predict(predict), (example,),
                                   dynamic_shapes=dims, strict=False)


def export_predict(
    model_name: str,
    params_path: str,
    scale_factor: int = 4,
    num_channels: int | None = None,
    dtype: str = "bfloat16",
    fused: bool = False,
    lr_size: int | tuple[int, int] = 128,
    symbolic_batch: bool = True,
    device: str | torch.device = "cuda",
    cfg_overrides: dict | None = None,
    quantize: bool | str = False,
    calib_input=None,
    output_u8: bool = False,
    self_ensemble: bool = False,
    trained_scale: int | None = None,
) -> torch.export.ExportedProgram:
    """Trace a trained model's predict into an ``ExportedProgram``.

    ``trained_scale``: pyramid models (LapSRN), the scale the checkpoint
    was trained at when exporting one of its intermediate levels as a
    ×``scale_factor`` artifact (exact graph only). ``quantize``: int8 convs
    (``sr_torch.quant``), the program then carries int8 weights;
    ``"static"`` bakes calibrated activation scales in as constants.
    ``calib_input``: a representative (1, h, w, C) float32 batch, or a list
    of them (corpus calibration, recommended), for static calibration;
    None calibrates on seeded uniform noise with 1.25× headroom.
    ``lr_size``: the static LR input size the artifact serves (pre-upsample
    models take the bicubic-upscaled input: pass the HR size).
    ``device``: where the model runs while it is traced, and the program's
    device (:func:`load_bundle` moves it). ``self_ensemble``: trace the D4
    self-ensemble's 8 members and their f32 average into the program;
    static calibration then covers all 8 variants.
    """
    device = resolve_device(device)
    predict, channels, calib_list = _prep_export(
        model_name, params_path, scale_factor, num_channels, dtype, fused,
        cfg_overrides, quantize, calib_input, output_u8, self_ensemble,
        trained_scale, device)
    h, w = (lr_size, lr_size) if isinstance(lr_size, int) else lr_size
    if quantize == "static":
        _warm_static(predict, calib_list, h, w, channels, self_ensemble,
                     device)
    if self_ensemble:
        from sr_torch.eval.ensemble import make_self_ensemble_predict

        predict = make_self_ensemble_predict(predict, output_u8=output_u8,
                                             fuse=True)
    return _lower(predict, h, w, channels, symbolic_batch, device)


def _program_bytes(ep: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_artifact(path: str, ep: torch.export.ExportedProgram) -> None:
    """Write one program as a self-contained artifact (a legacy single
    artifact: no header, conventions from the server's flags)."""
    with open(path, "wb") as f:
        f.write(_program_bytes(ep))


# ---------------------------------------------------------------------------
# Multi-bucket bundles: N input sizes + embedded metadata in one file
# ---------------------------------------------------------------------------


def program_io(ep: torch.export.ExportedProgram):
    """The fake values of a program's image input and its output: shape
    (batch symbolic unless the export was static), dtype, device."""
    name = ep.graph_signature.user_inputs[0]
    x = next(n for n in ep.graph.nodes
             if n.op == "placeholder" and n.name == name)
    out = next(n for n in ep.graph.nodes if n.op == "output").args[0][0]
    return x.meta["val"], out.meta["val"]


def export_bundle(
    model_name: str,
    params_path: str,
    scale_factor: int = 4,
    num_channels: int | None = None,
    dtype: str = "bfloat16",
    fused: bool = False,
    lr_sizes: tuple = (64, 128, 256),
    symbolic_batch: bool = True,
    device: str | torch.device = "cuda",
    cfg_overrides: dict | None = None,
    quantize: bool | str = False,
    calib_input=None,
    output_u8: bool = False,
    self_ensemble: bool = False,
    trained_scale: int | None = None,
):
    """One program per input size plus the metadata a server needs.

    The server picks the smallest bucket that holds a request, pads and
    crops. The header records the training ``scale_factor``, so the server
    cannot be flagged into the wrong pre-upsample factor, and
    ``self_ensemble``, so it reports a baked ensemble. The static scales
    are calibrated once, at the smallest bucket, and shared. Returns
    ``(meta, programs)`` for :func:`save_bundle`.
    """
    device = resolve_device(device)
    predict, channels, calib_list = _prep_export(
        model_name, params_path, scale_factor, num_channels, dtype, fused,
        cfg_overrides, quantize, calib_input, output_u8, self_ensemble,
        trained_scale, device)
    # every size as an (h, w) tuple before sorting: ints and tuples mix
    sizes = sorted({(s, s) if isinstance(s, int) else tuple(s)
                    for s in lr_sizes})
    programs, buckets = [], []
    for h, w in sizes:
        if quantize == "static" and not programs:
            _warm_static(predict, calib_list, h, w, channels,
                         self_ensemble, device)
        if self_ensemble and not programs:
            from sr_torch.eval.ensemble import make_self_ensemble_predict

            predict = make_self_ensemble_predict(
                predict, output_u8=output_u8, fuse=True)
        programs.append(
            _lower(predict, h, w, channels, symbolic_batch, device))
        buckets.append({"h": h, "w": w})
    x, y = program_io(programs[0])
    meta = {
        "model_name": model_name,
        "scale_factor": scale_factor,
        "num_channels": channels,
        "net_scale": int(y.shape[1]) // int(x.shape[1]),
        "dtype": dtype,
        "fused": fused,
        "output_u8": output_u8,
        "self_ensemble": self_ensemble,
        # provenance: the scale the checkpoint was trained at when this
        # bundle serves a pyramid model's intermediate level
        "trained_scale": trained_scale or scale_factor,
        "buckets": buckets,
    }
    return meta, programs


def save_bundle(path: str, meta: dict, programs: list) -> None:
    """Write magic + header length + JSON header + concatenated
    programs."""
    payloads = [_program_bytes(ep) for ep in programs]
    offset = 0
    header_buckets = []
    for bucket, blob in zip(meta["buckets"], payloads):
        header_buckets.append(
            {**bucket, "offset": offset, "length": len(blob)})
        offset += len(blob)
    header = json.dumps({**meta, "buckets": header_buckets}).encode()
    with open(path, "wb") as f:
        f.write(_BUNDLE_MAGIC)
        f.write(len(header).to_bytes(8, "big"))
        f.write(header)
        for blob in payloads:
            f.write(blob)


def _make_fn(ep: torch.export.ExportedProgram, device: torch.device):
    """``fn(x) -> sr`` for a loaded program, moved to ``device`` when it
    was exported on another: ``x`` an NHWC float32 batch (array or tensor),
    the result a tensor on ``device``. ``fn.program`` is the program;
    ``fn.program_device`` its device; ``fn.in_shape`` / ``fn.out_shape``
    (batch None when symbolic) and ``fn.out_dtype`` describe it."""
    x_val, _ = program_io(ep)
    if x_val.device.type != device.type:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    module = ep.module()

    def fn(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.inference_mode():
            return module(x)

    x_val, y_val = program_io(ep)

    def shape(v):
        return tuple(d if isinstance(d, int) else None for d in v.shape)

    fn.program, fn.program_device = ep, device
    fn.in_shape, fn.out_shape = shape(x_val), shape(y_val)
    fn.out_dtype = y_val.dtype
    return fn


def _load_program(blob: bytes) -> torch.export.ExportedProgram:
    import sr_torch.kernels.ops  # noqa: F401 — registers torch.ops.sr_torch

    return torch.export.load(io.BytesIO(blob))


def load_bundle(path: str, device: str | torch.device = "cuda"):
    """Load a bundle or a legacy single artifact onto ``device``.

    Returns ``(meta, buckets)``: ``meta`` is the embedded dict (None for a
    legacy artifact, whose conventions the caller supplies), ``buckets`` a
    list of ``(h, w, fn)`` sorted by area (see :func:`_make_fn`). No model
    code is imported. A bundle of the JAX package is refused.
    """
    device = resolve_device(device)
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(_JAX_BUNDLE_MAGIC):
        raise ValueError(
            f"{path} is a bundle of the JAX package (sr.export, StableHLO); "
            "sr_torch serves torch.export bundles: re-export it with "
            "python -m sr_torch.export")
    if not blob.startswith(_BUNDLE_MAGIC):
        fn = _make_fn(_load_program(blob), device)
        return None, [(fn.in_shape[1], fn.in_shape[2], fn)]
    n = len(_BUNDLE_MAGIC)
    hlen = int.from_bytes(blob[n:n + 8], "big")
    meta = json.loads(blob[n + 8:n + 8 + hlen].decode())
    base = n + 8 + hlen
    buckets = []
    for b in meta["buckets"]:
        start = base + b["offset"]
        ep = _load_program(blob[start:start + b["length"]])
        buckets.append((b["h"], b["w"], _make_fn(ep, device)))
    buckets.sort(key=lambda t: t[0] * t[1])
    return meta, buckets


def load_artifact(path: str, device: str | torch.device = "cuda"):
    """Load a single artifact and return ``fn(x) -> sr`` (no model code
    needed)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        return _make_fn(_load_program(f.read()), device)


def main(argv: list[str] | None = None) -> None:
    """CLI: python -m sr_torch.export --model_name EDSR --params p.npz
    --out a.pt2"""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_name", required=True)
    p.add_argument("--params", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scale_factor", type=int, default=4)
    p.add_argument("--num_channels", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--fused", action="store_true",
                   help="export the fused/folded fast tail (serving mode)")
    p.add_argument("--lr_size", type=int, nargs="+", default=[128],
                   help="one size → single artifact; several sizes → a "
                        "multi-bucket bundle with embedded metadata")
    p.add_argument("--device", default="cuda",
                   help="device to trace on and of the program (default "
                        "cuda; a loader moves it to its own device)")
    p.add_argument("--num_resblocks", type=int, default=None)
    p.add_argument("--base_filter", type=int, default=None)
    p.add_argument("--res_scale", type=float, default=None,
                   help="EDSR residual scaling: not a parameter, so it "
                        "MUST match training or the artifact diverges")
    p.add_argument("--num_recursions", type=int, default=None)
    p.add_argument("--quantize", nargs="?", const="dynamic", default=False,
                   choices=["dynamic", "static"],
                   help="int8 convs: int8 weights in the artifact; "
                        "'static' bakes calibrated activation scales in "
                        "(bare flag = dynamic)")
    p.add_argument("--output_u8", action="store_true",
                   help="quantize the output to uint8 inside the "
                        "artifact (bit-equal to the host conversion; the "
                        "server detects it from the output dtype)")
    p.add_argument("--self_ensemble", action="store_true",
                   help="bake the D4 geometric self-ensemble into the "
                        "artifact: one program, 8 forwards, f32 average")
    p.add_argument("--net_scale", type=int, default=None,
                   help="pyramid models (LapSRN): the scale the "
                        "checkpoint was trained at; export its "
                        "intermediate x--scale_factor level (exact graph)")
    p.add_argument("--calib_image", nargs="*", default=None,
                   help="image file(s) for --quantize static calibration "
                        "(each resized to the smallest lr_size; several "
                        "files = corpus calibration, recommended; default: "
                        "uniform noise with 1.25x scale headroom)")
    a = p.parse_args(argv)
    overrides = {
        k: v for k, v in
        (("num_resblocks", a.num_resblocks), ("base_filter", a.base_filter),
         ("res_scale", a.res_scale), ("num_recursions", a.num_recursions))
        if v is not None
    }
    calib = None
    if a.calib_image:
        from PIL import Image

        from sr_torch.models.registry import get_spec

        c = a.num_channels or get_spec(a.model_name).default_channels
        side = min(a.lr_size)
        calib = []
        for path in a.calib_image:
            im = Image.open(path).convert("L" if c == 1 else "RGB")
            im = im.resize((side, side), Image.BICUBIC)
            calib.append((np.asarray(im, np.float32) / 255.0).reshape(
                1, side, side, c))
    common = dict(cfg_overrides=overrides or None, quantize=a.quantize,
                  calib_input=calib, output_u8=a.output_u8,
                  self_ensemble=a.self_ensemble, trained_scale=a.net_scale,
                  device=a.device)
    if len(a.lr_size) > 1:
        meta, programs = export_bundle(
            a.model_name, a.params, a.scale_factor, a.num_channels, a.dtype,
            a.fused, lr_sizes=tuple(a.lr_size), **common)
        save_bundle(a.out, meta, programs)
        print(f"exported {a.model_name} bundle -> {a.out} "
              f"(buckets {meta['buckets']}, x{meta['scale_factor']})")
        return
    ep = export_predict(
        a.model_name, a.params, a.scale_factor, a.num_channels, a.dtype,
        a.fused, a.lr_size[0], **common)
    save_artifact(a.out, ep)
    x, _ = program_io(ep)
    print(f"exported {a.model_name} -> {a.out} "
          f"(input {tuple(x.shape)}, device {x.device})")


if __name__ == "__main__":
    main()
