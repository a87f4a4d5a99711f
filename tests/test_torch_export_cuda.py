"""On the card: each operator's CUDA implementation inside an exported
program at a symbolic batch, against its plain version, and programs
exported on the CPU moved to the card (``move_to_device_pass``) against
programs exported there. These tests need an NVIDIA GPU and skip without
one; the file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_export_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sr_torch.kernels import ops
from sr_torch.kernels.fused_resblock import pack_wgmma_weights, pack_weights
from sr_torch.kernels.int8_conv import pack_weights as pack_conv

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self._fn = (fn,)

    def forward(self, x):
        return self._fn[0](x)


def _export(fn, example):
    return torch.export.export(
        _Call(fn), (example,),
        dynamic_shapes=({0: torch.export.Dim("b", min=1)},), strict=False)


def _cases(dev):
    """(name, fn over a f32 NHWC batch, its plain version, per-sample
    shape, tolerance, the wrapper whose count a launch raises)."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g)

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        bias = randn(256).to(dtype)
        out.append((f"d2s {dtype}",
                    lambda x, d=dtype, b=bias: ops.depth_to_space(
                        x.to(d), 2, None, b),
                    lambda x, d=dtype, b=bias: ops.depth_to_space_plain(
                        x.to(d), 2, None, b),
                    (9, 11, 256), 0.0, ops.depth_to_space))
    out.append(("d2s u8",
                lambda x: ops.depth_to_space(
                    (x * 40).clamp(0, 255).to(torch.uint8), 4),
                lambda x: ops.depth_to_space_plain(
                    (x * 40).clamp(0, 255).to(torch.uint8), 4),
                (9, 11, 48), 0.0, ops.depth_to_space))
    # the resblock at tests/test_torch_port_cuda.py's scales: inputs in
    # (0, 1), weights of fan-in variance, so outputs stay below 4, where
    # one bf16 ulp is below the 2e-2 tolerance
    w = [randn(64, 64, 3, 3) / 24.0 for _ in range(2)]
    w1, b1, w2, b2 = pack_weights(w[0], randn(64) * 0.1, w[1],
                                  randn(64) * 0.1)
    out.append(("resblock f32",
                lambda x: ops.fused_resblock(x.sigmoid(), w1, b1, w2, b2,
                                             0.5),
                lambda x: ops.fused_resblock_plain(x.sigmoid(), w1, b1, w2,
                                                   b2, 0.5),
                (10, 12, 64), 1e-4, ops.fused_resblock))
    p1 = pack_wgmma_weights(w1.to(torch.bfloat16))
    p2 = pack_wgmma_weights(w2.to(torch.bfloat16))
    out.append(("resblock bf16",
                lambda x: ops.fused_resblock(
                    x.sigmoid().to(torch.bfloat16), p1, b1, p2, b2, 1.0),
                lambda x: ops.fused_resblock_plain(
                    x.sigmoid().to(torch.bfloat16), p1, b1, p2, b2, 1.0),
                (10, 12, 64), 2e-2, ops.fused_resblock))
    q_w = torch.randint(-127, 128, (3, 3, 64, 48), device=dev,
                        generator=g).to(torch.int8)
    out.append(("int8 raw",
                lambda x: ops.conv_int8_im2col(
                    (x * 30).round().clamp(-127, 127).to(torch.int8), q_w),
                lambda x: ops.conv_int8_plain(
                    (x * 30).round().clamp(-127, 127).to(torch.int8), q_w),
                (9, 7, 64), 0.0, ops.conv_int8_im2col))
    w_bf = (randn(3, 3, 64, 48) / 24.0).to(torch.bfloat16)
    out.append(("bf16 raw",
                lambda x: ops.conv_bf16_im2col(x.to(torch.bfloat16), w_bf),
                lambda x: ops.conv_bf16_plain(x.to(torch.bfloat16), w_bf),
                (9, 7, 64), 1e-3, ops.conv_bf16_im2col))
    scale = torch.rand(64, device=dev, generator=g) * 0.05 + 0.01
    dequant = torch.rand(48, device=dev, generator=g) * 1e-3 + 1e-4
    bias = randn(48)
    packed = pack_conv(q_w)
    out.append(("int8 fused",
                lambda x: ops.conv_int8_fused(x, q_w, scale, dequant, bias,
                                              packed=packed),
                lambda x: ops.conv_int8_fused_plain(x, q_w, scale, dequant,
                                                    bias),
                (9, 7, 64), 0.0, ops.conv_int8_fused))
    return out


@pytest.mark.cuda
def test_each_cuda_operator_in_a_program_equals_its_plain_version(cuda):
    """Traced at batch 2, run at batches 1 and 3: the program launches the
    kernel (its count rises by one a call) and equals the plain version
    (exactly, or within the kernel's stated tolerance)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for name, fn, plain, shape, tol, wrapper in _cases(cuda):
        ep = _export(fn, torch.randn((2, *shape), device=cuda, generator=g))
        module = ep.module()
        for b in (1, 3):
            x = torch.randn((b, *shape), device=cuda, generator=g)
            before = wrapper.launches
            with torch.inference_mode():
                got = module(x)
            assert wrapper.launches == before + 1, name
            want = plain(x)
            err = float((got.double() - want.double()).abs().max())
            assert got.dtype == want.dtype and err <= tol, (name, b, err)


def _small_edsr(tmp_path, dtype):
    """EDSR ×4 with 2 blocks × 16 filters (a width the resblock kernel
    takes), seeded weights and small nonzero biases, in the .npz."""
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.interop import to_jax_params

    cfg = SRConfig(model_name="EDSR", num_channels=3, num_resblocks=2,
                   base_filter=16, dtype=dtype)
    model = get_spec("EDSR").make_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.02)
        model.out_conv.Conv_0.bias.add_(0.5)
    path = str(tmp_path / "EDSR_params.npz")
    save_params(path, to_jax_params(model))
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bf16 exact", "bf16 fused",
                                   "int8 static fused"])
def test_a_cpu_program_moved_to_the_card_equals_a_card_program(
        cuda, tmp_path, route):
    """``load_bundle(device='cuda')`` moves a program exported on the CPU:
    its constants (the packed ``wgmma`` and int8 operands among them) and
    its device arguments. It then launches the kernels at batches 1 and 3.
    bf16 exact carries the same constants either way and equals the
    program exported on the card bit for bit; the fused tail's composite
    is probed on the export's device (f32 sums in another order), within
    1 u8 level of it; static int8 calibrates on the export's device, so
    the moved program equals its own CPU run bit for bit (the int8 kernel
    equals its plain passes) instead."""
    from sr_torch import export as ex
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.kernels.int8_conv import conv_int8_fused
    from sr_torch.quant import to_u8

    int8 = route.startswith("int8")
    dtype = "float32" if int8 else "bfloat16"
    path = _small_edsr(tmp_path, dtype)
    kw = dict(dtype=dtype, fused="fused" in route, lr_sizes=(16,),
              cfg_overrides={"num_resblocks": 2, "base_filter": 16},
              quantize="static" if int8 else False,
              calib_input=np.random.default_rng(0).uniform(
                  0, 1, (1, 16, 16, 3)).astype(np.float32))
    arts = {}
    for dev in ("cpu", "cuda"):
        meta, programs = ex.export_bundle("EDSR", path, device=dev, **kw)
        arts[dev] = str(tmp_path / f"{dev}.srtbundle")
        ex.save_bundle(arts[dev], meta, programs)
    moved = ex.load_bundle(arts["cpu"], device="cuda")[1][0][2]
    native = ex.load_bundle(arts["cuda"], device="cuda")[1][0][2]
    on_cpu = ex.load_bundle(arts["cpu"], device="cpu")[1][0][2]
    kernels = (depth_to_space, conv_int8_fused if int8 else fused_resblock)
    g = torch.Generator(device=cuda).manual_seed(2)
    for b in (1, 3):
        x = torch.rand((b, 16, 16, 3), device=cuda, generator=g)
        before = [k.launches for k in kernels]
        got = moved(x)
        assert all(k.launches > n for k, n in zip(kernels, before)), route
        assert got.device.type == "cuda" and got.shape == (b, 64, 64, 3)
        if route == "bf16 exact":
            assert torch.equal(got, native(x))
        elif int8:
            assert torch.equal(got.cpu(), on_cpu(x.cpu()))
        else:
            diff = (to_u8(got).int() - to_u8(native(x)).int()).abs()
            assert int(diff.max()) <= 1, route
