"""sr_torch's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (Hopper) and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from sr_torch.kernels.depth_to_space import (
    depth_to_space, depth_to_space_plain)
from sr_torch.kernels.fused_resblock import (
    fused_resblock, fused_resblock_plain, pack_wgmma_weights, wgmma_matmul)
from sr_torch.kernels.int8_conv import (
    conv_bf16_im2col, conv_bf16_plain, conv_int8_fused, conv_int8_fused_plain,
    conv_int8_im2col, conv_int8_plain, pack_weights)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def _d2s_operands(shape, r, dtype, gen, device, with_bias):
    b, h, w, c = shape
    cin = c * r * r
    if dtype == torch.uint8:
        x = torch.randint(0, 256, (b, h, w, cin), device=device,
                          generator=gen).to(dtype)
    else:
        x = torch.randn((b, h, w, cin), device=device, generator=gen).to(dtype)
    bias = (torch.randn(cin, device=device, generator=gen).to(dtype)
            if with_bias else None)
    return x, bias


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(2, 5, 7, 16), (1, 3, 300, 16),
                                     (2, 4, 9, 3), (1, 2, 7, 3),
                                     (1, 2, 1100, 3)])
def test_depth_to_space_kernel_matches_plain(cuda, b, h, w, c):
    """Exact, with and without bias, f32/bf16/u8 (no bias for u8),
    r in {2, 3, 4, 8}. (1, 3, 300, 16) and (1, 2, 1100, 3): rows longer
    than one staged 16 KB segment; C=3 and odd W: output runs that are not
    whole 16-byte vectors and start off a 16-byte boundary."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        for r in (2, 3, 4, 8):
            for act in (None, "relu"):
                for with_bias in (False, True):
                    if dtype == torch.uint8 and with_bias:
                        continue
                    x, bias = _d2s_operands((b, h, w, c), r, dtype, gen,
                                            cuda, with_bias)
                    before = depth_to_space.launches
                    got = depth_to_space(x, r, act, bias)
                    assert depth_to_space.launches == before + 1
                    assert torch.equal(got, depth_to_space_plain(x, r, act,
                                                                 bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_depth_to_space_kernel_takes_unaligned_input(cuda, dtype):
    """A contiguous slice one element into its storage (4, 2 or 1 bytes
    past a 16-byte boundary) and a bias slice just as far in: the staged
    load's ragged head and tail and the bias's scalar path. Exact."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for r, (b, h, w, c) in ((2, (2, 3, 40, 16)), (4, (1, 3, 9, 3)),
                            (3, (1, 2, 7, 3))):
        shape = (b, h, w, c * r * r)
        flat, _ = _d2s_operands((1, 1, 1, b * h * w * c * r * r + 1), 1,
                                dtype, gen, cuda, False)
        x = flat.reshape(-1)[1:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        biases = [None]
        if dtype != torch.uint8:
            b_flat = torch.randn(c * r * r + 1, device=cuda,
                                 generator=gen).to(dtype)
            biases.append(b_flat[1:])
        for bias in biases:
            for act in (None, "relu"):
                assert torch.equal(depth_to_space(x, r, act, bias),
                                   depth_to_space_plain(x, r, act, bias))


@pytest.mark.cuda
def test_depth_to_space_kernel_takes_the_largest_pixel(cuda):
    """One LR pixel of 64 KiB, the kernel's limit: above 48 KB of dynamic
    shared memory a block, which the launch has to ask for. Exact."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, bias = _d2s_operands((1, 2, 3, 8192), 2, torch.bfloat16, gen, cuda,
                            True)
    assert x.shape[-1] * x.element_size() == 2 ** 16
    assert torch.equal(depth_to_space(x, 2, None, bias),
                       depth_to_space_plain(x, 2, None, bias))


@pytest.mark.cuda
def test_depth_to_space_kernel_refuses_a_u8_bias(cuda):
    x = torch.zeros((1, 2, 2, 4), dtype=torch.uint8, device=cuda)
    before = depth_to_space.launches
    with pytest.raises(ValueError, match="no bias for uint8"):
        depth_to_space(x, 2, bias=torch.zeros(4, dtype=torch.uint8,
                                              device=cuda))
    assert depth_to_space.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 2 ** 28, 4), (2 ** 31, 1, 1, 4),
                                   (1, 1, 1, 2 ** 15 + 4)])
def test_depth_to_space_kernel_refuses_oversize(cuda, shape):
    """At r=2 in bf16: 131072 staged segments in one row (the grid's y
    takes 65535), 2^31 input rows (its x takes 2^31 - 1), and one LR pixel
    of 65544 bytes (the staged tile takes 64 KiB). Uninitialised, 2 GiB,
    16 GiB and 64 KiB."""
    x = torch.empty(shape, dtype=torch.bfloat16, device=cuda)
    before = depth_to_space.launches
    with pytest.raises(ValueError, match="fewer than 2"):
        depth_to_space(x, 2)
    assert depth_to_space.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 32, 48, 64])
def test_fused_resblock_kernel_matches_plain(cuda, c):
    """f32: 1e-4 (summation order over K=9C); bf16: 2e-2 (one bf16 ulp
    at outputs below 4)."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.rand((2, 37, 53, c), device=cuda, generator=gen).to(dtype)
        w1, w2 = ((torch.randn(9 * c, c, device=cuda, generator=gen)
                   / (9 * c) ** 0.5).to(dtype) for _ in range(2))
        b1, b2 = (torch.randn(c, device=cuda, generator=gen) * 0.1
                  for _ in range(2))
        # bf16 launches take the wgmma layout, as ResnetBlock.packed()
        # caches it; the plain version takes the (9C, C) operands
        k1, k2 = ((pack_wgmma_weights(w1), pack_wgmma_weights(w2))
                  if dtype == torch.bfloat16 else (w1, w2))
        for rs in (1.0, 0.1):
            got = fused_resblock(x, k1, b1, k2, b2, rs)
            want = fused_resblock_plain(x, w1, b1, w2, b2, rs)
            assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_wgmma_matmul_matches_plain(cuda):
    """One 64x64x64 product through the resblock kernel's ldmatrix,
    descriptor and wgmma helpers: exact bf16 products summed in f32 in
    another order, 1e-4 at outputs of magnitude ~1."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    a, b = (torch.randn((64, 64), device=cuda, generator=gen)
            .div(8).to(torch.bfloat16) for _ in range(2))
    got = wgmma_matmul(a, b)
    want = a.float() @ b.float()
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_fused_resblock_bf16_is_one_launch(cuda):
    """The bf16 block is one kernel launch: no scratch tensor, no second
    conv kernel (torch.profiler counts the device kernels)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(3)
    c = 64
    x = torch.rand((2, 37, 53, c), device=cuda, generator=gen).bfloat16()
    w1, w2 = ((torch.randn(9 * c, c, device=cuda, generator=gen)
               / (9 * c) ** 0.5).bfloat16() for _ in range(2))
    b1, b2 = (torch.zeros(c, device=cuda) for _ in range(2))
    k1, k2 = pack_wgmma_weights(w1), pack_wgmma_weights(w2)
    torch.cuda.synchronize()
    before = fused_resblock.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_resblock(x, k1, b1, k2, b2)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type.name == "CUDA"]
    assert fused_resblock.launches == before + 1
    assert len(kernels) == 1 and "resblock_bf16" in kernels[0], kernels


@pytest.mark.cuda
def test_fused_resblock_kernel_rejects_unsupported(cuda):
    x = torch.zeros((1, 8, 8, 24), device=cuda)
    w = torch.zeros((9 * 24, 24), device=cuda)
    b = torch.zeros(24, device=cuda)
    with pytest.raises(ValueError, match="C in"):
        fused_resblock(x, w, b, w, b)
    # bf16 launches take only the wgmma layout, never (9C, C) operands
    x = torch.zeros((1, 8, 8, 64), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((9 * 64, 64), device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(64, device=cuda)
    before = fused_resblock.launches
    with pytest.raises(ValueError, match="pack_wgmma_weights"):
        fused_resblock(x, w, b, w, b)
    assert fused_resblock.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,n,k", [
    (2, 5, 7, 3, 64, 3),     # EDSR's head: C=3, one K step
    (2, 17, 9, 64, 64, 3),   # body: ragged tiles in H and W
    (2, 17, 9, 64, 256, 3),  # PS conv: four N tiles
    (2, 16, 16, 64, 3, 3),   # out conv: N=3
    (2, 13, 11, 64, 48, 7),  # the fused-quant tail's composite conv
    (1, 9, 20, 3, 3, 5),     # C=3 and N=3 together, k=5
    (1, 6, 6, 40, 10, 1),    # k=1, C not a whole chunk
])
def test_int8_conv_kernel_matches_plain(cuda, b, h, w, c, n, k):
    """Exact: int32 accumulation of int8 products."""
    gen = torch.Generator(device=cuda).manual_seed(k * 1000 + c + n)
    q_x = torch.randint(-127, 128, (b, h, w, c), device=cuda,
                        generator=gen).to(torch.int8)
    q_w = torch.randint(-127, 128, (k, k, c, n), device=cuda,
                        generator=gen).to(torch.int8)
    before = conv_int8_im2col.launches
    got = conv_int8_im2col(q_x, q_w)
    assert conv_int8_im2col.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (b, h, w, n)
    assert torch.equal(got, conv_int8_plain(q_x, q_w))


@pytest.mark.cuda
def test_int8_conv_kernel_saturated_inputs_exact(cuda):
    """±127 everywhere at C=64: the accumulator reaches 9·64·127²."""
    q_x = torch.full((1, 8, 8, 64), 127, dtype=torch.int8, device=cuda)
    q_w = torch.full((3, 3, 64, 16), -127, dtype=torch.int8, device=cuda)
    got = conv_int8_im2col(q_x, q_w)
    assert int(got.min()) == -9 * 64 * 127 * 127
    assert torch.equal(got, conv_int8_plain(q_x, q_w))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,k", [(64, 64, 3), (3, 64, 3), (64, 48, 7)])
def test_bf16_conv_kernel_matches_plain(cuda, c, n, k):
    """Exact bf16 products summed in f32 in another order: 1e-3 at
    outputs of magnitude ~10."""
    gen = torch.Generator(device=cuda).manual_seed(c + n + k)
    x = torch.randn((2, 13, 11, c), device=cuda,
                    generator=gen).to(torch.bfloat16)
    w = (torch.randn((k, k, c, n), device=cuda, generator=gen)
         / (k * k * c) ** 0.5).to(torch.bfloat16)
    before = conv_bf16_im2col.launches
    got = conv_bf16_im2col(x, w)
    assert conv_bf16_im2col.launches == before + 1
    assert got.dtype == torch.float32
    assert float((got - conv_bf16_plain(x, w)).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_depth_to_space_kernel_moves_uint8_exactly(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for c in (3, 16):
        x = torch.randint(0, 256, (2, 7, 5, c * 16), device=cuda,
                          generator=gen).to(torch.uint8)
        assert torch.equal(depth_to_space(x, 4), depth_to_space_plain(x, 4))


@pytest.mark.cuda
def test_int8_conv_kernel_refuses_bad_operands(cuda):
    q_x = torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=cuda)
    before = conv_int8_im2col.launches
    with pytest.raises(ValueError, match="odd square"):
        conv_int8_im2col(q_x, torch.zeros((2, 2, 16, 8), dtype=torch.int8,
                                          device=cuda))
    with pytest.raises(ValueError, match="C_in"):
        conv_int8_im2col(q_x, torch.zeros((3, 3, 8, 8), dtype=torch.int8,
                                          device=cuda))
    with pytest.raises(TypeError, match="int8"):
        conv_int8_im2col(q_x.float(), torch.zeros((3, 3, 16, 8), device=cuda))
    assert conv_int8_im2col.launches == before


def _fused_operands(gen, b, h, w, c, n, k, mode, cuda):
    """f32 input with ±127 saturation and .5 ties: exact at a power-of-two
    per-tensor scale, within a few ulps at per-channel scales that are not
    powers of two; int8 weights; dequant and bias as the int8 sites make
    them."""
    x = torch.randn((b, h, w, c), device=cuda, generator=gen) * 2
    q_w = torch.randint(-127, 128, (k, k, c, n), device=cuda,
                        generator=gen).to(torch.int8)
    s_w = torch.rand(n, device=cuda, generator=gen) * 1e-3 + 1e-4
    if mode == "per_tensor":
        scale = torch.tensor(2.0 ** -4, device=cuda)
        dequant = scale * s_w
    elif mode == "per_channel":
        # not powers of two: x / s lands within a few ulps of .5 ties
        scale = torch.rand(c, device=cuda, generator=gen) * 0.05 + 0.01
        dequant = s_w
    else:
        scale = torch.clamp_min(x.abs().amax(dim=(1, 2, 3), keepdim=True)
                                / 127.0, 1e-12)
        dequant = scale * s_w
    if mode != "dynamic":
        # ties: (j + 0.5) * s for a few pixels, and values past ±127 * s
        x[:, 0, :, :] = ((torch.arange(w * c, device=cuda).reshape(w, c)
                          % 41 - 20) + 0.5) * scale
        x[:, -1, 0, :] = 300.0 * scale
        x[:, -1, -1, :] = -300.0 * scale
    return x.contiguous(), q_w, scale, dequant


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["per_tensor", "per_channel", "dynamic"])
@pytest.mark.parametrize("c,n,k", [
    (3, 64, 3), (64, 64, 3), (64, 256, 3), (64, 3, 3), (64, 48, 7),
    (3, 3, 7),
])
def test_int8_fused_kernel_matches_plain(cuda, mode, c, n, k):
    """Bit for bit: the kernel quantizes, dequantizes and adds the bias
    with the plain version's roundings, with and without a bias."""
    gen = torch.Generator(device=cuda).manual_seed(c * 7 + n + k)
    x, q_w, scale, dequant = _fused_operands(gen, 2, 11, 37, c, n, k, mode,
                                             cuda)
    bias = torch.randn(n, device=cuda, generator=gen)
    packed = pack_weights(q_w)
    for bias_ in (bias, None):
        before = conv_int8_fused.launches
        got = conv_int8_fused(x, q_w, scale, dequant, bias_, packed=packed)
        assert conv_int8_fused.launches == before + 1
        want = conv_int8_fused_plain(x, q_w, scale, dequant, bias_)
        assert got.dtype == torch.float32 and got.shape == (2, 11, 37, n)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_fused_kernel_reciprocal_scale_matches_plain(cuda):
    """The fused-quant tail multiplies by 1/s: x * s on load."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((2, 13, 11, 64), device=cuda, generator=gen)
    q_w = torch.randint(-127, 128, (7, 7, 64, 48), device=cuda,
                        generator=gen).to(torch.int8)
    inv = 1.0 / (torch.rand(64, device=cuda, generator=gen) * 0.05 + 0.01)
    dequant = torch.rand(48, device=cuda, generator=gen) * 1e-3
    bias = torch.randn(48, device=cuda, generator=gen)
    got = conv_int8_fused(x, q_w, inv, dequant, bias, reciprocal=True,
                          packed=pack_weights(q_w))
    assert torch.equal(got, conv_int8_fused_plain(x, q_w, inv, dequant, bias,
                                                  reciprocal=True))


@pytest.mark.cuda
def test_int8_fused_kernel_rounds_near_ties_like_division(cuda):
    """The kernel multiplies by 1/s and divides only near a half-way point:
    a 1x1 conv with weight 1 and dequant 1 returns the quantized values,
    which must equal clamp(round(x / s)) at values within a few ulps of
    every tie, and past the ±127 clamp."""
    j = torch.arange(-140, 141, dtype=torch.float32) + 0.5
    for s in (0.0123, 0.1, 3.7e-3, 0.3):
        up = down = (j * s).to(torch.float32)
        near = [up]
        for _ in range(3):  # 1 to 3 ulps either side
            up = torch.nextafter(up, torch.tensor(float("inf")))
            down = torch.nextafter(down, torch.tensor(float("-inf")))
            near += [up, down]
        x = torch.cat(near).reshape(1, 1, -1, 1).to(cuda)
        ones = torch.ones((1, 1, 1, 1), dtype=torch.int8, device=cuda)
        scale = torch.tensor(s, device=cuda)
        dequant = torch.ones(1, device=cuda)
        got = conv_int8_fused(x, ones, scale, dequant,
                              packed=pack_weights(ones))
        want = conv_int8_fused_plain(x, ones, scale, dequant)
        assert torch.equal(got, want)
        assert torch.equal(got, torch.clamp(torch.round(x / scale), -127,
                                            127))


def _offset(t, elements):
    """A contiguous copy of ``t`` whose data starts ``elements`` elements
    past a fresh allocation: 16-byte misaligned for 1 of 4-byte floats."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("x_off,scale_off", [(0, 0), (1, 0), (0, 1)])
def test_int8_fused_kernel_vector_and_scalar_loads_match_plain(
        cuda, x_off, scale_off):
    """C=64 with x and the per-channel scale 16-byte aligned: the kernel
    loads 16-byte vectors; with either one misaligned it loads scalars.
    Both bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, q_w, scale, dequant = _fused_operands(gen, 2, 11, 37, 64, 64, 3,
                                             "per_channel", cuda)
    x, scale = _offset(x, x_off), _offset(scale, scale_off)
    assert (x.data_ptr() % 16 != 0) == bool(x_off)
    assert (scale.data_ptr() % 16 != 0) == bool(scale_off)
    bias = torch.randn(64, device=cuda, generator=gen)
    got = conv_int8_fused(x, q_w, scale, dequant, bias,
                          packed=pack_weights(q_w))
    assert torch.equal(got, conv_int8_fused_plain(x, q_w, scale, dequant,
                                                  bias))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_int8_conv_kernel_vector_and_scalar_loads_match_plain(cuda, offset):
    """The raw entry at C=64: 16-byte vector loads when x is aligned, byte
    loads when it is not. Exact."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q_x = torch.randint(-127, 128, (2, 11, 37, 64), device=cuda,
                        generator=gen).to(torch.int8)
    q_w = torch.randint(-127, 128, (3, 3, 64, 64), device=cuda,
                        generator=gen).to(torch.int8)
    q_x = _offset(q_x, offset)
    assert (q_x.data_ptr() % 16 != 0) == bool(offset)
    assert torch.equal(conv_int8_im2col(q_x, q_w), conv_int8_plain(q_x, q_w))


@pytest.mark.cuda
def test_int8_fused_kernel_requires_packed_weights(cuda):
    """The fused entry never packs per call: a launch without ``packed``
    raises and launches nothing."""
    x = torch.zeros((1, 4, 4, 8), device=cuda)
    q_w = torch.zeros((3, 3, 8, 4), dtype=torch.int8, device=cuda)
    before = conv_int8_fused.launches
    with pytest.raises(ValueError, match="pack_weights"):
        conv_int8_fused(x, q_w, torch.tensor(1.0, device=cuda),
                        torch.ones(4, device=cuda))
    assert conv_int8_fused.launches == before


@pytest.mark.cuda
def test_int8_scales_on_the_card_equal_the_cpus(cuda):
    """The kernel scales and the dynamic activation scales divide by 127
    as the CPU (and the JAX package) does, bit for bit: PyTorch's CUDA
    division by a Python number multiplies by 1/127, one ulp off for some
    values, which changed the static int8 forward on the card."""
    from sr_torch.quant import activation_scale, quantize_kernel

    gen = torch.Generator().manual_seed(8)
    kernel = torch.randn((3, 3, 64, 4096), generator=gen)
    q_c, s_c = quantize_kernel(kernel.to(cuda))
    q_h, s_h = quantize_kernel(kernel)
    assert torch.equal(s_c.cpu(), s_h) and torch.equal(q_c.cpu(), q_h)
    x = torch.rand((4096, 3, 5, 2), generator=gen) * 7
    assert torch.equal(activation_scale(x.to(cuda)).cpu(),
                       activation_scale(x))
