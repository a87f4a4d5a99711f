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
    fused_resblock, fused_resblock_plain)
from sr_torch.kernels.int8_conv import (
    conv_bf16_im2col, conv_bf16_plain, conv_int8_im2col, conv_int8_plain)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(2, 5, 7, 16), (1, 3, 300, 16),
                                     (2, 4, 9, 3)])
def test_depth_to_space_kernel_matches_plain(cuda, b, h, w, c):
    """Exact. (1, 3, 300, 16): an output row longer than one block of
    threads; C=3: no 16-byte vectors."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for r in (2, 3, 4):
            for act in (None, "relu"):
                x = torch.randn((b, h, w, c * r * r), device=cuda,
                                generator=gen).to(dtype)
                before = depth_to_space.launches
                got = depth_to_space(x, r, act)
                assert depth_to_space.launches == before + 1
                assert torch.equal(got, depth_to_space_plain(x, r, act))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 2 ** 28, 4), (2 ** 30, 1, 1, 4)])
def test_depth_to_space_kernel_refuses_oversize(cuda, shape):
    """2^30 elements in one input row, or 2^31 output rows at r=2: past
    the kernel's 32-bit in-row offsets and its grid. Uninitialised bf16,
    2 and 8 GiB."""
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
        for rs in (1.0, 0.1):
            got = fused_resblock(x, w1, b1, w2, b2, rs)
            want = fused_resblock_plain(x, w1, b1, w2, b2, rs)
            assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_fused_resblock_kernel_rejects_unsupported(cuda):
    x = torch.zeros((1, 8, 8, 24), device=cuda)
    w = torch.zeros((9 * 24, 24), device=cuda)
    b = torch.zeros(24, device=cuda)
    with pytest.raises(ValueError, match="C in"):
        fused_resblock(x, w, b, w, b)


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
