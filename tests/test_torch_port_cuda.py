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
