"""ESPCN ×4 on Y on a card: the shuffle at r=4, 16→1 and the fused int8
entry at ESPCN's three sites against their plain versions, and the shuffle
launches of an ESPCN train step.

These tests need an NVIDIA GPU (Hopper) and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_espcn_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sr_torch.kernels.depth_to_space import (
    depth_to_space, depth_to_space_plain)
from sr_torch.kernels.int8_conv import (
    conv_int8_fused, conv_int8_fused_plain, pack_weights)
from sr_torch.train.trainer import Trainer
from sr_torch.utils.config import SRConfig

torch.set_num_threads(1)

_SMALL = dict(model_name="ESPCN", num_channels=1, scale_factor=4,
              base_filter=16, crop_size=32, batch_size=8)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"lr": rng.uniform(0, 1, (8, 8, 8, 1)).astype(np.float32),
            "hr": rng.uniform(0, 1, (8, 32, 32, 1)).astype(np.float32)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,k", [(1, 64, 5), (64, 32, 3), (32, 16, 3)])
def test_int8_fused_at_espcns_sites_equals_plain(cuda, c, n, k):
    """The fused int8 entry at ESPCN's three sites, bit for bit with its
    plain version: per-tensor (a 1-channel per-channel scale is one
    number), per-channel and per-sample scales; C=1 pads each tap's K run
    to 64 bytes of zeros."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    for shape in ((2, 37, 53, c), (16, 128, 128, c)):
        x = torch.randn(shape, device=cuda, generator=gen) * 2
        q_w = torch.randint(-127, 128, (k, k, c, n), device=cuda,
                            generator=gen).to(torch.int8)
        bias = torch.randn(n, device=cuda, generator=gen)
        s_w = torch.rand(n, device=cuda, generator=gen) * 1e-3 + 1e-4
        per_sample = torch.clamp_min(
            x.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, 1e-12)
        for scale, dq in ((torch.tensor(2.0 ** -4, device=cuda), s_w / 16),
                          (torch.rand(c, device=cuda, generator=gen) * 0.05
                           + 0.01, s_w),
                          (per_sample, per_sample.reshape(-1, 1, 1, 1)
                           * s_w)):
            got = conv_int8_fused(x, q_w, scale, dq, bias,
                                  packed=pack_weights(q_w))
            assert torch.equal(got, conv_int8_fused_plain(x, q_w, scale, dq,
                                                          bias))


@pytest.mark.cuda
def test_shuffle_to_one_channel_equals_plain(cuda):
    """r=4, 16→1 channel: output runs of 4 elements per LR pixel, odd
    widths (ragged heads and tails), with and without the bias, f32 and
    bf16, and under autograd (forward, grad x, grad bias)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((1, 37, 53, 16), (16, 128, 128, 16), (1, 96, 96, 16)):
            x = torch.randn(shape, device=cuda, generator=gen).to(dtype)
            bias = torch.randn(16, device=cuda, generator=gen).to(dtype)
            for b in (None, bias):
                assert torch.equal(depth_to_space(x, 4, None, b),
                                   depth_to_space_plain(x, 4, None, b))
    x0 = torch.randn((32, 16, 16, 16), device=cuda,
                     generator=gen).bfloat16()
    b0 = torch.randn(16, device=cuda, generator=gen).bfloat16()
    g = torch.randn((32, 64, 64, 1), device=cuda, generator=gen).bfloat16()
    got = []
    for fn in (depth_to_space, depth_to_space_plain):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = fn(x, 4, None, b)
        y.backward(g)
        got.append((y.detach(), x.grad, b.grad))
    for k, p in zip(*got):
        assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,per_step", [(False, 1), ("last", 0)])
def test_espcn_train_step_launches_the_shuffle(cuda, mode, per_step):
    tr = Trainer(SRConfig(**_SMALL, dtype="bfloat16", preshuffle_loss=mode))
    state = tr.init_state(0)
    batch = {k: torch.from_numpy(a).to(cuda) for k, a in _batch().items()}
    d0 = depth_to_space.launches
    tr.train_step(state, batch)
    assert depth_to_space.launches - d0 == per_step
