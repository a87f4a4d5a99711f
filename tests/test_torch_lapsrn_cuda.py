"""FSRCNN and LapSRN ×4 on a card: the int8 deconv (the phase-packed fused
int8 conv and the shuffle kernel) card == CPU bit for bit at the zoo's
deconv geometries; the int8 forwards with ``quantize_deconv`` card == CPU
bit for bit with their launches a forward (8 int8 convs and 1 shuffle for
FSRCNN, 17 and 4 for LapSRN); the 1×1 int8 sites exact against their plain
version; one f32 train step card vs CPU; LapSRN's ×2 level on the card.

These tests need an NVIDIA GPU (Hopper) and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lapsrn_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.kernels.int8_conv import (
    conv_int8_fused, conv_int8_fused_plain, pack_weights)
from sr_torch.models.registry import get_spec
from sr_torch.nn.blocks import DeconvBlock
from sr_torch.quant import calibrate_scales, int8_deconv, quantized_apply
from sr_torch.train.trainer import Trainer
from sr_torch.utils.config import SRConfig
from sr_torch.utils.precision import no_tf32

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def _lively(model, seed):
    """Seeded He-scaled weights and nonzero biases, in place."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                fan = p[0].numel() if p.dim() == 4 else 1
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (2.0 / fan) ** 0.5)
            elif name.endswith("slope"):
                p.fill_(0.25)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["per_channel", "dynamic"])
@pytest.mark.parametrize("k,s,cin,n", [(4, 2, 64, 64), (4, 2, 1, 1),
                                       (9, 4, 56, 1)])
def test_int8_deconv_card_equals_cpu(cuda, k, s, cin, n, mode):
    """On an odd 19×23 input: bit for bit, the phase conv and the shuffle
    each launched once."""
    block = _lively(DeconvBlock(cin, n, k, s, act=None), k + n)
    x = torch.randn((2, cin, 19, 23), generator=torch.Generator()
                    .manual_seed(s)).contiguous(
        memory_format=torch.channels_last)
    scale = (x.abs().amax((0, 2, 3)).numpy() / 127 * 0.9
             if mode == "per_channel" else None)
    want = int8_deconv(x, block.ConvTranspose_0, scale)
    card = copy.deepcopy(block).to(cuda)
    conv_int8_fused.launches = depth_to_space.launches = 0
    got = int8_deconv(x.to(cuda), card.ConvTranspose_0, scale)
    assert (conv_int8_fused.launches, depth_to_space.launches) == (1, 1)
    assert got.shape == (2, n, 19 * s, 23 * s)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(56, 12), (12, 56)])
def test_int8_fused_1x1_sites_equal_plain(cuda, c, n):
    """FSRCNN's shrink and expand, the port's first 1×1 int8 sites, whose
    C is no whole 64-byte chunk (the scalar-load path)."""
    gen = torch.Generator(device=cuda).manual_seed(c + n)
    x = torch.randn((2, 19, 23, c), device=cuda, generator=gen) * 2
    q_w = torch.randint(-127, 128, (1, 1, c, n), device=cuda,
                        generator=gen).to(torch.int8)
    bias = torch.randn(n, device=cuda, generator=gen)
    s_x = x.abs().amax(dim=(0, 1, 2)) / 127
    dequant = torch.rand(n, device=cuda, generator=gen) * 1e-3 + 1e-4
    got = conv_int8_fused(x, q_w, s_x, dequant, bias,
                          packed=pack_weights(q_w))
    assert torch.equal(got, conv_int8_fused_plain(x, q_w, s_x, dequant,
                                                  bias))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("name", ["FSRCNN", "LapSRN"])
def test_quantize_deconv_forward_card_equals_cpu(cuda, name, mode):
    """Full width, ``quantize_deconv=True``, static scales calibrated on
    the CPU and shared: card == CPU bit for bit, and a forward launches 8
    fused int8 convs and 1 shuffle (FSRCNN) or 17 and 4 (LapSRN)."""
    model = _lively(get_spec(name).make_model(
        SRConfig(model_name=name, dtype="float32")), 3).eval()
    x = torch.rand((2, 21, 17, 1), generator=torch.Generator().manual_seed(4))
    scales = calibrate_scales(model, x) if mode == "static" else None
    want = quantized_apply(model, x, scales=scales, quantize_deconv=True)
    card = copy.deepcopy(model).to(cuda)
    conv_int8_fused.launches = depth_to_space.launches = 0
    got = quantized_apply(card, x.to(cuda), scales=scales,
                          quantize_deconv=True)
    per_fwd = {"FSRCNN": (8, 1), "LapSRN": (17, 4)}[name]
    assert (conv_int8_fused.launches, depth_to_space.launches) == per_fwd
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["FSRCNN", "LapSRN"])
def test_f32_train_step_card_vs_cpu(cuda, name):
    """One f32 step (TF32 off) from the same weights and batch: the loss
    within 1e-5 relative and every gradient within 1e-3 of its largest
    entry; LapSRN's level losses too."""
    cfg = SRConfig(model_name=name, num_channels=1, scale_factor=4,
                   crop_size=32, batch_size=2, dtype="float32")
    rng = np.random.default_rng(5)
    batch = {"lr": torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 1))
                                    .astype(np.float32)),
             "hr": torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 1))
                                    .astype(np.float32))}
    out = []
    for device in ("cpu", cuda):
        tr = Trainer(cfg, device=device)
        st = tr.init_state(6)
        with no_tf32():
            _, m = tr.train_step(st, {k: v.to(device)
                                      for k, v in batch.items()})
        out.append(({k: float(v) for k, v in m.items()},
                    {n: p.grad.cpu() for n, p in
                     st.model.named_parameters()}))
    (m_cpu, g_cpu), (m_card, g_card) = out
    assert set(m_cpu) == set(m_card)
    for k in m_cpu:
        assert abs(m_card[k] - m_cpu[k]) <= 1e-5 * abs(m_cpu[k]), k
    for n, g in g_cpu.items():
        err = float((g_card[n] - g).abs().max() / g.abs().max())
        assert err <= 1e-3, n


@pytest.mark.cuda
def test_lapsrn_x2_level_card_equals_cpu(cuda):
    """``all_scales`` level 0 on the card within 1e-4 of the CPU's (TF32
    off), at f32."""
    model = _lively(get_spec("LapSRN").make_model(
        SRConfig(model_name="LapSRN", dtype="float32")), 7).eval()
    x = torch.rand((1, 30, 26, 1), generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want = model(x, all_scales=True)[0]
        card = copy.deepcopy(model).to(cuda)
        with no_tf32():
            got = card(x.to(cuda), all_scales=True)[0]
    assert got.shape == (1, 60, 52, 1)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
