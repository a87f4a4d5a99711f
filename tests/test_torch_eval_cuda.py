"""sr_torch's eval harness on a card: the device metrics in true float32
with PyTorch's TF32 switches on, and ``evaluate`` on the card against the
CPU, through the shuffle and resblock kernels.

These tests need an NVIDIA GPU (Hopper) and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eval_cuda.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

from sr_torch.data.datasets import SyntheticDataset
from sr_torch.eval import metrics
from sr_torch.eval.runner import evaluate
from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.kernels.fused_resblock import fused_resblock
from sr_torch.models.edsr import Net
from sr_torch.utils.precision import no_tf32

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


@contextlib.contextmanager
def tf32_on():
    """PyTorch's TF32 switches on for cuDNN and matmul, restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@pytest.mark.cuda
@pytest.mark.parametrize("shape,border", [((120, 96), 4), ((64, 80, 3), 0)])
def test_ssim_device_on_the_card_is_true_float32(cuda, shape, border):
    """SSIM on a card tensor against the float64 host SSIM within 1e-5,
    with TF32 allowed around the call (the metric turns it off for its own
    blurs and restores the switches)."""
    rng = np.random.default_rng(1)
    t = rng.uniform(0, 255, shape)
    p = np.clip(t + rng.normal(0, 6, shape), 0, 255)
    with tf32_on():
        got = metrics.ssim_device(torch.from_numpy(p).to(cuda),
                                  torch.from_numpy(t).to(cuda), border=border)
        assert torch.backends.cudnn.allow_tf32
    assert got.device.type == "cuda"
    assert abs(float(got) - metrics.ssim(p, t, border=border)) <= 1e-5


@pytest.mark.cuda
def test_ycbcr_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(2)
    rgb = torch.from_numpy(rng.uniform(0, 255, (64, 48, 3)).astype(np.float32))
    with tf32_on():
        ycc = metrics.rgb_to_ycbcr(rgb.to(cuda))
        back = metrics.ycbcr_to_rgb(ycc)
    np.testing.assert_allclose(ycc.cpu().numpy(),
                               metrics.rgb_to_ycbcr(rgb).numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(back.cpu().numpy(), rgb.numpy(), rtol=0,
                               atol=1e-3)


@pytest.mark.cuda
def test_evaluate_device_metrics_on_the_card(cuda):
    """Nearest neighbour ×4 on the card: device metrics against the host's
    within 1e-4 dB and 1e-5 SSIM, and the card run equal to the CPU run."""
    ds = SyntheticDataset(num_images=2, size=(96, 88), seed=3)

    def nearest(x):
        return x.repeat_interleave(4, 1).repeat_interleave(4, 2)

    kw = dict(scale_factor=4, channels=3, color_space="rgb")
    cpu = evaluate(nearest, ds, device="cpu", **kw)
    with tf32_on():
        host = evaluate(nearest, ds, **kw)
        dev = evaluate(nearest, ds, on_device_metrics=True, **kw)
    for a, b, c in zip(cpu.images, host.images, dev.images):
        assert a.psnr_sr == b.psnr_sr and a.ssim_sr == b.ssim_sr
        assert abs(c.psnr_sr - a.psnr_sr) <= 1e-4
        assert abs(c.ssim_sr - a.ssim_sr) <= 1e-5 and c.ssim_sr <= 1.0


@pytest.mark.cuda
def test_evaluate_edsr_on_the_card_equals_the_cpu(cuda):
    """EDSR ×4 (2 resblocks × 64 filters, f32, TF32 off) through
    ``evaluate`` on the card and on the CPU: per-image PSNR within 1e-3 dB
    and SSIM within 1e-5; each predict call launches 2 shuffles and 2
    resblocks on the card."""
    model = Net(3, 64, 2, 4, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.out_conv.Conv_0.bias.add_(0.5)
    ds = SyntheticDataset(num_images=2, size=(64, 72), seed=4)
    kw = dict(scale_factor=4, channels=3, color_space="rgb")
    cpu = evaluate(model.eval(), ds, device="cpu", **kw)
    card_model = model.clone(torch.float32).to(cuda).eval()
    d0, r0 = depth_to_space.launches, fused_resblock.launches
    with no_tf32():
        card = evaluate(card_model, ds, **kw)
        card_dev = evaluate(card_model, ds, on_device_metrics=True, **kw)
    assert depth_to_space.launches - d0 == 2 * 2 * len(ds)
    assert fused_resblock.launches - r0 == 2 * 2 * len(ds)
    for a, b, c in zip(cpu.images, card.images, card_dev.images):
        assert abs(a.psnr_sr - b.psnr_sr) <= 1e-3
        assert abs(a.ssim_sr - b.ssim_sr) <= 1e-5
        assert abs(c.psnr_sr - b.psnr_sr) <= 1e-4
        assert abs(c.ssim_sr - b.ssim_sr) <= 1e-5
