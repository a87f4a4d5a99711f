"""The pre-upsample models, SRCNN, VDSR and DRCN ×4 on Y, on a card: the
fused int8 entry at the regimes this family brings (one output channel, a
9×9 window over one input channel, no bias) exact against its plain
version, the int8 forwards of the three models card == CPU bit for bit
with their launches a forward, and one f32 train step card vs CPU.

These tests need an NVIDIA GPU (Hopper) and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_preupsample_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sr_torch.kernels.int8_conv import (
    conv_int8_fused, conv_int8_fused_plain, pack_weights)
from sr_torch.models import drcn, srcnn, vdsr
from sr_torch.quant import calibrate_scales, quantized_apply
from sr_torch.train.trainer import Trainer
from sr_torch.utils.config import SRConfig
from sr_torch.utils.precision import no_tf32

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


#: (C, N, k, bias): SRCNN's 9×9 over one channel, its 5×5 sites (32→1 is
#: N = 1), VDSR's bias-free 3×3 sites (64→1 too), DRCN's 64→1
_SITES = ((1, 64, 9, True), (64, 32, 5, True), (32, 1, 5, True),
          (1, 64, 3, False), (64, 64, 3, False), (64, 1, 3, False),
          (64, 1, 3, True))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,k,bias", _SITES)
def test_int8_fused_at_the_families_sites_equals_plain(cuda, c, n, k, bias):
    """Bit for bit at a per-tensor scale, a per-channel one and the
    per-sample (dynamic) one, on an odd 37×45 input, with .5 ties and ±127
    saturation."""
    gen = torch.Generator(device=cuda).manual_seed(k * 100 + n + c)
    shape = (2, 37, 45, c)
    x = torch.randn(shape, device=cuda, generator=gen) * 2
    q_w = torch.randint(-127, 128, (k, k, c, n), device=cuda,
                        generator=gen).to(torch.int8)
    packed = pack_weights(q_w)
    b = torch.randn(n, device=cuda, generator=gen) if bias else None
    s_w = torch.rand(n, device=cuda, generator=gen) * 1e-3 + 1e-4
    dyn = torch.clamp_min(x.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0,
                          1e-12)
    per_tensor = torch.tensor(2.0 ** -4, device=cuda)
    x[:, 0] = ((torch.arange(45 * c, device=cuda).reshape(45, c) % 41 - 20)
               + 0.5) * per_tensor
    x[:, -1, 0] = 300.0 * per_tensor
    for scale, dq in ((per_tensor, per_tensor * s_w),
                      (torch.rand(c, device=cuda, generator=gen) * 0.05
                       + 0.01, s_w),
                      (dyn, dyn * s_w)):
        before = conv_int8_fused.launches
        got = conv_int8_fused(x, q_w, scale, dq, b, packed=packed)
        assert conv_int8_fused.launches == before + 1
        want = conv_int8_fused_plain(x, q_w, scale, dq, b)
        assert torch.equal(got, want), (c, n, k, bias, tuple(scale.shape))


def _models():
    gen = torch.Generator().manual_seed(0)
    return {"SRCNN": (srcnn.Net(1, 64, generator=gen), 3),
            "VDSR": (vdsr.Net(1, 16, 20, generator=gen), 20),
            "DRCN": (drcn.Net(1, 8, 16, generator=gen), 50)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SRCNN", "VDSR", "DRCN"])
def test_int8_forward_card_equals_cpu(cuda, name):
    """Static (the CPU's scales) and dynamic int8 forwards of each model at
    its depth, card == CPU bit for bit, with 3 / 20 / 50 fused int8
    launches a forward (DRCN: 2 static sites and 48 dynamic)."""
    model, per_fwd = _models()[name]
    model.eval()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 41, 35, 1)).astype(np.float32))
    scales = calibrate_scales(model, x)
    assert len(scales) == (2 if name == "DRCN" else per_fwd)
    want = [quantized_apply(model, x, m) for m in (scales, None)]
    card = model.to(cuda)
    for m, cpu_out in zip((scales, None), want):
        before = conv_int8_fused.launches
        got = quantized_apply(card, x.to(cuda), m).cpu()
        assert conv_int8_fused.launches - before == per_fwd
        assert torch.equal(got, cpu_out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SRCNN", "VDSR", "DRCN"])
def test_f32_train_step_card_equals_cpu(cuda, name):
    """One f32 step (TF32 off) at step 5 of 10 (DRCN's α 0.5, so its
    recursion weights get a gradient): the loss within 1e-5 relative,
    every gradient within 1e-3 of its largest entry; VDSR's clip scale,
    DRCN's recursive and final terms on the card."""
    cfg = SRConfig(model_name=name, num_channels=1, scale_factor=4,
                   base_filter=16, num_recursions=4, crop_size=32,
                   batch_size=4, dtype="float32", num_epochs=1,
                   steps_per_epoch=10)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.uniform(0, 1, (4, 32, 32, 1)).astype(
        np.float32)) for k in ("bc", "hr")}
    out = {}
    for device in (cuda, "cpu"):
        tr = Trainer(cfg, device=device)
        state = tr.init_state(3)
        with no_tf32():
            loss, metrics = tr.loss_fn(
                state.model, {k: v.to(device) for k, v in batch.items()}, 5)
            loss.backward()
        out[str(device)] = (float(loss.detach()), {
            n: p.grad.cpu() for n, p in state.model.named_parameters()},
            tr.train_step(state, {k: v.to(device)
                                  for k, v in batch.items()})[1])
    (lc, gc, mc), (lh, gh, mh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * lh
    for n, g in gh.items():
        assert float(g.abs().max()) > 0, n
        assert float((gc[n] - g).abs().max()) <= 1e-3 * float(g.abs().max())
    assert set(mc) == set(mh)
    if name == "VDSR":
        assert 0 < float(mc["clip_scale"]) <= 1
