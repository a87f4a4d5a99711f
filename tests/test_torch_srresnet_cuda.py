"""SRResNet and SRGAN ×4 on a card: the fused int8 entry at the regimes this
family brings (the 9×9 head over 3 channels, the 9×9 exact out conv to 3
channels, the folded 5×5 256 → 12 out conv) and the PReLU stage's shuffle
exact against their plain versions; the folded int8 tail card == CPU bit
for bit with its launches a forward; the float folded tail equal to the
exact graph; one f32 train step and one f32 adversarial step card vs CPU.

These tests need an NVIDIA GPU (Hopper) and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_srresnet_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

import sr_torch.quant as quant
from sr_torch.kernels.depth_to_space import (
    depth_to_space, depth_to_space_plain)
from sr_torch.kernels.int8_conv import (
    conv_int8_fused, conv_int8_fused_plain, pack_weights)
from sr_torch.kernels.shuffle_fold import (
    make_folded_tail_predict, make_folded_tail_predict_quant)
from sr_torch.models import srresnet
from sr_torch.train.gan import GANTrainer
from sr_torch.train.trainer import Trainer
from sr_torch.utils.config import SRConfig
from sr_torch.utils.precision import no_tf32

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


#: (C, N, k): the head, a body conv, a stage conv, the exact out conv, the
#: folded out conv
_SITES = ((3, 64, 9), (64, 64, 3), (64, 256, 3), (64, 3, 9), (256, 12, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,k", _SITES)
def test_int8_fused_at_the_srresnet_sites_equals_plain(cuda, c, n, k):
    """Bit for bit at a per-channel scale and the per-sample one, on an odd
    19×23 input."""
    gen = torch.Generator(device=cuda).manual_seed(k * 1000 + n + c)
    x = torch.randn((2, 19, 23, c), device=cuda, generator=gen) * 2
    q_w = torch.randint(-127, 128, (k, k, c, n), device=cuda,
                        generator=gen).to(torch.int8)
    packed = pack_weights(q_w)
    b = torch.randn(n, device=cuda, generator=gen)
    s_w = torch.rand(n, device=cuda, generator=gen) * 1e-3 + 1e-4
    per_channel = x.abs().amax(dim=(0, 1, 2)) / 127.0
    dyn = torch.clamp_min(x.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0,
                          1e-12)
    for scale, dequant in ((per_channel, s_w), (dyn, dyn * s_w)):
        got = conv_int8_fused(x, q_w, scale, dequant, b, packed=packed)
        want = conv_int8_fused_plain(x, q_w, scale, dequant, b)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_shuffle_with_bias_equals_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 13, 17, 256), device=cuda, generator=gen).to(dtype)
    b = torch.randn(256, device=cuda, generator=gen).to(dtype)
    assert torch.equal(depth_to_space(x, 2, None, b),
                       depth_to_space_plain(x, 2, None, b))


def _model(device, dtype=torch.float32):
    m = srresnet.Net(3, 64, 2, 4, dtype, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen)
                               * 0.02)
        m.out_conv.bias.add_(0.5)
    return m.to(device).eval()


@pytest.mark.cuda
def test_folded_tails_on_the_card(cuda, monkeypatch):
    """The float folded tail equals the exact graph (f32, TF32 off, 1e-5);
    the folded int8 tail equals the CPU's bit for bit given the CPU's
    scales, with 9 int8 launches and 2 shuffles a forward at 2 blocks
    (head, 2·2 + 1 body, 2 stages, the folded out conv; 37 at 16
    blocks)."""
    x = torch.rand((2, 24, 20, 3), generator=torch.Generator().manual_seed(2))
    cpu = _model("cpu")
    card = copy.deepcopy(cpu).to(cuda)
    with no_tf32(), torch.no_grad():
        exact = card(x.to(cuda))
        folded = make_folded_tail_predict(card)(x.to(cuda))
    assert (folded - exact).abs().max() <= 1e-5
    want = make_folded_tail_predict_quant(cpu)(x)
    scales = quant.calibrate_scales_batches(cpu, [x])
    monkeypatch.setattr(quant, "calibrate_scales_batches",
                        lambda *a, **k: scales)
    fn = make_folded_tail_predict_quant(card)
    fn(x.to(cuda))
    conv_int8_fused.launches = depth_to_space.launches = 0
    got = fn(x.to(cuda))
    assert (conv_int8_fused.launches, depth_to_space.launches) == (9, 2)
    assert torch.equal(got.cpu(), want)


def _batch(device, seed=3):
    g = torch.Generator().manual_seed(seed)
    return {"lr": torch.rand((4, 16, 16, 3), generator=g).to(device),
            "hr": torch.rand((4, 64, 64, 3), generator=g).to(device)}


def _pre_bn_bias(name: str) -> bool:
    """A conv bias a batch norm follows: zero gradient up to rounding in
    train mode, so Adam moves it by ±lr in a direction rounding picks."""
    return name == "body_conv.bias" or (
        name.startswith("blocks.")
        and name.endswith(("Conv_0.bias", "Conv_1.bias")))


@pytest.mark.cuda
def test_train_step_card_vs_cpu(cuda):
    """One f32 SRResNet step (TF32 off): loss within 1e-5 relative; each
    gradient within 1e-3 of its largest entry (float32 summation order),
    the pre-BN conv biases' below 1e-3 of the step's largest; running
    statistics within 1e-5; every parameter within 2·lr of the CPU's after
    the Adam update (Adam moves each by at most lr; where a gradient entry
    sits near Adam's ε its update differs by a few % of lr)."""
    cfg = SRConfig(model_name="SRResNet", num_channels=3, num_resblocks=2,
                   dtype="float32", crop_size=64, batch_size=4)
    states = {}
    for dev in ("cpu", cuda):
        tr = Trainer(cfg, device=dev)
        st = tr.init_state(0)
        with no_tf32():
            _, m = tr.train_step(st, _batch(dev))
        states[str(dev)] = (float(m["loss"]), st)
    (l_cpu, a), (l_card, b) = states["cpu"], states[str(cuda)]
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    grads = {n: (p.grad, q.grad.cpu()) for (n, p), q in zip(
        a.model.named_parameters(), b.model.parameters())}
    top = max(float(g.abs().max()) for g, _ in grads.values())
    for n, (g, h) in grads.items():
        if _pre_bn_bias(n):
            assert max(g.abs().max(), h.abs().max()) <= 1e-3 * top, n
        else:
            assert (g - h).abs().max() <= 1e-3 * g.abs().max(), n
    lr = cfg.effective_lr
    for (name, t), u in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        tol = 1e-5 if name.endswith(("mean", "var")) else 2 * lr * 1.001
        assert (t - u.cpu()).abs().max() <= tol, name


@pytest.mark.cuda
def test_adversarial_step_card_vs_cpu(cuda):
    """One f32 SRGAN adversarial step (no VGG, TF32 off): d_loss and g_loss
    within 1e-4 relative, G's eval output on a probe within 3e-4."""
    cfg = SRConfig(model_name="SRGAN", num_channels=3, num_resblocks=2,
                   base_filter=16, dtype="float32", crop_size=64,
                   batch_size=4)
    probe = torch.rand((1, 16, 16, 3),
                       generator=torch.Generator().manual_seed(4))
    out = {}
    for dev in ("cpu", cuda):
        tr = GANTrainer(cfg, device=dev)
        g, d = tr.init_states(0)
        with no_tf32():
            _, _, m = tr.adversarial_step(g, d, _batch(dev))
            out[str(dev)] = ({k: float(v) for k, v in m.items()},
                             tr.predict(g, probe.to(dev)).cpu())
    (m_cpu, p_cpu), (m_card, p_card) = out["cpu"], out[str(cuda)]
    for k in ("d_loss", "g_loss"):
        assert m_card[k] == pytest.approx(m_cpu[k], rel=1e-4), k
    assert (p_card - p_cpu).abs().max() <= 3e-4
    assert np.isfinite(list(m_card.values())).all()
