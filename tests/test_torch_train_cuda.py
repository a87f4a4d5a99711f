"""sr_torch's training path on a card: the pixel shuffle under autograd
against its plain version, one train step against the CPU's, the shuffle's
launches per step in each pre-shuffle mode, and K steps per dispatch
against K single steps and without a host sync.

These tests need an NVIDIA GPU and the CUDA toolkit: they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.pipeline import PatchPipeline
from sr_torch.kernels.depth_to_space import (
    depth_to_space, depth_to_space_plain)
from sr_torch.train.trainer import Trainer
from sr_torch.utils.config import SRConfig
from sr_torch.utils.precision import no_tf32

torch.set_num_threads(1)

_SMALL = dict(model_name="EDSR", num_channels=3, scale_factor=4,
              num_resblocks=2, base_filter=16, crop_size=32, batch_size=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


@contextlib.contextmanager
def _deterministic():
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def _pipe(device, batch=8):
    ds = SyntheticDataset(num_images=4, size=(64, 72), seed=1)
    return PatchPipeline([ds[i] for i in range(len(ds))], crop_size=32,
                         scale_factor=4, batch_size=batch, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 32])
@pytest.mark.parametrize("act", [None, "relu"])
def test_depth_to_space_autograd_matches_plain(cuda, h, act):
    """EDSR's training shuffles at crop 64 b32, bf16, with the PS conv's
    bias: forward through the kernel, and the gradients of x and the bias,
    equal autograd through the plain version bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x0 = torch.randn((32, h, h, 256), device=cuda, generator=gen).bfloat16()
    b0 = torch.randn(256, device=cuda, generator=gen).bfloat16()
    g = torch.randn((32, 2 * h, 2 * h, 64), device=cuda,
                    generator=gen).bfloat16()
    outs = []
    for fn in (depth_to_space, depth_to_space_plain):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        n0 = depth_to_space.launches
        y = fn(x, 2, act, b)
        launched = depth_to_space.launches - n0
        y.backward(g)
        outs.append((y.detach(), x.grad, b.grad))
        assert launched == (1 if fn is depth_to_space else 0)
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpus(cuda):
    """One f32 step (TF32 off) from the same weights and batch: loss within
    1e-5 and each gradient within 1e-4 of its largest entry (float32
    summation order), every parameter with a nonzero gradient."""
    cfg = SRConfig(**_SMALL, dtype="float32")
    batch = _pipe("cpu")(torch.Generator().manual_seed(0))
    results = []
    for device in (cuda, "cpu"):
        tr = Trainer(cfg, device=device)
        st = tr.init_state(0)
        with no_tf32():
            loss, _ = tr.loss_fn(
                st.model, {k: v.to(device) for k, v in batch.items()}, 0)
            loss.backward()
        results.append((float(loss.detach()),
                        {n: p.grad.cpu() for n, p in
                         st.model.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = results
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, g in g_cpu.items():
        assert g.abs().max() > 0, name
        err = float((g_card[name] - g).abs().max() / g.abs().max())
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,per_step", [(False, 2), ("last", 1),
                                           ("full", 0)])
def test_shuffle_launches_per_train_step(cuda, mode, per_step):
    pipe = _pipe(cuda)
    tr = Trainer(SRConfig(**_SMALL, dtype="bfloat16", preshuffle_loss=mode))
    assert tr.device.type == "cuda"  # the trainer's default device
    st = tr.init_state(0)
    step = tr.make_multi_step(pipe, 3)
    n0 = depth_to_space.launches
    metrics = step(st)
    assert depth_to_space.launches - n0 == 3 * per_step
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.grad is not None and bool(p.grad.abs().max() > 0)
               for p in st.model.parameters())


@pytest.mark.cuda
def test_multi_step_equals_single_steps_on_the_card(cuda):
    """With cuDNN's deterministic algorithms, K=3 steps in one dispatch
    equal 3 single steps bit for bit."""
    pipe = _pipe(cuda)
    tr = Trainer(SRConfig(**_SMALL, dtype="bfloat16"))
    with _deterministic():
        a, b = tr.init_state(0), tr.init_state(0)
        tr.make_multi_step(pipe, 3)(a)
        for _ in range(3):
            tr.train_step(b, pipe(b.generator))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.cuda
def test_multi_step_makes_no_host_sync(cuda):
    """K steps queue without waiting for the card: PyTorch raises on any
    synchronizing call under ``set_sync_debug_mode('error')``."""
    pipe = _pipe(cuda)
    tr = Trainer(SRConfig(**_SMALL, dtype="bfloat16"))
    st = tr.init_state(0)
    step = tr.make_multi_step(pipe, 3)
    step(st)  # warm-up: cuDNN and cuBLAS set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"]))
