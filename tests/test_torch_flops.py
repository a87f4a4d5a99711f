"""sr_torch.utils.flops against ``sr.utils.flops``: the port's conv FLOP
counts equal the JAX package's exactly, for EDSR and ESPCN at several
shapes and scales. Everything runs on the CPU."""

import jax
import jax.numpy as jnp
import pytest
import torch

from sr.models.edsr import Net as FlaxEDSR
from sr.models.espcn import Net as FlaxESPCN
from sr.utils.flops import conv_forward_flops as jax_forward_flops
from sr.utils.flops import train_step_flops as jax_train_step_flops
from sr_torch.models.edsr import Net as EDSR
from sr_torch.models.espcn import Net as ESPCN
from sr_torch.models.registry import get_spec
from sr_torch.utils.config import SRConfig
from sr_torch.utils.flops import conv_forward_flops, train_step_flops

torch.set_num_threads(1)


def _flax(jm, channels):
    return jm, jm.init(jax.random.key(0), jnp.zeros((1, 8, 8, channels)),
                       train=False)


CASES = [  # (name, scale, x_shape)
    ("EDSR", 4, (32, 16, 16, 3)), ("EDSR", 2, (3, 11, 9, 3)),
    ("EDSR", 3, (1, 12, 17, 3)), ("EDSR", 8, (2, 8, 8, 3)),
    ("ESPCN", 4, (32, 16, 16, 1)), ("ESPCN", 2, (5, 13, 7, 1)),
    ("ESPCN", 3, (1, 20, 24, 1)),
]


def _models(name, scale):
    if name == "EDSR":
        return _flax(FlaxEDSR(3, 16, 2, scale), 3), EDSR(3, 16, 2, scale)
    return _flax(FlaxESPCN(1, 64, scale), 1), ESPCN(1, 64, scale)


@pytest.mark.parametrize("name,scale,x_shape", CASES)
def test_train_step_flops_equal_jax(name, scale, x_shape):
    (jm, v), tm = _models(name, scale)
    want = jax_train_step_flops(jm, v, x_shape, train=False)
    assert train_step_flops(tm, x_shape) == want
    assert conv_forward_flops(tm, x_shape) * 3 == want
    assert want == 3 * jax_forward_flops(jm, v, x_shape, train=False)


@pytest.mark.parametrize("name,x_shape,want", [
    ("EDSR", (32, 16, 16, 3), 97_476_673_536),
    ("ESPCN", (32, 16, 16, 1), 1_211_105_280)])
def test_bench_train_axis_counts(name, x_shape, want):
    """The full-width models of the bench's train axis (crop 64 ×4, b32)."""
    spec = get_spec(name)
    cfg = SRConfig(model_name=name, num_channels=spec.default_channels,
                   scale_factor=4, dtype="bfloat16")
    assert train_step_flops(spec.make_model(cfg), x_shape) == want


def test_counting_leaves_the_model_and_the_kernels_alone():
    """A batch-1 forward of a CPU copy: the model keeps its device, mode
    and weights, and the FLOPs scale with the batch."""
    tm = ESPCN(1, 16, 4).train()
    before = [p.detach().clone() for p in tm.parameters()]
    one = conv_forward_flops(tm, (1, 10, 10, 1))
    assert conv_forward_flops(tm, (7, 10, 10, 1)) == 7 * one
    assert tm.training
    assert all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))
    assert one == 2 * 100 * (25 * 1 * 16 + 9 * 16 * 8 + 9 * 8 * 16)
