"""The fused int8 conv entry (quantize on load, dequantize and bias on
store) against the unfused sequence and the JAX package, bit for bit.

On the CPU :func:`conv_int8_fused` runs its plain version, the passes of
``sr/quant.py:int8_conv`` one by one; the CUDA kernel is held to that plain
version on a card in tests/test_torch_port_cuda.py. Inputs come from
``np.random.default_rng``: values past ±127 steps of the scale saturate,
and values at exact half steps of a power-of-two scale test the rounding
(half to even in ``jnp.round``, ``torch.round`` and the kernel's ``rintf``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from sr.quant import int8_conv as jax_int8_conv
from sr_torch import quant
from sr_torch.kernels.int8_conv import (
    conv_int8_fused, conv_int8_im2col, pack_weights)
from sr_torch.quant import (
    activation_scale, quantize_activation, quantize_activation_static,
    quantize_kernel)

torch.set_num_threads(1)

SHAPES = [(3, 64, 3),    # EDSR's head
          (64, 64, 3),   # body
          (64, 256, 3),  # PS conv
          (64, 3, 3),    # out conv
          (64, 48, 7),   # the fused-quant tail's composite conv
          (3, 3, 7)]


def _x(rng, c, scale):
    """(2, 6, 7, c) float32 with half-step ties and saturating pixels when
    ``scale`` (a power of two, per tensor or per channel) is given."""
    x = (rng.standard_normal((2, 6, 7, c)) * 2).astype(np.float32)
    if scale is not None:
        steps = (np.arange(7 * c).reshape(7, c) % 41 - 20) + 0.5
        x[:, 0] = (steps * scale).astype(np.float32)
        x[:, -1, 0] = 300.0 * scale
        x[:, -1, -1] = -300.0 * scale
    return x


def _static_scale(rng, mode, c):
    if mode == "per_tensor":
        return 2.0 ** -4
    if mode == "per_channel":
        return (2.0 ** -rng.integers(3, 6, c)).astype(np.float32)
    return None


@pytest.mark.parametrize("c,n,k", SHAPES)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mode", ["per_tensor", "per_channel", "dynamic"])
def test_fused_entry_equals_unfused_sequence(mode, bias, c, n, k):
    """The fused entry equals quantize → exact int32 conv → f32 rescale →
    bias, each a pass of its own, as the int8 sites ran them before."""
    rng = np.random.default_rng(c + n + k)
    s = _static_scale(rng, mode, c)
    x = torch.from_numpy(_x(rng, c, s))
    q_w, s_w = quantize_kernel(torch.from_numpy(
        (rng.standard_normal((k, k, c, n)) * 0.1).astype(np.float32)))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    b = b if bias else None
    if s is None:
        q_x, s_x = quantize_activation(x)
        scale, dequant = activation_scale(x), s_x * s_w
    else:
        scale = torch.from_numpy(np.asarray(s, np.float32))
        q_x, _ = quantize_activation_static(x, scale)
        dequant = s_w * (scale if scale.dim() == 0 else 1.0)
    want = conv_int8_im2col(q_x, q_w).to(torch.float32) * dequant
    if b is not None:
        want = want + b
    got = conv_int8_fused(x, q_w, scale, dequant, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,n,k", SHAPES)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mode", ["per_tensor", "per_channel", "dynamic"])
def test_int8_conv_through_fused_entry_equals_jax(mode, bias, c, n, k):
    """``sr_torch.quant.int8_conv`` (which calls the fused entry) equals
    ``sr.quant.int8_conv`` bit for bit on the same conv and scale."""
    rng = np.random.default_rng(100 + c + n + k)
    s = _static_scale(rng, mode, c)
    x = _x(rng, c, s)
    kernel = (rng.standard_normal((k, k, c, n)) * 0.1).astype(np.float32)
    bias_np = rng.standard_normal(n).astype(np.float32)
    params = {"kernel": jnp.asarray(kernel)}
    if bias:
        params["bias"] = jnp.asarray(bias_np)
    jconv = fnn.Conv(n, (k, k), padding="SAME", use_bias=bias).bind(
        {"params": params})
    want = np.asarray(jax_int8_conv(jnp.asarray(x), jconv, s))

    tconv = torch.nn.Conv2d(c, n, k, padding=k // 2, bias=bias)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        if bias:
            tconv.bias.copy_(torch.from_numpy(bias_np))
    got = quant.int8_conv(torch.from_numpy(x).permute(0, 3, 1, 2), tconv, s)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_pack_weights_layout():
    """(k, k, C, N) → (k, k, N, Cp): C padded with zeros to a 64-byte
    chunk (64 int8, 32 bf16), each output channel's K run contiguous."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 5))
                         .astype(np.int8))
    p = pack_weights(w)
    assert p.shape == (3, 3, 5, 64) and p.is_contiguous()
    assert torch.equal(p[..., :3], w.permute(0, 1, 3, 2))
    assert not p[..., 3:].any()
    wb = torch.randn((7, 7, 40, 6)).to(torch.bfloat16)
    pb = pack_weights(wb)
    assert pb.shape == (7, 7, 6, 64)
    assert torch.equal(pb[..., :40], wb.permute(0, 1, 3, 2))


def test_fused_entry_refuses_bad_operands():
    x = torch.zeros((1, 4, 4, 8))
    q_w = torch.zeros((3, 3, 8, 4), dtype=torch.int8)
    before = conv_int8_fused.launches
    with pytest.raises(TypeError, match="float32 x"):
        conv_int8_fused(x.bfloat16(), q_w, torch.tensor(1.0),
                        torch.ones(4))
    with pytest.raises(ValueError, match="C_in"):
        conv_int8_fused(torch.zeros((1, 4, 4, 6)), q_w, torch.tensor(1.0),
                        torch.ones(4))
    conv_int8_fused(x, q_w, torch.tensor(1.0), torch.ones(4))
    assert conv_int8_fused.launches == before  # no kernel on the CPU
