"""The int8 conv kernel's weight packing, checked on the CPU.

``pack_conv_weights`` lays the HWIO weights out as the CUDA kernel keeps
them resident in shared memory (``sr_torch/kernels/csrc/int8_conv.cu``):
chunks of up to 64 output channels, each (tap, 32-byte K step) block in
wgmma's K-major core-matrix layout, with K per tap (class 1) or per tap
row, the (dx, c) run of k pixels (class 2, few channels). These tests
unpack it with an unpacker of their own, written from the byte layout, and
contract the quantized input in the packed K order with plain integer
arithmetic: that contraction must equal ``conv_int8_plain`` bit for bit,
and at k = 3 the JAX package's ``conv3x3_int8_im2col`` (Pallas, interpret
mode) too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.kernels.int8_conv import conv3x3_int8_im2col
from sr_torch.kernels.int8_conv import (
    conv_class, conv_int8_plain, conv_layout, pack_weights)

torch.set_num_threads(1)

# (C, k, N): every C in {1, 3, 12, 32, 56, 64, 256}, k in {1, 3, 5, 7, 9}
# and N in {1, 3, 4, 12, 48, 64, 256}, pruned to the port's sites and the
# classes' edges
CASES = [
    (1, 9, 64),    # SRCNN conv 1: tap-packed, 9 K steps for 81 taps
    (1, 5, 64),    # ESPCN conv 1
    (1, 3, 4),     # LapSRN's image deconv, phase-packed
    (3, 9, 64),    # SRResNet's head
    (3, 3, 64),    # EDSR's head
    (3, 7, 3),
    (8, 3, 16),    # 8 bytes a pixel: the last tap-packed C
    (12, 3, 12),   # FSRCNN's map: per tap, 12 bytes a pixel
    (12, 1, 56),   # FSRCNN's expand: k = 1 is per-tap
    (12, 5, 4),
    (32, 3, 16),   # ESPCN conv 3
    (32, 5, 1),    # SRCNN conv 3
    (56, 1, 12),   # FSRCNN's shrink
    (56, 3, 16),   # FSRCNN's deconv, phase-packed
    (64, 3, 64),   # the body
    (64, 3, 1),    # VDSR's last conv
    (64, 3, 3),    # EDSR's exact out conv
    (64, 7, 48),   # the fused-quant tail
    (64, 9, 3),    # SRResNet's exact out conv
    (64, 3, 256),  # the PS convs: four chunks
    (256, 5, 12),  # SRResNet's folded out conv
]


def _unpack(packed: np.ndarray, k: int, c: int, n: int, dtype) -> tuple:
    """The packed weights → (taps, kp, N) in the packed K order, from the
    byte layout: chunk i of ``nch`` outputs (the last one ``last_w``
    wide) holds per tap t and K step s an (nw × 32 bytes) block; row r,
    half h and byte j of it lie at r * 32 + (h ^ (r // 4 % 2)) * 16 + j
    (the 32-byte swizzle)."""
    lay = conv_layout(k, c, n, dtype)
    es = 2 if dtype == torch.bfloat16 else 1
    half = 16 // es  # elements of a 16-byte half
    mat = np.zeros((lay.taps, lay.kp, n), packed.dtype)
    base = 0
    for i in range(lay.nchunks):
        nw = lay.nch if i + 1 < lay.nchunks else lay.last_w
        for t in range(lay.taps):
            for s in range(lay.ks):
                blk = base + (t * lay.ks + s) * nw * 2 * half
                for r in range(min(nw, n - lay.nch * i)):
                    for h in range(2):
                        at = blk + r * 2 * half + (h ^ (r // 4 % 2)) * half
                        mat[t, s * 2 * half + h * half:
                            s * 2 * half + (h + 1) * half,
                            lay.nch * i + r] = packed[at:at + half]
        base += lay.taps * lay.ks * nw * 2 * half
    assert base == packed.size == lay.numel
    return mat, lay


def _packed_contraction(q_x: np.ndarray, mat: np.ndarray, k: int,
                        tap_packed: bool) -> np.ndarray:
    """out[b, y, x, n] = Σ over taps and the packed K of A · B in int64, A
    the zero-padded input gathered in the packed K order: per tap (dy, dx)
    its pixel's channels, or per tap row dy the k·C bytes of pixels
    x - k/2 ... x + k/2."""
    b, h, w, c = q_x.shape
    r = k // 2
    xp = np.zeros((b, h + 2 * r, w + 2 * r, c), np.int64)
    xp[:, r:r + h, r:r + w] = q_x
    kp = mat.shape[1]
    out = np.zeros((b, h, w, mat.shape[2]), np.int64)
    for t in range(mat.shape[0]):
        if tap_packed:
            run = np.concatenate([xp[:, t:t + h, dx:dx + w]
                                  for dx in range(k)], axis=-1)
        else:
            dy, dx = divmod(t, k)
            run = xp[:, dy:dy + h, dx:dx + w]
        a = np.zeros((b, h, w, kp), np.int64)
        a[..., :run.shape[-1]] = run
        out += np.einsum("bhwk,kn->bhwn", a, mat[t].astype(np.int64))
    return out


@pytest.mark.parametrize("c,k,n", CASES)
def test_pack_round_trips_and_contracts_like_the_conv(c, k, n):
    rng = np.random.default_rng(c * 100 + k * 10 + n)
    q_w = rng.integers(-127, 128, (k, k, c, n)).astype(np.int8)
    q_x = rng.integers(-127, 128, (2, 5, 6, c)).astype(np.int8)
    packed = pack_weights(torch.from_numpy(q_w))
    assert packed.dim() == 1 and packed.dtype == torch.int8
    mat, lay = _unpack(packed.numpy(), k, c, n, torch.int8)
    assert lay.tap_packed == (conv_class(k, c) == "tap-packed")
    assert lay.tap_packed == (k > 1 and c <= 8)
    # round trip: the real K of each tap back to HWIO, zero past it
    real = lay.kbytes
    assert not mat[:, real:].any()
    back = mat[:, :real].reshape(k, k, c, n)
    np.testing.assert_array_equal(back, q_w)
    got = _packed_contraction(q_x, mat, k, lay.tap_packed)
    want = conv_int8_plain(torch.from_numpy(q_x), torch.from_numpy(q_w))
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    if k == 3:
        jax_out = np.asarray(conv3x3_int8_im2col(
            jnp.asarray(q_x), jnp.asarray(q_w), interpret=True))
        np.testing.assert_array_equal(got, jax_out.astype(np.int64))


@pytest.mark.parametrize("c,k,n", [(3, 3, 64), (4, 5, 12), (8, 5, 12),
                                   (9, 3, 3), (40, 7, 6), (64, 1, 256),
                                   (64, 7, 48)])
def test_pack_bf16_round_trips(c, k, n):
    """bf16 weights: a K step holds 16 elements; tap-packed at C <= 4. At
    7×7 over 64 channels a 48-wide chunk would not fit: chunks of 16."""
    g = torch.Generator().manual_seed(c + k + n)
    w = torch.randn((k, k, c, n), generator=g).to(torch.bfloat16)
    packed = pack_weights(w)
    mat, lay = _unpack(packed.view(torch.int16).numpy(), k, c, n,
                       torch.bfloat16)
    assert lay.tap_packed == (k > 1 and c <= 4)
    real = lay.kbytes // 2
    assert not mat[:, real:].any()
    back = torch.from_numpy(mat[:, :real].reshape(k, k, c, n)).view(
        torch.bfloat16)
    assert torch.equal(back, w)


def test_layout_sizes_at_the_port_sites():
    """K steps and resident bytes of the sites the design note names."""
    body = conv_layout(3, 64, 64, torch.int8)
    assert (body.tap_packed, body.ks, body.numel) == (False, 2, 36864)
    tail = conv_layout(7, 64, 48, torch.int8)
    assert (tail.ks, tail.last_w, tail.numel) == (2, 48, 150528)
    srcnn = conv_layout(9, 1, 64, torch.int8)
    assert (srcnn.tap_packed, srcnn.taps * srcnn.ks) == (True, 9)
    head = conv_layout(3, 3, 64, torch.int8)
    assert (head.tap_packed, head.taps * head.ks) == (True, 3)
    ps = conv_layout(3, 64, 256, torch.int8)
    assert (ps.nch, ps.nchunks, ps.numel) == (64, 4, 147456)
    bf_tail = conv_layout(7, 64, 48, torch.bfloat16)
    assert (bf_tail.nch, bf_tail.nchunks, bf_tail.ks) == (16, 3, 4)
    out = conv_layout(3, 64, 3, torch.int8)
    assert (out.last_w, out.numel) == (8, 4608)
