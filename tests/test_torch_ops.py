"""The port's kernels as registered operators (``sr_torch/kernels/ops.py``):
``torch.library.opcheck`` on every operator with CPU tensors (schema,
autograd registration, the fake implementation against the real one,
AOT dispatch at dynamic shapes), the shuffle's registered backward against
autograd of its plain version, the resblock's device-independent ``wgmma``
operand layout, the wrappers' refusals, and ``torch.export`` tracing each
operator at a symbolic batch.

CPU tensors take each operator's plain version; the CUDA implementations
are held to the same on the card by ``tests/test_torch_export_cuda.py``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from sr_torch.kernels import ops
from sr_torch.kernels.fused_resblock import (
    fused_resblock, fused_resblock_plain, pack_wgmma_weights, pack_weights)
from sr_torch.kernels.int8_conv import pack_weights as pack_conv

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPS = ("depth_to_space", "fused_resblock", "conv_int8_im2col",
       "conv_bf16_im2col", "conv_int8_fused")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _d2s_args(dtype, act, with_bias, seed=0, shape=(2, 3, 5, 16)):
    g = _gen(seed)
    if dtype == torch.uint8:
        x = torch.randint(0, 256, shape, generator=g).to(dtype)
    else:
        x = torch.randn(shape, generator=g).to(dtype)
    bias = (torch.randn(shape[-1], generator=g).to(dtype) if with_bias
            else None)
    return x, 2, act, bias


def _resblock_args(dtype, layout, c=16, seed=1, res_scale=0.5):
    g = _gen(seed)
    w1, w2 = (torch.randn((c, c, 3, 3), generator=g) * 0.1 for _ in "ab")
    w1, b1, w2, b2 = pack_weights(w1, torch.randn(c, generator=g), w2,
                                  torch.randn(c, generator=g))
    w1, w2 = w1.to(dtype), w2.to(dtype)
    if layout == "wgmma":
        w1, w2 = pack_wgmma_weights(w1), pack_wgmma_weights(w2)
    x = torch.randn((2, 6, 5, c), generator=g).to(dtype)
    return x, w1, b1, w2, b2, res_scale


def _conv_args(seed=2, c=8, n=6, k=3):
    g = _gen(seed)
    q_x = torch.randint(-127, 128, (2, 5, 4, c), generator=g).to(torch.int8)
    q_w = torch.randint(-127, 128, (k, k, c, n), generator=g).to(torch.int8)
    return q_x, q_w


def _fused_args(mode, seed=3, c=8, n=6):
    g = _gen(seed)
    _, q_w = _conv_args(seed, c, n)
    x = torch.randn((2, 5, 4, c), generator=g) * 2
    s_w = torch.rand(n, generator=g) * 1e-3 + 1e-4
    if mode == "per_channel":
        scale, dequant = torch.rand(c, generator=g) * 0.05 + 0.01, s_w
    elif mode == "per_tensor":
        scale = torch.tensor(2.0 ** -4)
        dequant = scale * s_w
    else:  # per sample, dynamic
        scale = torch.rand((2, 1, 1, 1), generator=g) * 0.05 + 0.01
        dequant = scale * s_w
    bias = torch.randn(n, generator=g) if mode != "per_sample" else None
    return x, q_w, scale, dequant, bias, mode == "per_tensor", pack_conv(q_w)


CASES = [
    ("depth_to_space", _d2s_args(torch.float32, None, False)),
    ("depth_to_space", _d2s_args(torch.float32, "relu", True)),
    ("depth_to_space", _d2s_args(torch.bfloat16, None, True)),
    ("depth_to_space", _d2s_args(torch.uint8, None, False)),
    ("fused_resblock", _resblock_args(torch.float32, "9CxC")),
    ("fused_resblock", _resblock_args(torch.bfloat16, "wgmma")),
    ("fused_resblock", _resblock_args(torch.bfloat16, "9CxC")),
    ("conv_int8_im2col", _conv_args()),
    ("conv_bf16_im2col", tuple(t.to(torch.bfloat16) for t in _conv_args())),
    ("conv_int8_fused", _fused_args("per_channel")),
    ("conv_int8_fused", _fused_args("per_tensor")),
    ("conv_int8_fused", _fused_args("per_sample")),
]


@pytest.mark.parametrize("name,args", CASES, ids=[
    "d2s-f32", "d2s-f32-relu-bias", "d2s-bf16-bias", "d2s-u8",
    "resblock-f32", "resblock-bf16-wgmma", "resblock-bf16-9CxC", "int8-raw",
    "bf16-raw", "int8-fused-per-channel", "int8-fused-per-tensor",
    "int8-fused-per-sample"])
def test_opcheck(name, args):
    """Schema, autograd registration, fake against real, and AOT dispatch
    at dynamic shapes: every check SUCCESS."""
    op = getattr(torch.ops.sr_torch, name).default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_opcheck_shuffle_with_grad():
    x, r, act, bias = _d2s_args(torch.float32, "relu", True, seed=4)
    args = (x.requires_grad_(), r, act, bias.requires_grad_())
    result = torch.library.opcheck(torch.ops.sr_torch.depth_to_space.default,
                                   args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_kernel_entry_is_a_registered_operator():
    for name in OPS:
        op = getattr(torch.ops.sr_torch, name).default
        assert op.name() == f"sr_torch::{name}"


@pytest.mark.parametrize("act", [None, "relu"])
def test_shuffle_backward_equals_autograd_of_plain(act):
    """The registered backward (the mask, the transpose and the bias sum)
    equals autograd through the plain reshape-permute, bit for bit."""
    x, r, _, bias = _d2s_args(torch.float32, act, True, seed=5)
    grad = torch.randn((2, 6, 10, 4), generator=_gen(6))
    xa, ba = x.clone().requires_grad_(), bias.clone().requires_grad_()
    ops.depth_to_space(xa, r, act, ba).backward(grad)
    xb, bb = x.clone().requires_grad_(), bias.clone().requires_grad_()
    ops.depth_to_space_plain(xb, r, act, bb).backward(grad)
    assert torch.equal(xa.grad, xb.grad) and torch.equal(ba.grad, bb.grad)


def test_resblock_wgmma_layout_on_the_cpu_equals_the_operands():
    """A bf16 block's ``wgmma`` layout (what a program carries to any
    device) gives the CPU's plain block the same result as the (9·C, C)
    operands it packs; unpacking inverts the packing."""
    for c in (16, 64):
        x, w1, b1, w2, b2, s = _resblock_args(torch.bfloat16, "9CxC", c=c)
        packed = (pack_wgmma_weights(w1), b1, pack_wgmma_weights(w2), b2)
        assert torch.equal(ops.unpack_wgmma_weights(packed[0], c), w1)
        assert torch.equal(fused_resblock(x, *packed, res_scale=s),
                           fused_resblock_plain(x, w1, b1, w2, b2, s))


def test_cpu_launches_no_kernel_and_other_devices_raise():
    before = (ops.depth_to_space.launches, ops.fused_resblock.launches,
              ops.conv_int8_fused.launches)
    ops.depth_to_space(*_d2s_args(torch.float32, None, True))
    ops.fused_resblock(*_resblock_args(torch.float32, "9CxC"))
    x, q_w, scale, dequant, bias, rec, packed = _fused_args("per_channel")
    ops.conv_int8_fused(x, q_w, scale, dequant, bias, reciprocal=rec,
                        packed=packed)
    assert (ops.depth_to_space.launches, ops.fused_resblock.launches,
            ops.conv_int8_fused.launches) == before
    meta = torch.zeros((1, 2, 2, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.depth_to_space(meta, 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.fused_resblock(meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.conv_int8_fused(meta, torch.zeros((3, 3, 4, 4), dtype=torch.int8,
                                              device="meta"), meta, meta)


def test_wrappers_refuse_what_no_implementation_takes():
    with pytest.raises(ValueError, match="activation"):
        ops.depth_to_space(torch.zeros((1, 2, 2, 4)), 2, "gelu")
    with pytest.raises(ValueError, match="divide"):
        ops.depth_to_space(torch.zeros((1, 2, 2, 6)), 2)
    with pytest.raises(ValueError, match="no bias for uint8"):
        ops.depth_to_space(torch.zeros((1, 2, 2, 4), dtype=torch.uint8), 2,
                           bias=torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="odd square"):
        ops.conv_int8_im2col(torch.zeros((1, 4, 4, 8), dtype=torch.int8),
                             torch.zeros((2, 2, 8, 8), dtype=torch.int8))
    with pytest.raises(TypeError, match="float32 x"):
        ops.conv_int8_fused(torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16),
                            torch.zeros((3, 3, 8, 8), dtype=torch.int8),
                            torch.ones(()), torch.ones(8))


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self._fn = (fn,)

    def forward(self, x):
        return self._fn[0](x)


@pytest.mark.parametrize("name", OPS)
def test_each_operator_exports_at_a_symbolic_batch(name):
    """Each operator traces into an exported program at a symbolic batch
    (its fake implementation) and the program equals the eager call at
    batches 1 and 3."""
    if name == "depth_to_space":
        _, r, act, bias = _d2s_args(torch.float32, "relu", True)
        fn = lambda x: ops.depth_to_space(x, r, act, bias)  # noqa: E731
        shape = (2, 3, 5, 16)
    elif name == "fused_resblock":
        _, w1, b1, w2, b2, s = _resblock_args(torch.bfloat16, "wgmma")
        fn = lambda x: ops.fused_resblock(  # noqa: E731
            x.to(torch.bfloat16), w1, b1, w2, b2, s)
        shape = (2, 6, 5, 16)
    elif name == "conv_int8_fused":
        _, q_w, scale, dequant, bias, rec, packed = _fused_args(
            "per_channel")
        fn = lambda x: ops.conv_int8_fused(  # noqa: E731
            x, q_w, scale, dequant, bias, reciprocal=rec, packed=packed)
        shape = (2, 5, 4, 8)
    else:
        raw = getattr(ops, name)
        dtype = torch.int8 if "int8" in name else torch.bfloat16
        _, q_w = _conv_args()
        fn = lambda x: raw(x.to(dtype), q_w.to(dtype))  # noqa: E731
        shape = (2, 5, 4, 8)
    example = torch.randn(shape, generator=_gen(7)) * 3
    ep = torch.export.export(_Call(fn), (example,),
                             dynamic_shapes=({0: torch.export.Dim(
                                 "b", min=1)},), strict=False)
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert getattr(torch.ops.sr_torch, name).default in targets
    for b in (1, 3):
        x = torch.randn((b, *shape[1:]), generator=_gen(b)) * 3
        assert torch.equal(ep.module()(x), fn(x))


def test_the_operator_library_imports_only_torch_ctypes_and_build():
    """Loading an exported program imports ops.py: it stays free of the
    rest of the port."""
    tree = ast.parse((ROOT / "sr_torch/kernels/ops.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {f"{node.module}.{a.name}" for a in node.names}
    allowed = {"__future__.annotations", "contextlib", "ctypes", "functools",
               "torch", "torch.nn.functional", "sr_torch.kernels._build"}
    assert names <= allowed, names - allowed


def test_plain_versions_match_numpy_references():
    """The CPU implementations, independently of the port's own plain
    helpers: the shuffle as a numpy reshape-transpose, the int8 raw
    conv as an exact integer correlation."""
    x, r, _, _ = _d2s_args(torch.float32, None, False, seed=8)
    b, h, w, cin = x.shape
    c = cin // 4
    want = x.numpy().reshape(b, h, w, c, r, r).transpose(
        0, 1, 4, 2, 5, 3).reshape(b, h * r, w * r, c)
    np.testing.assert_array_equal(
        torch.ops.sr_torch.depth_to_space(x, r, None, None).numpy(), want)
    q_x, q_w = _conv_args(seed=9)
    xp = np.pad(q_x.numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1),
                                                (0, 0)))
    want = sum(np.einsum("bhwc,cn->bhwn",
                         xp[:, dy:dy + 5, dx:dx + 4], q_w.numpy()[dy, dx]
                         .astype(np.int64))
               for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(
        torch.ops.sr_torch.conv_int8_im2col(q_x, q_w).numpy(), want)
