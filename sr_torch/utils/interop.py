"""Carry weights between the JAX package's params and a port module.

The port keeps its own copy of the mapping that ``sr/utils/torch_interop.py``
applies. A flax param path maps one-to-one onto a torch module path: list
indices join their list's name with ``_`` (``blocks.0.Conv_0`` ↔
``blocks_0/Conv_0``), conv kernels go from flax HWIO to torch OIHW, and
biases are copied as they are. Only convs occur in this slice's models.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flax_path(torch_name: str) -> tuple[str, ...]:
    """``blocks.0.Conv_0`` → ``("blocks_0", "Conv_0")``."""
    out: list[str] = []
    for part in torch_name.split("."):
        if part.isdigit():
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return tuple(out)


def _convs(model: nn.Module):
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            yield flax_path(name), m


def _leaf_paths(tree: dict, prefix=()) -> set[tuple[str, ...]]:
    paths = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            paths |= _leaf_paths(v, prefix + (k,))
        else:
            paths.add(prefix + (k,))
    return paths


def from_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Load the JAX package's nested params dict (numpy arrays, as
    ``load_params`` returns it) into ``model`` in place, and return it.

    Raises ``KeyError``/``ValueError`` if a param is missing, left over, or
    of the wrong shape. Modules with a ``packed()`` cache (``ResnetBlock``)
    repack their fused-kernel operands from the loaded weights.
    """
    used = set()
    with torch.no_grad():
        for path, conv in _convs(model):
            node = params
            for p in path:
                node = node[p]
            kernel = torch.from_numpy(np.array(node["kernel"], np.float32))
            weight = kernel.permute(3, 2, 0, 1)
            if weight.shape != conv.weight.shape:
                raise ValueError(f"{'/'.join(path)}/kernel: HWIO "
                                 f"{tuple(kernel.shape)} does not fit OIHW "
                                 f"{tuple(conv.weight.shape)}")
            conv.weight.copy_(weight)
            used.add(path + ("kernel",))
            if conv.bias is not None:
                conv.bias.copy_(torch.from_numpy(
                    np.array(node["bias"], np.float32)))
                used.add(path + ("bias",))
    extra = _leaf_paths(params) - used
    if extra:
        raise ValueError("params the model has no place for: "
                         + ", ".join("/".join(p) for p in sorted(extra)))
    for m in model.modules():
        if hasattr(m, "packed"):
            m.packed()
    return model


def to_jax_params(model: nn.Module) -> dict:
    """The nested params dict (numpy, HWIO kernels) of ``model``: the
    inverse of :func:`from_jax_params`, ready for ``save_params``."""
    params: dict = {}
    for path, conv in _convs(model):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node["kernel"] = (conv.weight.detach().permute(2, 3, 1, 0)
                          .cpu().numpy().copy())
        if conv.bias is not None:
            node["bias"] = conv.bias.detach().cpu().numpy().copy()
    return params
