"""Carry weights between the JAX package's params and a port module.

The port keeps its own copy of the mapping that ``sr/utils/torch_interop.py``
applies. A flax param path maps one-to-one onto a torch module path: list
indices join their list's name with ``_`` (``blocks.0.Conv_0`` ↔
``blocks_0/Conv_0``), conv kernels go from flax HWIO to torch OIHW, a
transposed conv's kernel from flax's unflipped HW-in-out to torch's
``(in, out, kh, kw)`` flipped in space (``sr/utils/torch_interop.py``: a
torch ``ConvTranspose2d`` transposes a cross-correlation, flax's
``ConvTranspose`` correlates the dilated input with the kernel as it is),
dense
kernels from flax (in, out) to torch's (out, in) ``nn.Linear`` weight, and
biases are copied as they are. A parameter that belongs to no conv or dense
layer (DRCN's ``recursion_weights``, a PReLU's ``slope``, a batch norm's
``scale`` and ``bias``) is a bare leaf of the tree at its module's path,
copied as it is. A batch norm's running ``mean`` and ``var`` are the
module's buffers and the leaves of flax's ``batch_stats`` collection, at
the same paths.
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


_LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _to_torch_kernel(kernel: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """flax HWIO → OIHW; a transposed conv's HWIO → its spatial flip as
    (in, out, kh, kw); a dense (in, out) → (out, in)."""
    if isinstance(layer, nn.ConvTranspose2d):
        return kernel.flip(0, 1).permute(2, 3, 0, 1)
    return kernel.permute(3, 2, 0, 1) if kernel.dim() == 4 else kernel.T


def _to_flax_kernel(weight: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    if isinstance(layer, nn.ConvTranspose2d):
        return weight.permute(2, 3, 0, 1).flip(0, 1)
    return weight.permute(2, 3, 1, 0) if weight.dim() == 4 else weight.T


def _layers(model: nn.Module):
    """(flax path, module) of every conv and dense layer."""
    for name, m in model.named_modules():
        if isinstance(m, _LAYERS):
            yield flax_path(name), m


def _bare(model: nn.Module, buffers: bool):
    """(flax path, tensor) of every parameter that no conv or dense layer
    owns, or with ``buffers`` of every buffer (the batch statistics)."""
    for name, m in model.named_modules():
        if isinstance(m, _LAYERS):
            continue
        prefix = flax_path(name) if name else ()
        leaves = (m.named_buffers(recurse=False) if buffers
                  else m.named_parameters(recurse=False))
        for leaf, p in leaves:
            yield prefix + (leaf,), p


def has_batch_stats(model: nn.Module) -> bool:
    return next(_bare(model, buffers=True), None) is not None


def _leaf_paths(tree: dict, prefix=()) -> set[tuple[str, ...]]:
    paths = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            paths |= _leaf_paths(v, prefix + (k,))
        else:
            paths.add(prefix + (k,))
    return paths


def _copy_leaves(tree: dict, leaves, what: str) -> set:
    """Copy each ``(path, tensor)`` of ``leaves`` from ``tree``; return the
    paths used."""
    used = set()
    for path, p in leaves:
        node = tree
        for k in path:
            node = node[k]
        value = torch.from_numpy(np.array(node, np.float32))
        if value.shape != p.shape:
            raise ValueError(f"{what} {'/'.join(path)}: {tuple(value.shape)} "
                             f"does not fit {tuple(p.shape)}")
        p.copy_(value)
        used.add(path)
    return used


def _check_used(tree: dict, used: set, what: str) -> None:
    extra = _leaf_paths(tree) - used
    if extra:
        raise ValueError(f"{what} the model has no place for: "
                         + ", ".join("/".join(p) for p in sorted(extra)))


def from_jax_params(model: nn.Module, params: dict,
                    batch_stats: dict | None = None) -> nn.Module:
    """Load the JAX package's nested params dict (numpy arrays, as
    ``load_params`` returns it), and the ``batch_stats`` of a model with
    batch norms, into ``model`` in place, and return it.

    Raises ``KeyError``/``ValueError`` if a param or statistic is missing,
    left over, or of the wrong shape, and if ``batch_stats`` is missing
    for a model with batch norms or given for one without. Modules with a
    ``packed()`` cache (``ResnetBlock``) repack their fused-kernel operands
    from the loaded weights.
    """
    if has_batch_stats(model) != (batch_stats is not None):
        raise ValueError(
            "batch_stats must be given exactly for a model with batch norms"
            f" (this one has {'some' if has_batch_stats(model) else 'none'})")
    used = set()
    with torch.no_grad():
        for path, layer in _layers(model):
            node = params
            for p in path:
                node = node[p]
            kernel = torch.from_numpy(np.array(node["kernel"], np.float32))
            weight = _to_torch_kernel(kernel, layer)
            if weight.shape != layer.weight.shape:
                raise ValueError(f"{'/'.join(path)}/kernel: flax "
                                 f"{tuple(kernel.shape)} does not fit torch "
                                 f"{tuple(layer.weight.shape)}")
            layer.weight.copy_(weight)
            used.add(path + ("kernel",))
            if layer.bias is not None:
                layer.bias.copy_(torch.from_numpy(
                    np.array(node["bias"], np.float32)))
                used.add(path + ("bias",))
        used |= _copy_leaves(params, _bare(model, buffers=False), "param")
        _check_used(params, used, "params")
        if batch_stats is not None:
            _check_used(batch_stats, _copy_leaves(
                batch_stats, _bare(model, buffers=True), "batch_stats"),
                "batch_stats")
    for m in model.modules():
        if hasattr(m, "packed"):
            m.packed()
    return model


def _put(tree: dict, leaves) -> dict:
    """Add each ``(path, tensor)`` of ``leaves`` to ``tree`` as numpy."""
    for path, p in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = p.detach().cpu().numpy().copy()
    return tree


def to_jax_params(model: nn.Module) -> dict:
    """The nested params dict (numpy, HWIO kernels) of ``model``: the
    inverse of :func:`from_jax_params`, ready for ``save_params``."""
    params: dict = {}
    for path, layer in _layers(model):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node["kernel"] = _to_flax_kernel(layer.weight.detach(),
                                         layer).cpu().numpy().copy()
        if layer.bias is not None:
            node["bias"] = layer.bias.detach().cpu().numpy().copy()
    return _put(params, _bare(model, buffers=False))


def to_jax_batch_stats(model: nn.Module) -> dict | None:
    """The nested ``batch_stats`` dict (numpy) of ``model``'s batch norms,
    ``{path: {"mean", "var"}}`` as flax keeps them; None without any."""
    if not has_batch_stats(model):
        return None
    return _put({}, _bare(model, buffers=True))
