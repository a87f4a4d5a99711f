"""Params-only export in the JAX package's ``.npz`` format, numpy only.

Port of ``sr/utils/checkpoint.py:save_params``/``load_params``: one array
per leaf of the nested params dict, keyed by its path joined with ``/``
under ``params/`` (and ``batch_stats/``), for example
``params/blocks_0/Conv_0/kernel`` holding an HWIO kernel. A file written by
either package loads in the other. ``sr_torch.utils.interop`` moves such a
dict into and out of a port module.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np


def _flatten(tree: dict, prefix: tuple) -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat["/".join(prefix + (k,))] = np.asarray(v)
    return flat


def save_params(path: str, params: Any) -> None:
    """Write the nested ``params`` dict as a flat .npz (batch-norm
    statistics join with the models that have them)."""
    flat = _flatten(params, ("params",))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_params(path: str) -> tuple[dict, dict | None]:
    """Inverse of :func:`save_params` → (params, batch_stats | None)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree.get("params", {}), tree.get("batch_stats")
