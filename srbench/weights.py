"""The benchmark's model weights, made on the device from ``--seed``.

One normal draw on the card for all weights, cut into leaves and scaled
by each leaf's initializer (``init`` in the reference's ``params``):

* ``he`` / ``lecun``: N(0, 2/fan_in) / N(0, 1/fan_in), fan_in of an HWIO
  kernel; ``branch``: a residual branch's last conv at 0.2·lecun, so the
  trunk grows slowly through the blocks, as in a trained net;
* ``bias``: N(0, 0.02²); ``slope``: PReLU 0.2 + N(0, 0.05²);
  ``bn_scale`` 1 + N(0, 0.1²), ``bn_branch_scale`` 0.2·that, ``bn_bias``
  N(0, 0.05²).

Two steps then read the traffic's first image (a centre crop), so that the
weights do real work on image-like input: each batch norm's running
statistics are its input's channel mean and variance, perturbed from the
seed (mean + 0.1·std·N, var·exp(0.2·N)), taken in one forward in the
order the norms run; and the output conv is scaled per channel to give
outputs of mean 0.4–0.5 and standard deviation 0.2, inside the u8 range.
Both run in float32 with TF32 off. The weights are then the same for the
program and the reference.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from srbench.reference.common import conv, full_fp32


def derived_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of draws (weights, frames, order...),
    so streams never share numbers and any whole ``seed`` works."""
    digest = hashlib.sha256(f"srbench/{stream}/{seed}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(seed, stream))
    return g


def _fan_in(shape) -> int:
    return math.prod(shape[:3])


_INIT = {
    "he": lambda z, s: z * math.sqrt(2.0 / _fan_in(s)),
    "lecun": lambda z, s: z * math.sqrt(1.0 / _fan_in(s)),
    "out": lambda z, s: z * math.sqrt(1.0 / _fan_in(s)),
    "branch": lambda z, s: z * 0.2 * math.sqrt(1.0 / _fan_in(s)),
    "bias": lambda z, s: z * 0.02,
    "slope": lambda z, s: 0.2 + 0.05 * z,
    "bn_scale": lambda z, s: 1.0 + 0.1 * z,
    "bn_branch_scale": lambda z, s: 0.2 * (1.0 + 0.1 * z),
    "bn_bias": lambda z, s: 0.05 * z,
}


def make(ref, cfg: dict, seed: int, device, crop: torch.Tensor
         ) -> tuple[dict, dict]:
    """``(params, stats)`` of the reference module ``ref``'s model at
    ``cfg``, float32 on ``device``; ``crop``: an NHWC float image in
    [0, 1] on ``device`` that the two data steps read."""
    g = generator(seed, "weights", device)
    spec = ref.params(cfg)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    params = {path: _INIT[init](z.view(shape), shape)
              for (path, shape, init), z in zip(spec, flat.split(sizes))}
    st = {path: (torch.zeros(shape, device=device) if path.endswith("/mean")
                 else torch.ones(shape, device=device))
          for path, shape in ref.stats(cfg)}

    def estimate(path, x):
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = torch.randn((2, mean.numel()), generator=g, device=device)
        st[f"{path}/mean"] = mean + 0.1 * var.sqrt() * n[0]
        st[f"{path}/var"] = var * torch.exp(0.2 * n[1])

    with torch.no_grad(), full_fp32():
        h = ref.features(params, st, crop, cfg, estimate)
        kernel = params[f"{ref.OUT_CONV}/kernel"]
        y = conv(h, kernel, None)
        mean, std = y.mean(dim=(0, 2, 3)), y.std(dim=(0, 2, 3))
        target = 0.4 + 0.1 * torch.rand(mean.shape, generator=g,
                                        device=device)
        gain = 0.2 / torch.clamp_min(std, 1e-6)
        params[f"{ref.OUT_CONV}/kernel"] = kernel * gain.view(1, 1, 1, -1)
        params[f"{ref.OUT_CONV}/bias"] = target - mean * gain
    return params, st


def nested(flat: dict) -> dict:
    """``{"a/b/kernel": t}`` → ``{"a": {"b": {"kernel": ndarray}}}``, the
    tree the serving format loads into."""
    tree: dict = {}
    for path, t in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def write_npz(path: str, params: dict, stats: dict) -> None:
    """The weights as a params ``.npz`` of the serving format: one array a
    leaf, ``params/<path>`` and ``batch_stats/<path>``."""
    arrays = {f"params/{k}": v.detach().float().cpu().numpy()
              for k, v in params.items()}
    arrays.update({f"batch_stats/{k}": v.detach().float().cpu().numpy()
                   for k, v in stats.items()})
    np.savez(path, **arrays)
