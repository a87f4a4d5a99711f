"""Evaluation: the harness (``runner``), metrics, tiling and the D4
self-ensemble."""

from sr_torch.eval.ensemble import (  # noqa: F401
    TRANSFORMS, inverse, make_self_ensemble_predict, transform)
