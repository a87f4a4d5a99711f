"""Model registry: name → model factory and serving conventions.

Port of ``sr/models/registry.py`` with the fields that serving reads, plus
``default_lr`` for ``SRConfig.effective_lr``. The training recipe (loss,
optimizer, schedule, pre-shuffle modes) joins with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

_REGISTRY: dict[str, "ModelSpec"] = {}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    # (SRConfig, torch.Generator | None) -> nn.Module taking NHWC input
    make_model: Callable[..., Any]
    pre_upsample: bool = False  # feed bicubic-upscaled LR (SRCNN/VDSR/DRCN)
    default_channels: int = 1
    default_lr: float = 1e-3


def register(spec: ModelSpec) -> ModelSpec:
    key = spec.name.lower()
    if key in _REGISTRY:
        raise ValueError(f"duplicate model {spec.name}")
    _REGISTRY[key] = spec
    return spec


def get_spec(name: str) -> ModelSpec:
    key = name.lower()
    if key not in _REGISTRY:
        import sr_torch.models.edsr  # noqa: F401  (registers EDSR)

    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; the port serves "
                       f"{sorted(_REGISTRY)} (other models land in a later "
                       "port slice)")
    return _REGISTRY[key]
