"""Model registry: name → model factory, serving conventions and training
recipe.

Port of ``sr/models/registry.py``. A ``ModelSpec`` holds everything
model-specific that the one shared trainer (``sr_torch/train/trainer.py``)
and the serving path read: the network factory, the loss, the optimizer
recipe, the per-step schedule context, the input convention and the
optional pre-shuffle training forwards.
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
    # (out, batch, ctx) -> (loss, metrics)
    loss: Callable[[Any, dict, dict], tuple]
    # SRConfig -> sr_torch.train.optim.Recipe
    make_tx: Callable[[Any], Any]
    # schedule context computed per step, fed to loss (e.g. DRCN's alpha)
    schedule: Callable[[Any, int], dict] = lambda cfg, step: {}
    pre_upsample: bool = False  # feed bicubic-upscaled LR (SRCNN/VDSR/DRCN)
    default_channels: int = 1
    default_lr: float = 1e-3
    # adversarial training (SRGAN): sr_torch.train.gan.GANTrainer; the
    # shared Trainer trains its generator on the content loss
    is_gan: bool = False
    # batch norms with running statistics (SRResNet, SRGAN): the
    # pre-shuffle losses refuse them
    has_batchnorm: bool = False
    # (SRConfig, torch.Generator | None) -> the discriminator (GAN recipes)
    make_discriminator: Callable[..., Any] | None = None
    # the model returns every power-of-2 level up to scale_factor with
    # forward(x, all_scales=True) (LapSRN's pyramid; sr_torch.infer serves
    # a level with net_scale)
    multi_scale_out: bool = False
    # optional pre-shuffle training (models whose tail ends in a pixel
    # shuffle): model → (apply_fn, r_last), where apply_fn(x) returns the
    # output before the last shuffle, (B, H·r/r_last, W·r/r_last,
    # C·r_last²); the trainer takes the loss against space_to_depth(hr)
    # (cfg.preshuffle_loss='last')
    preshuffle_train: Callable[[Any], tuple] | None = None
    # full-tail variant (cfg.preshuffle_loss='full'): model → (apply_fn,
    # target_fn), apply_fn(x) fully pre-shuffled at LR resolution and
    # target_fn(hr) the matching space_to_depth chain
    preshuffle_train_full: Callable[[Any], tuple] | None = None

    def input_key(self) -> str:
        return "bc" if self.pre_upsample else "lr"


def register(spec: ModelSpec) -> ModelSpec:
    key = spec.name.lower()
    if key in _REGISTRY:
        raise ValueError(f"duplicate model {spec.name}")
    _REGISTRY[key] = spec
    return spec


def get_spec(name: str) -> ModelSpec:
    # importing this module ran sr_torch/models/__init__.py, which
    # registers every port model
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; the port serves "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_models() -> list[str]:
    return sorted(_REGISTRY)
