"""Configuration: one dataclass, reference-compatible flag names.

The port's own copy of ``sr/utils/config.py:SRConfig`` (the port imports
nothing of ``sr``). The fields and defaults are the JAX package's, so one
config describes a run in either package; fields that only the JAX trainer
and sampler read are carried for that reason and are inert here until their
port slices land.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class SRConfig:
    # -- reference-compatible flags (main.py:parse_args) -----------------
    model_name: str = "SRCNN"
    num_channels: int = 1
    scale_factor: int = 4
    scale_factors: tuple = ()
    crop_size: int = 128
    num_epochs: int = 100
    save_epochs: int = 10
    batch_size: int = 32
    test_batch_size: int = 1
    lr: float | None = None  # None → model default
    data_dir: str = "./data"
    save_dir: str = "./results"
    train_dataset: str = "bsds300"
    test_dataset: str = "Set5"
    num_threads: int = 0
    random_scale_mode: str = "matrix"

    # -- model hyperparameters (per-model defaults applied by registry) --
    base_filter: int = 64
    num_resblocks: int = 16
    num_recursions: int = 16  # DRCN
    num_pyramid_convs: int = 5  # LapSRN feature convs per level
    res_scale: float = 1.0  # EDSR residual scaling
    lr_halve_steps: int = 200_000
    vdsr_clip_theta: float = 0.05

    # -- SRGAN ------------------------------------------------------------
    pretrain_epochs: int = 10
    vgg_loss_weight: float = 6e-3
    adv_loss_weight: float = 1e-3
    vgg_weights_path: str | None = None
    vgg_output_layer: str = "relu5_4"
    adv_d_train_mode: bool = False

    # -- runtime ------------------------------------------------------------
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    steps_per_epoch: int = 200
    seed: int = 42
    mesh_shape: tuple = ()
    mesh_axes: tuple = ("data",)
    log_every: int = 50
    steps_per_dispatch: int = 1
    keep_checkpoints: int = 3
    resume: bool = True
    use_pallas: bool = False  # JAX-only switch; the port picks by device
    preshuffle_loss: bool | str = False

    def replace(self, **kw) -> "SRConfig":
        return dataclasses.replace(self, **kw)

    @property
    def effective_lr(self) -> float:
        if self.lr is not None:
            return self.lr
        from sr_torch.models.registry import get_spec

        return get_spec(self.model_name).default_lr
