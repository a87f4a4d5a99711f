"""SRGAN — Ledig et al., CVPR 2017. (sr/models/srgan.py)

The adversarial recipe over the SRResNet generator and the VGG-style
discriminator (``sr_torch/models/srresnet.py``). Training has two phases:
generator-only MSE pre-training (``cfg.pretrain_epochs``), then per step a
D update (BCE on real and on the detached fake) and a G update (MSE content
+ w_vgg · VGG-feature MSE + w_adv · BCE(D(G(lr)), 1)), each with its own
Adam. ``sr_torch/train/gan.py`` runs both; this module wires the spec. The
content loss here, the pre-training loss and the content term, is plain
MSE, which the shared ``Trainer`` also trains on its own.
"""

from __future__ import annotations

from sr_torch.models.registry import ModelSpec, register
from sr_torch.models.srresnet import make_discriminator, make_net
from sr_torch.train.losses import mse_loss
from sr_torch.train.optim import adam


def _loss(out, batch, ctx):
    # the content term only; sr_torch.train.gan adds the perceptual and
    # adversarial terms
    return mse_loss(out, batch["hr"]), {}


SPEC = register(ModelSpec(
    name="SRGAN", make_model=make_net, loss=_loss,
    make_tx=lambda cfg: adam(cfg.effective_lr),
    pre_upsample=False, default_channels=3, default_lr=1e-4,
    is_gan=True, has_batchnorm=True, make_discriminator=make_discriminator))
