"""The port's model zoo: importing this package registers every model spec
(as ``sr/models/__init__.py`` does)."""

from sr_torch.models import (  # noqa: F401
    drcn, edsr, espcn, fsrcnn, lapsrn, srcnn, srgan, srresnet, vdsr)
from sr_torch.models.registry import ModelSpec, get_spec  # noqa: F401
