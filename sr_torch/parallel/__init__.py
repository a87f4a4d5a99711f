from sr_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_slice,
    make_mesh,
    replicate,
)
