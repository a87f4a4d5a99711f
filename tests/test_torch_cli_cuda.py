"""On the card: the CLI (``sr_torch.main``) trains, evaluates and exports
EDSR ×4 through the kernels, its ``.pt2`` equals the eager predict, and
``Upsample2xBlock('ps')`` equals the CPU. These tests need an NVIDIA GPU
and skip without one; the file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cli_cuda.py -q
"""

import pytest
import torch

from sr_torch import main as port_main
from sr_torch.export import load_artifact
from sr_torch.kernels import ops
from sr_torch.models.registry import get_spec
from sr_torch.nn.blocks import Upsample2xBlock
from sr_torch.utils.checkpoint import load_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params
from sr_torch.utils.precision import no_tf32

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cli_runs_edsr_through_the_kernels_and_exports(cuda, tmp_path,
                                                       monkeypatch):
    parse = port_main.parse_args

    def small(argv):  # EDSR 2×16: the CLI has no width flags
        cfg, flags = parse(argv)
        return cfg.replace(num_resblocks=2, base_filter=16), flags

    monkeypatch.setattr(port_main, "parse_args", small)
    for c in (ops.depth_to_space, ops.fused_resblock):
        c.launches = 0
    assert port_main.main([
        "--model_name", "EDSR", "--num_epochs", "1", "--steps_per_epoch",
        "2", "--batch_size", "2", "--crop_size", "32", "--train_dataset",
        "synthetic", "--test_dataset", "synthetic", "--save_epochs", "1",
        "--save_dir", str(tmp_path), "--data_dir", str(tmp_path / "data"),
        "--device", "cuda", "--export"]) == 0
    # 2 steps × 2 shuffles; 1 sample render, 5 test images and the
    # export's warm-up call, each predict 2 shuffles and 2 resblocks
    assert ops.depth_to_space.launches == 2 * 2 + 2 * 7
    assert ops.fused_resblock.launches == 2 * 7

    run = tmp_path / "EDSR_x4"
    cfg = SRConfig(model_name="EDSR", num_channels=3, num_resblocks=2,
                   base_filter=16, dtype="bfloat16")
    model = get_spec("EDSR").make_model(cfg)
    from_jax_params(model, load_params(str(run / "EDSR_params.npz"))[0])
    model = model.to(cuda).eval()
    fn = load_artifact(str(run / "EDSR_x4.pt2"), device="cuda")
    for b in (1, 4):
        x = torch.rand((b, 8, 8, 3), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(b))
        with torch.no_grad():
            assert torch.equal(fn(x), model(x))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [None, "instance"])
def test_upsample2x_ps_on_the_card_equals_the_cpu(cuda, norm):
    blk = Upsample2xBlock(64, 64, "ps", norm=norm,
                          generator=torch.Generator().manual_seed(0))
    x = torch.rand((2, 64, 24, 20), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), no_tf32():
        want = blk(x)
        before = ops.depth_to_space.launches
        got = blk.to(cuda)(x.to(cuda).contiguous(
            memory_format=torch.channels_last))
        assert ops.depth_to_space.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
