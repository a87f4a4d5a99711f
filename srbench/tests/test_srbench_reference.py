"""The plain references against the program's models, on the CPU at a
small size, float32, on the benchmark's seeded weights."""

import json
from pathlib import Path

import pytest
import torch

from srbench import images, program, reference, weights
from srbench.reference.common import Convs

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _setup(name, seed=2 ** 31 + 99):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    ref = reference.load(cfg["reference"])
    g = weights.generator(seed, "test", "cpu")
    x = images.scenes(2, 28, 36, g, "cpu")
    params, stats = weights.make(ref, cfg, seed, "cpu", x[:1])
    return cfg, ref, x, params, stats


@pytest.mark.parametrize("name", ["edsr_baseline_x4.bf16",
                                  "srresnet_x4.bf16"])
def test_reference_equals_the_program_model(name):
    cfg, ref, x, params, stats = _setup(name)
    model = program.build_model(cfg, params, stats, "cpu", "float32")
    with torch.no_grad():
        want = model(x)
        got = ref.forward(params, stats, x, cfg)
    assert got.shape == want.shape == (2, 112, 144, 3)
    assert float((got - want).abs().max()) <= 1e-5


def test_collapsed_tail_equals_the_fused_route():
    # the reference derives the composite from its own weights; the
    # program's fused route probes its own: both serve the same function,
    # borders included
    cfg, ref, x, params, stats = _setup("edsr_baseline_x4.bf16")
    model = program.build_model(cfg, params, stats, "cpu", "float32")
    from sr_torch.infer import make_serving_predict

    fused = make_serving_predict(model, fused=True)
    with torch.no_grad():
        want = fused(x)
        tail = ref.collapsed_tail(params, cfg)
        got = ref.forward(params, stats, x, cfg, tail=tail)
        exact = ref.forward(params, stats, x, cfg)
    assert float((got - want).abs().max()) <= 1e-5
    # and it differs from the exact graph in the border band only
    band = 3 * 4
    assert float((got - exact)[:, band:-band, band:-band].abs().max()) <= 1e-5
    assert float((got - exact).abs().max()) > 1e-4


def test_weights_are_seeded_and_sane():
    cfg, ref, x, p1, s1 = _setup("srresnet_x4.bf16", seed=5)
    _, _, _, p2, s2 = _setup("srresnet_x4.bf16", seed=5)
    _, _, _, p3, _ = _setup("srresnet_x4.bf16", seed=6)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not torch.equal(p1["head/kernel"], p3["head/kernel"])
    with torch.no_grad():
        y = ref.forward(p1, s1, x, cfg)
    # outputs inside the u8 range for the most part, with some spread
    assert 0.3 < float(y.mean()) < 0.6 and 0.1 < float(y.std()) < 0.3
    assert float(((y < 0) | (y > 1)).float().mean()) < 0.05


def test_fake_quant_control_is_coarser():
    cfg, ref, x, params, stats = _setup("edsr_baseline_x4.int8")
    with torch.no_grad():
        exact = ref.forward(params, stats, x, cfg)
        errs = {}
        for bits in (8, 4):
            convs = Convs(bits, 1.25)
            convs.calibrating = True
            ref.forward(params, stats, x, cfg, convs)
            convs.calibrating = False
            y = ref.forward(params, stats, x, cfg, convs)
            errs[bits] = float((y - exact).square().mean().sqrt())
    assert 0 < errs[8] * 4 < errs[4]
