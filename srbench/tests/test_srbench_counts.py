"""Operations and bytes from shapes, against hand-worked numbers."""

import json
from pathlib import Path

import pytest

from srbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


# conv operations an LR pixel, worked by hand (2 · k² · C · N, times the
# pixels a stage runs at: 4 at ×2, 16 at ×4):
#   EDSR: head 2·9·3·64 = 3,456; 33 body convs 33·2·9·64·64 = 2,433,024;
#   stage 1 2·9·64·256 = 294,912; stage 2 4·294,912 = 1,179,648;
#   out 16·2·9·64·3 = 55,296.
#   SRResNet: head 2·81·3·64 = 31,104; body, stages as EDSR's;
#   out 16·2·81·64·3 = 497,664.
EDSR_PER_PIXEL = 3456 + 2433024 + 294912 + 1179648 + 55296
SRRESNET_PER_PIXEL = 31104 + 2433024 + 294912 + 1179648 + 497664


@pytest.mark.parametrize("name, per_pixel", [
    ("edsr_baseline_x4.bf16", EDSR_PER_PIXEL),
    ("edsr_baseline_x4.int8", EDSR_PER_PIXEL),
    ("srresnet_x4.bf16", SRRESNET_PER_PIXEL),
    ("srresnet_x4.int8", SRRESNET_PER_PIXEL)])
def test_model_ops_hand_worked(name, per_pixel):
    cfg = _cfg(name)
    assert counts.model_ops(cfg, 1, 1, 1) == per_pixel
    # a REDS batch: 8 frames of 180×320
    assert counts.model_ops(cfg, 8, 180, 320) == per_pixel * 8 * 180 * 320
    assert len(counts.model_convs(cfg)) == 1 + 32 + 1 + 2 + 1


def test_edsr_batch_is_1828_gflop():
    ops = counts.model_ops(_cfg("edsr_baseline_x4.bf16"), 8, 180, 320)
    assert ops == 1_827_687_628_800


def test_resblock_bound_is_operations_at_edsr_shape():
    # 2 convs · 2·B·H·W·9·64·64 = 67,947,724,800 operations at 989 TFLOP/s
    # = 68.703 µs; bytes 2·460,800·64·2 + 2·9·64·64·2 + 2·64·4 =
    # 118,112,768 at 3.35 TB/s = 35.258 µs: bound by operations
    b = counts.resblock_bound_s((8, 180, 320, 64))
    assert b == pytest.approx(67_947_724_800 / 989e12, rel=1e-12)


def test_int8_body_conv_bound_is_bytes():
    # 2·460,800·9·64·64 = 33,973,862,400 ops at 1979 TOP/s = 17.17 µs;
    # f32 in and out 2·460,800·64·4 = 235,929,600 B, weights 36,864 B,
    # scales and bias 3·64·4 = 768 B: 235,967,232 B at 3.35 TB/s = 70.44 µs
    b = counts.int8_conv_bound_s((8, 180, 320, 64), (3, 3, 64, 64))
    assert b == pytest.approx(235_967_232 / 3.35e12, rel=1e-12)


def test_int8_tail_conv_bound():
    # EDSR's collapsed 7×7 tail 64→48 at b8 180×320:
    # ops 2·460,800·49·64·48 = 138,726,604,800 → 70.10 µs at the int8
    # peak; bytes 460,800·(64+48)·4 + 49·64·48 + 3·48·4 = 206,589,504 →
    # 61.67 µs: bound by operations
    b = counts.int8_conv_bound_s((8, 180, 320, 64), (7, 7, 64, 48))
    assert b == pytest.approx(138_726_604_800 / 1979e12, rel=1e-12)


def test_d2s_bound():
    # (8,180,320,48) bf16 with a bias: 2·22,118,400·2 + 48·2 bytes
    b = counts.d2s_bound_s((8, 180, 320, 48), 2, True)
    assert b == pytest.approx((2 * 22_118_400 * 2 + 96) / 3.35e12)
    assert counts.d2s_bound_s((8, 180, 320, 48), 1, False) == pytest.approx(
        2 * 22_118_400 / 3.35e12)
