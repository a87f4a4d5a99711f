"""Benchmark of the port on the card: ``bench.py``'s measurement, ported.

    python -m sr_torch.bench

prints ONE JSON line with ``bench.py``'s keys:

    {"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N,
     "bf16_exact_mps": N, "bf16_fused_mps": N, "bf16_fused_vs_baseline": N,
     "bf16_best_mps": N,
     "train": {"EDSR": {"steps_per_s": N, "model_tflops": N},
               "ESPCN": {"steps_per_s": N, "model_tflops": N}}}

Serving: EDSR ×4 RGB (16 resblocks × 64 filters), bf16, seeded init,
128×128 LR → 512×512 outputs, OUTPUT megapixels per second on one card,
for three variants: the exact graph, the fused affine tail
(``sr_torch/kernels/fused_tail.py``), and the int8-static body with the
int8 collapsed tail (calibrated on one standard-normal image at headroom
1.0). Every call ends in the float32 sum of its output. The fastest variant
is the headline and its label names the mode; a fused tail slower than the
exact graph loses the headline, and ``bf16_fused_mps`` still reports its
own number.

Method, ``bench.py``'s constants and rules: the MARGINAL Δpixels/Δtime
between batch 64 and 192, the two batch sizes timed interleaved in each of
5 repeats, ``ITERS`` calls each after a warm call; a marginal counts only
where Δt > 2 ms (the noise guard), and the value is the larger of the
median marginal and the best observed large-batch rate. Here each batch
size's ``ITERS`` calls sit between two CUDA events with one synchronize:
``bench.py`` syncs through a scalar fetch because its TPU sits behind a
relay whose ``block_until_ready`` does not synchronize, a workaround the
card does not need.

Train axis (``bench.py:train_bench``): the production ``Trainer`` and the
'matrix' ``PatchPipeline`` on the card, ``SyntheticDataset(32, 160², 3
channels, seed 100)`` (ESPCN takes the first channel), crop 64, batch 32,
bf16; ``Trainer.make_multi_step`` at K 40/120 (EDSR) and 100/300 (ESPCN),
both warmed, then 5 interleaved repeats; steps/s is the median marginal
ΔK/Δt (CUDA events around each dispatch), and model-TFLOP/s is that times
``sr_torch.utils.flops.train_step_flops`` at the LR batch shape.

Differences from ``bench.py``, on purpose:

* No fallbacks. ``bench.py`` catches a failed fused path, int8 path or
  train axis and carries on; here each raises and the run exits non-zero.
* ``_wait_for_chip_idle`` is not ported: it scans ``/proc`` for the TPU
  queue's own scripts (``train_zoo.py``, ``tpu_queue_``), which the port
  does not have.
* ``REF_GPU_MPS = 15.0`` is ``bench.py``'s ESTIMATE of the paper-era
  PyTorch reference on a GPU (see its docstring and BASELINE.md). It is
  neither a TPU number nor a measurement of this card; ``vs_baseline``
  divides by it only to keep ``bench.py``'s key.

It runs on the card only: without one it refuses to start. The card's
``nvidia-smi`` name and power limit go to stderr before the JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

REF_GPU_MPS = 15.0  # bench.py's estimated GPU reference (see docstring)

LR_SIZE, SCALE = 128, 4
B_SMALL, B_LARGE = 64, 192
ITERS = 3
REPEATS = 5  # interleaved repeats; median marginal
NOISE_S = 2e-3  # a marginal counts only where Δt exceeds this
TRAIN_CROP, TRAIN_BATCH = 64, 32
TRAIN_K = (("EDSR", (40, 120)), ("ESPCN", (100, 300)))
INT8_LABEL = ("int8-static fused serving mode "
              "(quality delta measured in PERF.md)")


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def marginals(work_small: float, work_large: float, times) -> list[float]:
    """Δwork/Δt for each ``(t_small, t_large)`` pair (seconds) whose Δt
    passes the noise guard."""
    return [(work_large - work_small) / (t_l - t_s) for t_s, t_l in times
            if t_l - t_s > NOISE_S]


def serving_value(work_small: float, work_large: float, times) -> float:
    """``bench.py:_measure``'s value: the median resolved marginal (0 if
    none resolved), floored by the best observed large-batch rate."""
    m = marginals(work_small, work_large, times)
    observed = max(work_large / t_l for _, t_l in times)
    return max(statistics.median(m) if m else 0.0, observed)


def build_record(exact_mps: float, fused_mps: float, quant_mps: float,
                 train: dict) -> dict:
    """The JSON record with ``bench.py``'s keys and headline rules: the
    fused tail is the headline unless it is slower than the exact graph;
    the int8-static fused path takes it only when faster than the best
    float mode, which ``bf16_best_mps`` reports."""
    value, label = fused_mps, "fused-tail inference mode"
    if value < exact_mps:  # fusion should never be slower; be honest
        value, label = exact_mps, "exact graph"
    best_float = value
    if quant_mps > value:
        value, label = quant_mps, INT8_LABEL
    return {
        "metric": f"EDSR x4 SR inference throughput (output MP/s, 1 chip, "
                  f"{label})",
        "value": round(value, 2),
        "unit": "MP/s",
        "vs_baseline": round(value / REF_GPU_MPS, 2),
        "bf16_exact_mps": round(exact_mps, 2),
        "bf16_fused_mps": round(fused_mps, 2),
        "bf16_fused_vs_baseline": round(fused_mps / REF_GPU_MPS, 2),
        "bf16_best_mps": round(best_float, 2),
        "train": train,
    }


def _timed(fn, x, iters: int) -> float:
    """Seconds per call: a warm call, then ``iters`` calls between two CUDA
    events and one synchronize."""
    fn(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _measure(fn, label: str) -> float:
    """Marginal MP/s of ``fn`` between the two batch sizes (observed as
    floor), the sizes timed interleaved in every repeat."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = {b: torch.randn((b, LR_SIZE, LR_SIZE, 3), device="cuda",
                         generator=gen).to(torch.bfloat16)
          for b in (B_SMALL, B_LARGE)}
    px = (LR_SIZE * SCALE) ** 2
    times = []
    for _ in range(REPEATS):
        t_s = _timed(fn, xs[B_SMALL], ITERS)
        t_l = _timed(fn, xs[B_LARGE], ITERS)
        times.append((t_s, t_l))
        _log(f"{label}: b{B_SMALL} {t_s * 1e3:.1f} ms, b{B_LARGE} "
             f"{t_l * 1e3:.1f} ms")
    mp_s, mp_l = B_SMALL * px / 1e6, B_LARGE * px / 1e6
    value = serving_value(mp_s, mp_l, times)
    _log(f"{label}: {value:.0f} MP/s (median of "
         f"{len(marginals(mp_s, mp_l, times))} marginals)")
    return value


def serving_bench() -> tuple[float, float, float]:
    """(bf16 exact, bf16 fused, int8-static fused) MP/s of EDSR ×4."""
    from sr_torch.kernels.fused_tail import (
        make_fused_tail_predict, make_fused_tail_predict_quant)
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.config import SRConfig

    cfg = SRConfig(model_name="EDSR", num_channels=3, scale_factor=SCALE,
                   num_resblocks=16, base_filter=64, dtype="bfloat16")
    model = get_spec("EDSR").make_model(cfg, torch.Generator().manual_seed(0))
    model = model.to("cuda").eval()
    fused_fn = make_fused_tail_predict(model)
    qfn = make_fused_tail_predict_quant(model)
    with torch.inference_mode():
        # the first call calibrates, on one standard-normal f32 image
        qfn(torch.randn((1, LR_SIZE, LR_SIZE, 3), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0)))
        return tuple(
            _measure(lambda x, f=f: f(x).sum(dtype=torch.float32), label)
            for f, label in ((model, "exact"), (fused_fn, "fused"),
                             (qfn, "int8-static fused")))


def _timed_multi(step, state) -> float:
    """Seconds of one K-step dispatch: CUDA events around it, then the
    averaged loss read back."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    m = step(state)
    end.record()
    end.synchronize()
    float(m["loss"])
    return start.elapsed_time(end) / 1e3


def train_bench() -> dict:
    """``{model: {"steps_per_s", "model_tflops"}}`` for EDSR and ESPCN,
    each with its own trainer, pipeline and state."""
    from sr_torch.data.datasets import SyntheticDataset
    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.models.registry import get_spec
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.flops import train_step_flops

    ds = SyntheticDataset(num_images=32, size=(160, 160), channels=3,
                          seed=100)
    out = {}
    for name, (k_s, k_l) in TRAIN_K:
        spec = get_spec(name)
        channels = spec.default_channels
        cfg = SRConfig(model_name=name, scale_factor=SCALE,
                       crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                       num_channels=channels, dtype="bfloat16")
        images = [im if channels == 3 else im[..., :1]
                  for im in (ds[i] for i in range(len(ds)))]
        pipe = PatchPipeline(images, crop_size=TRAIN_CROP, scale_factor=SCALE,
                             batch_size=TRAIN_BATCH, channels=channels,
                             pre_upsample=spec.pre_upsample)
        tr = Trainer(cfg)
        state = tr.init_state(1)
        step_s = tr.make_multi_step(pipe, k_s)
        step_l = tr.make_multi_step(pipe, k_l)
        _timed_multi(step_s, state)  # warm both
        _timed_multi(step_l, state)
        times = []
        for _ in range(REPEATS):
            times.append((_timed_multi(step_s, state),
                          _timed_multi(step_l, state)))
            _log(f"train {name}: K{k_s} {times[-1][0] * 1e3:.1f} ms, "
                 f"K{k_l} {times[-1][1] * 1e3:.1f} ms")
        m = marginals(k_s, k_l, times)
        if not m:
            raise RuntimeError(f"train {name}: no K{k_s}->K{k_l} marginal "
                               f"passed the {NOISE_S * 1e3:g} ms noise guard")
        steps_per_s = statistics.median(m)
        in_size = TRAIN_CROP if spec.pre_upsample else TRAIN_CROP // SCALE
        flops = train_step_flops(state.model,
                                 (TRAIN_BATCH, in_size, in_size, channels))
        out[name] = {"steps_per_s": round(steps_per_s, 1),
                     "model_tflops": round(steps_per_s * flops / 1e12, 1)}
        _log(f"train {name}: {steps_per_s:.0f} steps/s, "
             f"{steps_per_s * flops / 1e12:.1f} model-TFLOP/s (fwd+bwd, crop "
             f"{TRAIN_CROP} b{TRAIN_BATCH})")
    return out


def run() -> dict:
    """The whole measurement on the card: the record of :func:`build_record`."""
    exact, fused, quant = serving_bench()
    return build_record(exact, fused, quant, train_bench())


def main() -> int:
    if not torch.cuda.is_available():
        print("sr_torch.bench: torch.cuda.is_available() is false; the "
              "benchmark runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    record = run()
    print(card, file=sys.stderr, flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
