"""sr_torch — the PyTorch/CUDA port of ``sr``, for one NVIDIA H100.

It mirrors ``sr/``'s layout and names, so each module's counterpart sits at
the same path. It imports torch, numpy and the standard library, never JAX
or ``sr``. Entry points run on ``device="cuda"`` unless the caller asks for
the CPU. Every Pallas kernel of ``sr`` on a ported path becomes a CUDA
kernel under ``sr_torch/kernels/csrc/``, built at first use; a CPU tensor
takes the kernel's plain PyTorch version instead.

Slices 1 and 2 serve EDSR ×4 in float and int8: ``sr_torch.infer.upscale``
(``quantize=...``) and ``python -m sr_torch.serve`` (``--quantize``).
Slice 5 trains it: ``sr_torch.data.pipeline.PatchPipeline`` on the card and
``sr_torch.train.trainer.Trainer`` (K steps per dispatch, full-state
checkpoints with exact resume). Slice 7 evaluates it:
``sr_torch.eval.runner.evaluate`` on ``sr_torch.data.datasets.get_test_set``
(Pillow-exact degradation, Y-channel PSNR/SSIM on the host or the card).
Slice 8 trains, serves and evaluates ESPCN ×4 on Y, and ports ``bench.py``
as ``python -m sr_torch.bench``. Slice 9 trains, serves (float and int8)
and evaluates the pre-upsample family on Y: SRCNN, VDSR and DRCN ×4.
Slice 10 does so for SRResNet ×4 and trains SRGAN ×4. Slice 11 adds FSRCNN
and LapSRN ×4 on Y (transposed convs, int8 deconvs, LapSRN's pyramid
levels through ``net_scale``) and the procedural and folder training
corpora. Slice 12 makes every kernel a ``torch.library`` operator,
exports serving routes as ``torch.export`` programs and bundles
(``python -m sr_torch.export``), serves them with micro-batching
(``python -m sr_torch.serve --artifact``) and adds the D4 self-ensemble.
"""
