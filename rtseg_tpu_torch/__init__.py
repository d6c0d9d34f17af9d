"""PyTorch/CUDA port of rtseg_tpu for NVIDIA Hopper.

The port mirrors the JAX package path for path (rtseg_tpu/X/y.py ->
rtseg_tpu_torch/X/y.py) and imports nothing of it. Ported so far:
training and evaluation of the JAX registry's 36 models and the smp hub
(with knowledge distillation) on synthetic, Cityscapes and Custom data
(config, data with segpipe and a PNG decoder, native host routines, ops,
nn, models, losses, utils, train; main_torch.py at the repository's
root), data parallel over torch.distributed (parallel/: one process a
card), with the two TPU kernels of that path written in CUDA C++
(ops/csrc/); serving, export, int8, telemetry, and warm starts (warm/:
the compiled libraries kept in a cache).
"""
