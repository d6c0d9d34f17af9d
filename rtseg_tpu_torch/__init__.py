"""PyTorch/CUDA port of rtseg_tpu for NVIDIA Hopper.

The port mirrors the JAX package path for path (rtseg_tpu/X/y.py ->
rtseg_tpu_torch/X/y.py) and imports nothing of it. Ported so far: training
and evaluation of BiSeNetv2, FastSCNN, DDRNet and STDC on synthetic data
(config, ops, nn, models, losses, utils, data, train), with the two TPU
kernels of that path written in CUDA C++ (ops/csrc/).
"""
